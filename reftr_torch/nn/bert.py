"""BERT language backbone, batch-first (port of reftr_tpu/nn/bert.py).

Embeddings, the post-norm encoder stack with exact GELU, and the tanh
pooler; the model reads ``(sequence_output, pooled_output)``. Attention
masks are validity masks (True = real token) applied as an additive -1e9
through ``MultiHeadAttention``. Eval only: dropout and the RoBERTa
position offset come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reftr_torch.core.config import BertConfig
from reftr_torch.nn.attention import MultiHeadAttention


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings.weight[:s]
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = MultiHeadAttention(c.hidden_size,
                                            c.num_attention_heads)
        self.attention_norm = nn.LayerNorm(c.hidden_size,
                                           eps=c.layer_norm_eps)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.output_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attention_norm(x + self.attention(x, x, x, valid_mask))
        y = self.output(F.gelu(self.intermediate(x)))  # exact GELU
        return self.output_norm(x + y)


class BertModel(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self.layer = nn.ModuleList(BertLayer(c)
                                   for _ in range(c.num_hidden_layers))
        self.pooler = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sequence_output [B, S, H], pooled_output [B, H])."""
        valid = None if attention_mask is None else attention_mask.bool()
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layer:
            x = layer(x, valid)
        return x, torch.tanh(self.pooler(x[:, 0]))
