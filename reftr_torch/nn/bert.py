"""BERT and RoBERTa language backbone, batch-first (port of
reftr_tpu/nn/bert.py).

Embeddings (RoBERTa's position ids start past the pad id and skip
padding), the post-norm encoder stack with exact GELU, and the tanh
pooler; the model reads ``(sequence_output, pooled_output)``. Attention
masks are validity masks (True = real token) applied as an additive -1e9
through ``MultiHeadAttention``. Dropout as in the JAX package
(reftr_tpu/nn/bert.py:54, 75, 79, 96): after the embeddings' LayerNorm, on
the attention weights, and on both residual branches; training mode only.
Under tensor parallelism (``parallel/tensor_parallel.py``) a layer's
attention holds a block of the heads, ``intermediate`` is column-parallel
and ``output`` row-parallel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reftr_torch.core.config import BertConfig
from reftr_torch.nn.attention import MultiHeadAttention
from reftr_torch.nn.quant import dense
from reftr_torch.parallel.tensor_parallel import (CopyToModelRegion,
                                                  RowParallelLinear,
                                                  split_layer)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout)
        self.is_roberta = c.is_roberta
        self.pad_token_id = c.pad_token_id

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.is_roberta:
            real = (input_ids != self.pad_token_id).long()
            pos = self.position_embeddings(
                real.cumsum(1) * real + self.pad_token_id)
        else:
            pos = self.position_embeddings.weight[:input_ids.shape[1]]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids) + pos
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(x))


class BertLayer(nn.Module):
    """``quantize``: the attention's projections and the intermediate and
    output denses run as int8 products (reftr_tpu/nn/bert.py:61-86)."""

    def __init__(self, c: BertConfig, quantize: bool = False):
        super().__init__()
        self.attention = MultiHeadAttention(c.hidden_size,
                                            c.num_attention_heads,
                                            c.attention_dropout, quantize)
        self.attention_norm = nn.LayerNorm(c.hidden_size,
                                           eps=c.layer_norm_eps)
        self.intermediate = dense(c.hidden_size, c.intermediate_size,
                                  quantize)
        self.output = dense(c.intermediate_size, c.hidden_size, quantize)
        self.output_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dropout = nn.Dropout(c.hidden_dropout)
        self.enter: Optional[CopyToModelRegion] = None

    def tensor_parallel(self, mesh, name: str) -> None:
        """Hold a block of the intermediate width over the mesh's model
        axis (the attention takes its own)."""
        n = self.intermediate.out_features
        _, self.enter = split_layer(
            f"{name or 'layer'} ({n} intermediate)", n, mesh,
            self.intermediate, self.output)
        self.output = RowParallelLinear(self.output, mesh)

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attention_norm(
            x + self.dropout(self.attention(x, x, x, valid_mask)))
        h = x if self.enter is None else self.enter(x)
        y = self.output(F.gelu(self.intermediate(h)))  # exact GELU
        return self.output_norm(x + self.dropout(y))


class BertModel(nn.Module):
    """``quantize``: every layer's denses in int8; the embeddings and the
    pooler stay fp."""

    def __init__(self, c: BertConfig, quantize: bool = False):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self.layer = nn.ModuleList(BertLayer(c, quantize)
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
