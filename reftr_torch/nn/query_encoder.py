"""Query encoder: decoder queries from the encoder's language memory (port
of reftr_tpu/nn/query_encoder.py).

An attended reduce over the encoded sentence (keys from the [CLS] slot,
masked positions set to -1e9, f32 softmax pooling, Linear + LayerNorm,
residual from [CLS]), fused with the per-phrase pooled BERT feature through
an MLPMapping, then tiled over n_q learned query embeddings of width 2*d
and split into (query, query_pos).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from reftr_torch.nn.attention import NEG_INF
from reftr_torch.nn.mlp import LN_EPS, MLPMapping


class QueryEncoder(nn.Module):
    def __init__(self, num_queries_per_phrase: int, hidden_dim: int):
        super().__init__()
        d = hidden_dim
        self.linear1 = nn.Linear(d, d)
        self.linear2 = nn.Linear(d, d)
        self.linear3 = nn.Linear(d, d)
        self.context_fc = nn.Linear(d, d)
        self.context_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.fuse_encoder_query = MLPMapping(2 * d, d)
        self.query_embed = nn.Parameter(torch.empty(num_queries_per_phrase,
                                                    2 * d))

    def forward(self, lang_context_feat: torch.Tensor,
                lang_query_feat: torch.Tensor,
                context_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """lang_context_feat [B, S, D] encoder language memory;
        lang_query_feat [B, n_ph, D] pooled phrase features;
        context_valid [B, n_ph, S] bool (True = attendable).
        Returns (query, query_pos), each [B, n_ph * n_q, D]."""
        b, n_ph, d = lang_query_feat.shape
        n_q = self.query_embed.shape[0]
        k = self.linear1(lang_context_feat[:, 0:1])  # [B, 1, D]
        q = self.linear2(lang_context_feat)  # [B, S, D]
        v = self.linear3(lang_context_feat)
        att = torch.einsum("bod,bsd->bos", k.float(), q.float())
        att = att.expand(b, n_ph, att.shape[-1])
        att = torch.where(context_valid, att, NEG_INF).softmax(dim=-1)
        ctx = torch.einsum("bps,bsd->bpd", att.to(v.dtype).float(),
                           v.float()).to(v.dtype)
        ctx = self.context_ln(self.context_fc(ctx))
        ctx = lang_context_feat[:, None, 0, :] + ctx  # residual from [CLS]
        fused = self.fuse_encoder_query(torch.cat([ctx, lang_query_feat],
                                                  dim=-1))
        queries = (fused[:, :, None, :].repeat(1, 1, n_q, 2)
                   + self.query_embed.to(fused.dtype))  # [B, n_ph, n_q, 2D]
        queries = queries.reshape(b, n_ph * n_q, 2 * d)
        return queries[..., :d], queries[..., d:]
