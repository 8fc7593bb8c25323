"""Multi-head attention, batch-first (port of reftr_tpu/nn/attention.py:33-163).

Separate q/k/v/out projections, logits and softmax in f32, and a key
validity mask (True = keep, the inverse of torch's key_padding_mask)
applied as an additive -1e9, not -inf: a row whose keys are all masked
gives a finite uniform average instead of NaN, as in the JAX package.

The attention itself is ``reftr_torch.kernels.attention.flash_attention``:
the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor. The
JAX package's rule for choosing between its kernel and XLA was tuned on a
TPU v5e and is not carried over; on the card every attention takes the
kernel until H100 measurements say otherwise. ``plain = True`` sends a
module to the plain version on any device, which is how a run is checked
against the plain path on the card (``set_plain_attention``).

Eval only: attention-weight dropout comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from reftr_torch.kernels.attention import (NEG_INF, attention_plain,
                                           flash_attention)

__all__ = ["MultiHeadAttention", "NEG_INF", "set_plain_attention"]


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be divisible by num_heads")
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.plain = False

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query [B, Sq, D]; key, value [B, Sk, D]; key_valid [B, Sk] bool."""
        b, sq, d = query.shape
        sk = key.shape[1]
        h = self.num_heads
        q = self.q_proj(query).view(b, sq, h, d // h)
        k = self.k_proj(key).view(b, sk, h, d // h)
        v = self.v_proj(value).view(b, sk, h, d // h)
        attend = attention_plain if self.plain else flash_attention
        out = attend(q, k, v, key_valid)
        return self.out_proj(out.reshape(b, sq, d))


def set_plain_attention(model: nn.Module, plain: bool) -> None:
    """Route every MultiHeadAttention of ``model`` to the plain version
    (True) or back to the kernel (False)."""
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.plain = plain
