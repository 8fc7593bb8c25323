"""DETR-style transformer encoder and decoder, batch-first (port of
reftr_tpu/nn/transformer.py).

Positional embeddings are added to q and k at every layer, residual blocks
are post-norm (or pre-norm), and the decoder returns every layer's output
through the shared final LayerNorm. LayerNorm eps is Flax's default 1e-6,
not PyTorch's 1e-5. Masks are validity masks (True = real token).
Dropout sits where the JAX package has it (reftr_tpu/nn/transformer.py:65,
101-114, 202-222): after the FFN's activation, on each residual branch and,
inside the kernels, on the attention weights; it acts in training mode only.
With ``pos_in_value`` (the from-scratch option ``decoder_pos_in_value``,
reftr_tpu/nn/transformer.py:166-183) the decoder's cross-attention values
are memory + pos, its keys as before. With ``remat`` the encoder's layers
are recomputed in the backward (``torch.utils.checkpoint``, as JAX's
``nn.remat``, reftr_tpu/nn/transformer.py:141-142) with the dropout masks
of their forward: checkpoint restores the default generators for the
elementwise dropouts, ``seed_replay`` the attention seeds. With
``quantize`` every attention projection and FFN dense is an int8 product
(``nn/quant.py``, reftr_tpu/nn/transformer.py:39-66). Under tensor
parallelism (``parallel/tensor_parallel.py``) the FFN holds a block of
its hidden width: ``linear1`` column-parallel, ``linear2`` row-parallel,
and the hidden block's dropout draws a seed folded with the rank's shard
(``nn/attention.py::seeded_dropout``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from reftr_torch.nn.attention import (MultiHeadAttention, seed_replay,
                                      seeded_dropout)
from reftr_torch.nn.quant import dense
from reftr_torch.parallel.tensor_parallel import (CopyToModelRegion,
                                                  RowParallelLinear,
                                                  split_layer)

LN_EPS = 1e-6  # flax.linen.LayerNorm's default

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
}


def with_pos(x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pos is None else x + pos


class FFN(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int,
                 activation: str = "relu", dropout: float = 0.1,
                 quantize: bool = False):
        super().__init__()
        self.linear1 = dense(d_model, dim_feedforward, quantize)
        self.linear2 = dense(dim_feedforward, d_model, quantize)
        self.activation = _ACTIVATIONS[activation]
        self.dropout = nn.Dropout(dropout)
        self.enter: Optional[CopyToModelRegion] = None

    def tensor_parallel(self, mesh, name: str) -> None:
        """Hold a block of the hidden width over the mesh's model axis."""
        n = self.linear1.out_features
        _, self.enter = split_layer(
            f"{name or 'ffn'} ({n} hidden)", n, mesh, self.linear1,
            self.linear2)
        self.linear2 = RowParallelLinear(self.linear2, mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.enter is None:
            return self.linear2(self.dropout(self.activation(
                self.linear1(x))))
        hidden = self.activation(self.linear1(self.enter(x)))
        if self.training:
            hidden = seeded_dropout(hidden, self.dropout.p)
        return self.linear2(hidden)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "relu", normalize_before: bool = False,
                 dropout: float = 0.1, quantize: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout,
                                            quantize)
        self.ffn = FFN(d_model, dim_feedforward, activation, dropout,
                       quantize)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)
        self.normalize_before = normalize_before

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        drop = self.drop
        if self.normalize_before:
            s2 = self.norm1(src)
            qk = with_pos(s2, pos)
            src = src + drop(self.self_attn(qk, qk, s2, valid_mask))
            return src + drop(self.ffn(self.norm2(src)))
        qk = with_pos(src, pos)
        src = self.norm1(src + drop(self.self_attn(qk, qk, src, valid_mask)))
        return self.norm2(src + drop(self.ffn(src)))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "relu",
                 normalize_before: bool = False, dropout: float = 0.1,
                 remat: bool = False, quantize: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                    activation, normalize_before, dropout,
                                    quantize)
            for _ in range(num_layers))
        self.norm = (nn.LayerNorm(d_model, eps=LN_EPS) if normalize_before
                     else None)
        self.remat = remat

    def forward(self, src: torch.Tensor, pos: Optional[torch.Tensor] = None,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = src
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                out = checkpoint(layer, out, pos, valid_mask,
                                 use_reentrant=False, context_fn=seed_replay)
            else:
                out = layer(out, pos, valid_mask)
        return out if self.norm is None else self.norm(out)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 activation: str = "relu", normalize_before: bool = False,
                 dropout: float = 0.1, pos_in_value: bool = False,
                 quantize: bool = False):
        super().__init__()
        self.pos_in_value = pos_in_value
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout,
                                            quantize)
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout,
                                                 quantize)
        self.ffn = FFN(d_model, dim_feedforward, activation, dropout,
                       quantize)
        self.drop = nn.Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.normalize_before = normalize_before

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_valid_mask: Optional[torch.Tensor] = None,
                memory_valid_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        mem_k = with_pos(memory, pos)
        mem_v = mem_k if self.pos_in_value else memory
        drop = self.drop
        if self.normalize_before:
            t2 = self.norm1(tgt)
            qk = with_pos(t2, query_pos)
            tgt = tgt + drop(self.self_attn(qk, qk, t2, tgt_valid_mask))
            t2 = self.norm2(tgt)
            tgt = tgt + drop(self.multihead_attn(
                with_pos(t2, query_pos), mem_k, mem_v, memory_valid_mask))
            return tgt + drop(self.ffn(self.norm3(tgt)))
        qk = with_pos(tgt, query_pos)
        tgt = self.norm1(tgt + drop(self.self_attn(qk, qk, tgt,
                                                   tgt_valid_mask)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(
            with_pos(tgt, query_pos), mem_k, mem_v, memory_valid_mask)))
        return self.norm3(tgt + drop(self.ffn(tgt)))


class TransformerDecoder(nn.Module):
    """Returns [L, B, Sq, D] with return_intermediate (each layer's output
    through the shared final norm), else [1, B, Sq, D]."""

    def __init__(self, num_layers: int, d_model: int, nhead: int,
                 dim_feedforward: int = 2048, activation: str = "relu",
                 normalize_before: bool = False,
                 return_intermediate: bool = True, dropout: float = 0.1,
                 pos_in_value: bool = False, quantize: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                    activation, normalize_before, dropout,
                                    pos_in_value, quantize)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.return_intermediate = return_intermediate

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_valid_mask: Optional[torch.Tensor] = None,
                memory_valid_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = tgt
        intermediate = []
        for layer in self.layers:
            out = layer(out, memory, tgt_valid_mask, memory_valid_mask, pos,
                        query_pos)
            if self.return_intermediate:
                intermediate.append(self.norm(out))
        if self.return_intermediate:
            return torch.stack(intermediate, dim=0)
        return self.norm(out)[None]
