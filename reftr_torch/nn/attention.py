"""Multi-head attention, batch-first (port of reftr_tpu/nn/attention.py:33-163).

Separate q/k/v/out projections, logits and softmax in f32, and a key
validity mask (True = keep, the inverse of torch's key_padding_mask)
applied as an additive -1e9, not -inf: a row whose keys are all masked
gives a finite uniform average instead of NaN, as in the JAX package.

The attention itself is ``reftr_torch.kernels.attention.flash_attention``:
the CUDA kernels on a CUDA tensor (K1 forward; K2 and K3 in the backward
when grad is enabled), their plain versions on a CPU tensor. The JAX
package's rule for choosing between its kernel and XLA was tuned on a TPU
v5e and is not carried over; on the card every attention takes the kernel
until H100 measurements say otherwise. ``plain = True`` sends a module to
the plain version on any device, in training too and with the same
dropout mask, which is how a run is checked against the plain path on the
card (``set_plain_attention``). ``ModelConfig.use_pallas_attention``
(``--use_pallas_attention``) sets every module of a model
(``set_attention_route``): None (auto) the rule above, False the plain
version everywhere (JAX's XLA path), True the kernels, where a head dim
above the largest instance raises instead of going to the plain version.

Attention-weight dropout (training mode, ``dropout > 0``) runs inside the
kernels. Each call draws its 64-bit seed from the host ``torch.Generator``
bound by ``attention_rng`` (the counterpart of the ``rngs={"dropout": ...}``
that the JAX train step passes, reftr_tpu/train/steps.py:74): a draw on the
host, so the call never waits for the device. Under DDP every rank holds
the same generator state, and the draw folds in the rank bound with it
(``shard_seed``, the per-shard key of JAX's ``fused_attention_sharded``),
so the ranks drop different weights; rank 0 draws what one process draws.

Under tensor parallelism (``--mesh_model``,
``parallel/tensor_parallel.py``) a module holds a block of the heads: its
q/k/v projections are column-parallel and run ``num_heads / model`` heads
through the kernels, the counterpart of ``fused_attention_sharded``'s head
axis (reftr_tpu/kernels/attention.py:587-651), and its out projection is
row-parallel, summed over the model group before its bias. The fold of
each seed is then the mesh's ``shard``, data_index * model + model_index
(:628-634), so every (data, model) slot draws its own mask. A head count
the model axis does not divide raises, naming the layer; JAX's module
falls back to XLA there (reftr_tpu/nn/attention.py:93-99).

A layer recomputed in the backward (``torch.utils.checkpoint``, the
``remat`` options) must drop the weights its forward dropped, or K2 and K3
would run on a mask K1 never used. checkpoint restores the default CPU and
CUDA generators, not the bound one, so ``seed_replay`` gives it the
contexts that record each seed the forward draws and hand the same seeds,
in order, to the recompute.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator, List, Optional, Tuple

import torch
from torch import nn

from reftr_torch.kernels.attention import (MAX_HEAD_DIM, NEG_INF, SEED_BITS,
                                           attention_plain, flash_attention,
                                           shard_seed)
from reftr_torch.nn.quant import dense
from reftr_torch.parallel.tensor_parallel import (CopyToModelRegion,
                                                  RowParallelLinear,
                                                  split_layer)

__all__ = ["MultiHeadAttention", "NEG_INF", "attention_rng", "seed_replay",
           "seeded_dropout", "set_attention_route", "set_plain_attention"]

_RNG: Optional[torch.Generator] = None
_SHARD = 0
# ("record", seeds drawn) in a checkpointed forward, ("replay", an
# iterator over them) in its recompute
_TAPE: Optional[Tuple[str, Any]] = None


@contextmanager
def attention_rng(generator: torch.Generator,
                  shard: int = 0) -> Iterator[None]:
    """Bind the host generator that attention dropout draws its seeds from,
    and the shard (the mesh's ``shard``: the DDP rank at model 1) folded
    into each draw, for the calls made inside the block."""
    global _RNG, _SHARD
    if generator.device.type != "cpu":
        raise ValueError("attention seeds come from a CPU generator")
    outer = (_RNG, _SHARD)
    _RNG, _SHARD = generator, shard
    try:
        yield
    finally:
        _RNG, _SHARD = outer


@contextmanager
def _tape(mode: str, seeds: List[int]) -> Iterator[None]:
    global _TAPE
    outer = _TAPE
    _TAPE = (mode, iter(seeds) if mode == "replay" else seeds)
    try:
        yield
    finally:
        _TAPE = outer


def seed_replay():
    """``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant): the
    forward's context records every attention seed drawn inside it, the
    recompute's hands them back in the same order."""
    seeds: List[int] = []
    return _tape("record", seeds), _tape("replay", seeds)


def _draw_seed(local_batch: int) -> int:
    if _TAPE is not None and _TAPE[0] == "replay":
        seed = next(_TAPE[1], None)
        if seed is None:
            raise RuntimeError("a recomputed layer drew more attention "
                               "seeds than its forward")
        return seed
    if _RNG is None:
        raise RuntimeError("attention dropout in training mode needs a "
                           "generator: run the forward inside attention_rng")
    seed = int(torch.randint(0, 2 ** SEED_BITS - 1, (), generator=_RNG))
    seed = shard_seed(seed, _SHARD, local_batch)
    if _TAPE is not None:
        _TAPE[1].append(seed)
    return seed


def seeded_dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout of ``x`` at ``rate`` whose mask comes from a seed drawn as an
    attention's (``_draw_seed``: the bound generator, folded with the
    shard, recorded and replayed under remat): the dropout of a
    tensor-parallel layer's hidden block, which must differ between the
    model ranks while the replicated activations' dropouts agree."""
    if rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(_draw_seed(x.shape[0]))
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=gen)
    return x * keep * (1.0 / (1.0 - rate))


def _entered(enter: CopyToModelRegion, *xs: torch.Tensor) -> list:
    """Each input through ``enter`` once: a tensor given as both query and
    key takes one region operator, one all_reduce of its gradient."""
    seen: dict = {}
    for x in xs:
        if id(x) not in seen:
            seen[id(x)] = enter(x)
    return [seen[id(x)] for x in xs]


class MultiHeadAttention(nn.Module):
    """``quantize``: the q, k, v and out projections run as int8 products
    (``nn/quant.py::QuantDense``), as reftr_tpu/nn/attention.py:62-77.
    ``tensor_parallel`` splits the heads over the model axis (module
    docstring)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 quantize: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be divisible by num_heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = dense(d_model, d_model, quantize)
        self.k_proj = dense(d_model, d_model, quantize)
        self.v_proj = dense(d_model, d_model, quantize)
        self.out_proj = dense(d_model, d_model, quantize)
        self.plain = False
        # use_pallas_attention on: a head dim without a kernel raises
        self.kernel_only = False
        self.local_heads = num_heads
        self.enter: Optional[CopyToModelRegion] = None

    def tensor_parallel(self, mesh, name: str) -> None:
        """Hold ``num_heads / model`` heads of the mesh's model axis
        (``parallel/tensor_parallel.py::shard_model`` slices the
        weights)."""
        self.local_heads, self.enter = split_layer(
            f"{name or 'attention'} ({self.num_heads} heads)",
            self.num_heads, mesh, self.q_proj, self.k_proj, self.v_proj,
            self.out_proj)
        self.out_proj = RowParallelLinear(self.out_proj, mesh)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query [B, Sq, D]; key, value [B, Sk, D]; key_valid [B, Sk] bool."""
        b, sq, d = query.shape
        sk = key.shape[1]
        h, dh = self.local_heads, d // self.num_heads
        if self.enter is not None:
            query, key, value = _entered(self.enter, query, key, value)
        q = self.q_proj(query).view(b, sq, h, dh)
        k = self.k_proj(key).view(b, sk, h, dh)
        v = self.v_proj(value).view(b, sk, h, dh)
        if self.kernel_only and dh > MAX_HEAD_DIM:
            raise ValueError(
                f"use_pallas_attention on: head dim {dh} is above the "
                f"kernels' largest instance {MAX_HEAD_DIM}; use auto for "
                f"the plain version there")
        rate = self.dropout if self.training else 0.0
        seed = _draw_seed(b) if rate > 0.0 else None
        attend = attention_plain if self.plain else flash_attention
        out = attend(q, k, v, key_valid, dropout_rate=rate, seed=seed)
        return self.out_proj(out.reshape(b, sq, h * dh))


def set_plain_attention(model: nn.Module, plain: bool) -> None:
    """Route every MultiHeadAttention of ``model`` to the plain version
    (True) or back to the kernels (False)."""
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.plain = plain


def set_attention_route(model: nn.Module, use_kernels: Optional[bool]
                        ) -> None:
    """``use_pallas_attention`` on every MultiHeadAttention of ``model``:
    None (auto) the kernels by the rule, a head dim above MAX_HEAD_DIM on
    the plain version; True the kernels, and such a head dim raises; False
    the plain version everywhere."""
    for mod in model.modules():
        if isinstance(mod, MultiHeadAttention):
            mod.plain = use_kernels is False
            mod.kernel_only = use_kernels is True
