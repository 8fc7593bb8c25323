"""Flash attention, forward and backward: the CUDA kernels for Hopper and
their plain versions.

Port of the Pallas kernels of reftr_tpu/kernels/attention.py and of their
autograd contract:

  K1 ``flash_attention``    <- ``_flash_kernel`` / ``_fwd``
                               (``csrc/flash_attn_fwd_dec.cu`` for short
                               query sides, on tensor cores
                               ``csrc/flash_attn_fwd_tc.cu`` (mma.sync) and
                               ``csrc/flash_attn_fwd_wg.cu`` (wgmma and
                               TMA) in bf16 and
                               ``csrc/flash_attn_fwd_f32tc.cu`` in float32
                               by 3xTF32; ``csrc/flash_attn_fwd.cu`` on
                               SIMT, which the rule no longer picks)
  K2 ``flash_attn_bwd_dq``  <- ``_bwd_dq_kernel``
                               (``csrc/flash_attn_bwd_dec.cu`` for short
                               query sides, on tensor cores
                               ``csrc/flash_attn_bwd_dq_tc.cu`` (mma.sync)
                               and ``csrc/flash_attn_bwd_dq_wg.cu`` (wgmma
                               and TMA) in bf16 and
                               ``csrc/flash_attn_bwd_dq_f32tc.cu`` in
                               float32 by 3xTF32; ``csrc/flash_attn_bwd.cu``
                               on SIMT, which the rule no longer picks)
  K3 ``flash_attn_bwd_dkv`` <- ``_bwd_dkv_kernel``
                               (``csrc/flash_attn_bwd_dec.cu`` for short
                               query sides, on tensor cores
                               ``csrc/flash_attn_bwd_dkv_tc.cu`` and
                               ``csrc/flash_attn_bwd_dkv_wg.cu`` in bf16,
                               ``csrc/flash_attn_bwd_dkv_f32tc.cu`` in
                               float32, ``csrc/flash_attn_bwd.cu`` on SIMT
                               for fewer than 16 keys)
  ``FlashAttentionFn``      <- ``_attention``'s ``custom_vjp`` and
                               ``fused_attention``

Each kernel has variants on the card, picked by shape, dtype and head dim
alone (``fwd_variant``, ``dq_variant``, ``dkv_variant``): fewer than 16
query rows, the decoder's single query, take the decode kernels ("dec") in
either dtype, where one launch of ``flash_attn_bwd_dec.cu`` gives K2's and
K3's gradients together; with 16 or more (and, for K3, 16 or more keys)
bf16 takes the tensor-core kernels, the warpgroup ones ("wg": wgmma,
TMA, a producer and two consumer warpgroups) at the shapes where they
measured faster on the H100 and the mma.sync ones ("tc") elsewhere, and
float32 the 3xTF32 tensor-core kernels ("tf32x3"), which split each
float32 operand into two tf32 halves and keep float32's accuracy; K3 with
fewer than 16 keys takes the SIMT kernel ("simt"). K3's "wg" kernel reads
di = rowsum(dO * O) from K2 ("tc" or "wg"), which writes it beside dq,
instead of O. A head dim above ``MAX_HEAD_DIM`` takes the
plain versions on the card ("plain"), a rule of the dispatch that no
error reaches. A kernel that fails to build or launch raises; no variant
stands in for another.

Head dims. The kernels are instantiated for ``HEAD_DIMS`` (16, 32, 64,
128). A call with another head dim up to 128 is zero-padded to the next
one in the wrapper and its outputs sliced back: zero columns leave q k^T,
p v and every gradient product unchanged, and each kernel takes the
softmax scale 1 / sqrt(D) of the caller's D, not of the instance's.

The kernels are built with nvcc on first use and called through ctypes (see
each source's header for its design and its bound on the card). Layout at
every function here is the one the attention projections produce:
q [B, Sq, H, D], k and v [B, Sk, H, D], and a validity mask [B, Sk]
(True = keep) that becomes an additive -1e9, like the TPU kernel's bias
row; lse is [B, H, Sq] f32.

Every kernel has its plain PyTorch version here (``attention_plain``,
``attention_bwd_plain``, ``philox_keep_plain``). A wrapper runs the plain
version for a tensor on the CPU, and for a CUDA tensor launches its kernel
or raises (or, for a head dim above 128, runs the plain version by the
rule). Each wrapper counts its kernel's launches in ``<wrapper>.launches``
(K1's in ``flash_attention.launches``, also when ``FlashAttentionFn``
launches it), those of the tensor-core, warpgroup, 3xTF32 and decode variants
among them in ``<wrapper>.launches_tc``, ``<wrapper>.launches_wg``,
``<wrapper>.launches_tf32x3`` and ``<wrapper>.launches_dec``, and the CUDA
calls that the rule sent to the plain version, which launch no kernel of this
module, in ``<wrapper>.launches_plain``. One launch of the decode backward, or
one plain backward, counts on K2 and on K3.

Attention dropout follows the TPU kernel: the softmax denominator sums the
un-dropped weights and only the weights applied to v are dropped and
scaled by 1 / (1 - rate). The mask is Philox4x32-10 keyed by a 64-bit seed
and counted by the element's offset ((b * H + h) * Sq + i) * Sk + j, so the
kernels and the plain version draw the same mask at any tiling. It does not
match the TPU's mask bit for bit, and need not.

A batch row whose keys are all masked is the uniform average of the eager
path (reftr_tpu/nn/attention.py:139-155), in the forward and in the
gradient. Its logits are about -1e9, where a float32 ulp is 64, so the
kernels and the plain versions add 1e9 back to them (exact): the softmax is
unchanged and lse, which the backward reads, keeps its digits. The lse of
such a row is therefore the logsumexp of the shifted logits.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e9
# the tensor-core kernels tile 64 rows as 4 warps of 16: a side shorter
# than one warp's 16 rows leaves most of each tile empty
TC_MIN_ROWS = 16
# the kernels' template instances; a head dim between them is zero-padded
# to the next, one above the last takes the plain versions ("plain")
HEAD_DIMS = (16, 32, 64, 128)
MAX_HEAD_DIM = HEAD_DIMS[-1]
# the warpgroup kernels' one instance (flash_attn_fwd_wg.cu,
# flash_attn_bwd_dq_wg.cu, flash_attn_bwd_dkv_wg.cu): the padded head dim
# they take, and the least (queries, keys) at which the rule sends bf16
# calls of K1 ("fwd"), K2 ("dq") and K3 ("dkv") there (the readings behind
# them in fwd_variant, dq_variant and dkv_variant)
WG_HEAD_DIM = 32
WG_MIN = {"fwd": (2040, 2040), "dq": (490, 490), "dkv": (256, 256)}
# from this many keys the rule sends K3 to "wg" only at a key count that
# is a multiple of 4: elsewhere K3's draw (flash_tc::chunk_keep) makes one
# Philox call per element, and "wg" was measured the slower there
# (dkv_variant); K1's and K2's draw (flash_tc::keep_bits) makes one per 4
# at any key count
WG_ALIGNED_FROM = 2040
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
# Philox4x32-10 multipliers and Weyl key increments (Salmon et al., SC'11)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
SEED_BITS = 63  # seeds are drawn in [0, 2^63): a non-negative int64
_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64's finalizer (Steele et al., OOPSLA'14): a bijection of
    64-bit words."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def shard_seed(seed: int, shard: int, local_batch: int) -> int:
    """The dropout seed of one shard's kernel calls: the counterpart of
    ``fused_attention_sharded`` (reftr_tpu/kernels/attention.py:587-651),
    which runs K1-K3 on each (data, model) shard under ``shard_map`` and
    folds the shard's index into the dropout key (:628-634), so that the
    shards draw independent masks. Under DDP a rank calls the kernels on
    its own batch, so the shard is the rank, and the fold is made where a
    seed is drawn (``nn/attention.py::_draw_seed``).

    Shard 0's fold is the identity: one process draws the seeds it drew
    before there were shards. Any other shard maps (seed, shard) through
    SplitMix64's finalizer into [0, 2^SEED_BITS). The local batch must not
    be empty, as ``mesh_compatible`` (:575-584) asks that the batch divide
    over the data axis."""
    if local_batch <= 0:
        raise ValueError(f"shard {shard} has an empty local batch "
                         f"({local_batch}): give every rank a batch")
    if shard == 0:
        return seed
    return _mix64(seed ^ _mix64(shard * 0x9E3779B97F4A7C15)) >> (
        64 - SEED_BITS)


def dropout_threshold(rate: float) -> int:
    """Keep an element iff the top 24 bits of its Philox word are at least
    this: u >= rate for u = word >> 8 over 2^24."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return math.ceil(rate * (1 << 24))


def _plain_precision(*tensors: torch.Tensor) -> torch.dtype:
    """float64 where the caller gives float64 (gradcheck), else float32."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def _no_autocast(device: torch.device):
    """The plain versions compute in the precision they state, also inside
    a caller's autocast region."""
    return torch.autocast(device.type, enabled=False)


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and int64
    ``b`` in [0, 2^32), in int64 arithmetic that never overflows."""
    t = b * (a & 0xFFFF)  # < 2^48
    u = b * (a >> 16)  # < 2^48; a * b = t + u * 2^16
    s = t + ((u & 0xFFFF) << 16)  # < 2^49
    return ((s >> 32) + (u >> 16)) & _MASK32, s & _MASK32


def philox4x32(counter: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 in plain integer ops: counter [..., 4] int64 holding
    32-bit words, key two 32-bit ints; returns the [..., 4] output words."""
    c0, c1, c2, c3 = (counter[..., i] for i in range(4))
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_keep_plain(seed: int, b: int, h: int, sq: int, sk: int,
                      rate: float, device=None,
                      first_row: int = 0) -> torch.Tensor:
    """The kernels' dropout mask in plain PyTorch: bool [B, H, Sq, Sk], True
    where element n = ((b * H + h) * Sq + i) * Sk + j is kept. Element n
    takes word n % 4 of Philox4x32-10 at counter (n / 4, 0, 0) under key
    ``seed`` (low word first), and is kept iff word >> 8 >=
    ``dropout_threshold(rate)``. With ``first_row``, the batch rows from
    it on alone ([B - first_row, H, Sq, Sk]): their offsets, past 2^32 in
    a large batch, without the rows before."""
    if not 0 <= seed < (1 << 64):
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")
    n0, n = first_row * h * sq * sk, b * h * sq * sk
    ctr = torch.arange(n0 // 4, (n + 3) // 4, dtype=torch.int64,
                       device=device)
    counter = torch.stack([ctr & _MASK32, ctr >> 32,
                           torch.zeros_like(ctr), torch.zeros_like(ctr)], -1)
    words = philox4x32(counter, (seed & _MASK32, seed >> 32)).reshape(-1)
    words = words[n0 % 4:n0 % 4 + n - n0]
    keep = (words >> 8) >= dropout_threshold(rate)
    return keep.reshape(b - first_row, h, sq, sk)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    """The softmax scale: 1 / sqrt(D) of q's head dim unless given (a head
    dim zero-padded from D keeps D's)."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _logits(q: torch.Tensor, k: torch.Tensor,
            valid_mask: Optional[torch.Tensor], acc: torch.dtype,
            scale: Optional[float] = None) -> torch.Tensor:
    """[B, H, Sq, Sk] logits as the kernels round them: s * scale, then
    + bias, then + 1e9 in a batch row whose keys are all masked."""
    scale = _scale(q, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if valid_mask is not None:
        bias = torch.where(valid_mask, 0.0, NEG_INF).to(acc)
        shift = torch.where(valid_mask.any(-1), 0.0, -NEG_INF).to(acc)
        logits = logits + bias[:, None, None, :]
        logits = logits + shift[:, None, None, None]
    return logits


def _keep_scale(rate: float, seed: Optional[int], b: int, h: int, sq: int,
                sk: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The dropout multiplier [B, H, Sq, Sk]: 1 / (1 - rate) where kept,
    0 where dropped."""
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, device)
    return keep.to(dtype) * (1.0 / (1.0 - rate))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False, *, dropout_rate: float = 0.0,
                    seed: Optional[int] = None,
                    scale: Optional[float] = None):
    """The forward kernel's function in plain PyTorch: f32 logits and
    softmax (f64 for f64 inputs) with an additive -1e9 on masked keys, the
    kernels' dropout mask after the softmax, output in the input dtype.
    Differentiable by autograd.

    q [B, Sq, H, D]; k, v [B, Sk, H, D]; valid_mask [B, Sk] bool or None;
    scale 1 / sqrt(D) unless given. Returns out [B, Sq, H, D] and, with
    return_lse, lse [B, H, Sq].
    """
    _check_dropout(dropout_rate, seed)
    acc = _plain_precision(q)
    with _no_autocast(q.device):
        logits = _logits(q, k, valid_mask, acc, scale)
        weights = torch.softmax(logits, dim=-1)
        if dropout_rate > 0.0:
            b, h, sq, sk = weights.shape
            weights = weights * _keep_scale(dropout_rate, seed, b, h, sq, sk,
                                            acc, q.device)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(acc)).to(q.dtype)
        if return_lse:
            return out, torch.logsumexp(logits, dim=-1)
    return out


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_mask: Optional[torch.Tensor], o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        dropout_rate: float = 0.0, seed: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, the flash-2
    formulas of ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` written out:

      p = exp(x - lse), dp = (dO v^T) * keep, di = rowsum(dO * O),
      ds = p * (dp - di), dq = scale * ds k, dk = scale * ds^T q,
      dv = (p * keep)^T dO

    with x the forward's logits and keep its dropout multiplier; scale is
    1 / sqrt(D) unless given. o and lse are the forward's outputs, do the
    gradient of o. Computes in f32 (f64 for f64 inputs); returns (dq, dk,
    dv) in the input dtype.
    """
    _check_dropout(dropout_rate, seed)
    acc = _plain_precision(q, do)
    scale = _scale(q, scale)
    with _no_autocast(q.device):
        p = torch.exp(_logits(q, k, valid_mask, acc, scale)
                      - lse.to(acc)[..., None])  # [B, H, Sq, Sk]
        dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
        pk = p
        if dropout_rate > 0.0:
            b, h, sq, sk = p.shape
            keep = _keep_scale(dropout_rate, seed, b, h, sq, sk, acc,
                               q.device)
            pk = p * keep
            dp = dp * keep
        di = (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)  # [B, H, Sq]
        ds = p * (dp - di[..., None])
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * scale
        dv = torch.einsum("bhqk,bqhd->bkhd", pk, do.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_dropout(rate: float, seed: Optional[int]) -> None:
    dropout_threshold(rate)
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")


def _check(q, k, v, valid_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    allowed = tuple(_DTYPES) + ((torch.float64,) if q.device.type == "cpu"
                                else ())
    if q.dtype not in allowed or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16 "
                        f"(float64 on the CPU), got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if valid_mask is not None and (valid_mask.dtype != torch.bool
                                   or valid_mask.shape != (b, k.shape[1])):
        raise ValueError(f"valid_mask must be bool [{b}, {k.shape[1]}], got "
                         f"{valid_mask.dtype} {tuple(valid_mask.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")


def _check_cuda(*tensors: Optional[torch.Tensor]) -> None:
    """What the kernels take: one CUDA device, contiguous, a head dim up to
    the largest instance (the launchers pad it to an instance)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, not "
                         f"{q.device} ones")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} is above the kernels' "
                         f"largest instance {MAX_HEAD_DIM}: the rule sends "
                         f"it to the plain versions")
    for t in tensors:
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError("every input must be on one device")
        if not t.is_contiguous():
            raise ValueError("the flash kernels need contiguous inputs")


def _check_bwd(q, o, lse, do) -> None:
    """The backward kernels read O and dO in q's dtype and lse in f32."""
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")


def _threads_per_row(sq: int) -> int:
    """Threads that share one query row in the forward and dq kernels: a
    short query side (the decoder's single query) spreads its keys over up
    to a warp."""
    for g, most in ((32, 4), (16, 8), (8, 16)):
        if sq <= most:
            return g
    return 4


def _wg(kernel: str, sq: int, sk: int, dtype: torch.dtype, d: int) -> bool:
    """Whether a bf16 call of K1 ("fwd"), K2 ("dq") or K3 ("dkv") takes
    its warpgroup kernel: a head dim that pads to WG_HEAD_DIM, at least
    WG_MIN[kernel] queries and keys, and for K3 from WG_ALIGNED_FROM keys
    up a key count that is a multiple of 4."""
    least_sq, least_sk = WG_MIN[kernel]
    aligned = kernel != "dkv" or sk < WG_ALIGNED_FROM or sk % 4 == 0
    return (dtype == torch.bfloat16 and d <= MAX_HEAD_DIM
            and padded_head_dim(d) == WG_HEAD_DIM and sq >= least_sq
            and sk >= least_sk and aligned)


def fwd_variant(sq: int, sk: int, dtype: torch.dtype, d: int) -> str:
    """K1's kernel on the card for sq queries, sk keys and head dim d:
    "plain" (``attention_plain`` on the card, counted in
    ``flash_attention.launches_plain``) for d above MAX_HEAD_DIM, where no
    kernel is instantiated; else "dec" (flash_attn_fwd_dec.cu) for fewer
    than TC_MIN_ROWS queries in either dtype, the decoder's single query,
    where a 64-row tile would be 63 rows of zeros and the call is bound by
    reading K and V once; with more, in bf16 "wg" (flash_attn_fwd_wg.cu)
    where ``_wg`` holds and "tc" (flash_attn_fwd_tc.cu) elsewhere, and in
    float32 "tf32x3" (flash_attn_fwd_f32tc.cu): its products on the tensor
    cores as three TF32 products of split operands, which keeps the
    float32 tolerance that plain TF32 would break. The SIMT kernel
    (flash_attn_fwd.cu) has no route left.

    "wg" takes WG_MIN["fwd"] = 2040 queries and keys and up, at any key
    count: the sites where it was no slower than "tc" both without
    dropout and with it (chip_smoke.py phase 3d on an NVIDIA H100 80GB
    HBM3 at 700 W: ms a call, CUDA events, median of three turns, "tc" /
    "wg" without dropout, then with 0.1):
      the VL encoder at four levels, 8540^2, B=8: 4.675 / 2.580, 9.441 /
        7.938; each image padded on the canvas: 4.668 / 3.777, 9.440 /
        9.026; at three, 8440^2: 4.540 / 2.504, 9.159 / 7.692; at two,
        2040^2: 0.2905 / 0.1762, 0.5764 / 0.4840;
      flickr's encoder at two levels, 2090^2, B=16: 0.6164 / 0.3822,
        1.287 / 1.180; at one, 490^2: 0.0461 / 0.0459, 0.0886 / 0.0975;
      the VL encoder at one level, 440^2, B=8: 0.0368 / 0.0369, 0.0385 /
        0.0386 (launch-bound); flickr's decoder, 16 x 490: 0.0431 /
        0.0466, 0.0293 / 0.0327.
    One block of 128 query rows fills an SM, so a short sequence gives
    "wg" few blocks, and with dropout the Philox work of its 128-key
    tiles does not hide under its products. K1's draw makes one Philox
    call per 4 decisions at any key count (flash_tc::keep_bits), so the
    rule no longer asks for Sk % 4 == 0 (before the draw, "wg" was
    1.36x slower with dropout at 2090^2)."""
    if d > MAX_HEAD_DIM:
        return "plain"
    if sq < TC_MIN_ROWS:
        return "dec"
    if dtype != torch.bfloat16:
        return "tf32x3"
    return "wg" if _wg("fwd", sq, sk, dtype, d) else "tc"


def dq_variant(sq: int, sk: int, dtype: torch.dtype, d: int) -> str:
    """K2's kernel on the card for sq queries, sk keys and head dim d:
    "plain" (``attention_bwd_plain`` on the card) for d above MAX_HEAD_DIM;
    else "dec" (flash_attn_bwd_dec.cu, which gives dk and dv in the same
    launch) for fewer than TC_MIN_ROWS queries in either dtype, the
    decoder's single query, bound by reading K and V once; with more (keys
    are the N side of the tensor-core kernels, so any Sk) in bf16 "wg"
    (flash_attn_bwd_dq_wg.cu) where ``_wg`` holds and "tc"
    (flash_attn_bwd_dq_tc.cu) elsewhere, and in float32 "tf32x3"
    (flash_attn_bwd_dq_f32tc.cu): its products on the tensor cores as
    three TF32 products of split operands, which keeps float32's accuracy.
    The SIMT kernel (flash_attn_bwd.cu) has no route left.

    "wg" takes WG_MIN["dq"] = 490 queries and keys and up, at any key
    count: the sites where it was no slower than "tc" with dropout 0.1,
    training's case (readings as in fwd_variant, "tc" / "wg", without
    dropout, then with 0.1):
      the VL encoder at four levels, 8540^2, B=8: 5.206 / 3.389, 10.227 /
        8.074; each image padded: 5.213 / 3.400, 10.242 / 8.075; at
        three, 8440^2: 5.070 / 3.253, 9.938 / 7.730; at two, 2040^2:
        0.3295 / 0.2183, 0.6266 / 0.4923;
      flickr's encoder at two levels, 2090^2, B=16: 0.6642 / 0.4931,
        1.323 / 1.198; at one, 490^2: 0.0537 / 0.0582, 0.0935 / 0.0842;
      the VL encoder at one level, 440^2, B=8: 0.0348 / 0.0371, 0.0517 /
        0.0565, so "tc" keeps it: the host loop is launch-bound there,
        and K2-wg's launch encodes four tensor maps on the host (device
        time, torch.profiler, phase 3: 0.0238 / 0.0168, 0.0406 / 0.0335),
        which REC's host-bound bf16 step would pay;
      flickr's decoder, 16 x 490: 0.0530 / 0.0563, 0.0369 / 0.0439, so
        16 queries (a tile of 128 an eighth full) keep "tc"."""
    if d > MAX_HEAD_DIM:
        return "plain"
    if sq < TC_MIN_ROWS:
        return "dec"
    if dtype != torch.bfloat16:
        return "tf32x3"
    return "wg" if _wg("dq", sq, sk, dtype, d) else "tc"


def dkv_variant(sq: int, sk: int, dtype: torch.dtype, d: int) -> str:
    """K3's kernel on the card for sq queries, sk keys and head dim d:
    "plain" and "dec" as for ``dq_variant``; with at least TC_MIN_ROWS
    queries and keys (the VL encoder and BERT) in bf16 "wg"
    (flash_attn_bwd_dkv_wg.cu, which takes di from K2) where ``_wg``
    holds (``fwd_variant``) and "tc" (flash_attn_bwd_dkv_tc.cu) elsewhere,
    and "tf32x3" (flash_attn_bwd_dkv_f32tc.cu) for float32; else "simt"
    (flash_attn_bwd.cu): fewer than TC_MIN_ROWS keys in either dtype, where
    each 64-key tile of a tensor-core kernel would be mostly empty.

    "wg" takes WG_MIN["dkv"] = 256 queries and keys and up, and from
    WG_ALIGNED_FROM keys only where Sk is a multiple of 4 (readings as in
    fwd_variant, "tc" / "wg", without dropout, then with 0.1, before K1's
    and K2's draw was changed):
      the VL encoder at four levels, 8540^2, B=8: 10.036 / 3.526, 14.804 /
        11.021; each image padded: 10.045 / 3.486, 14.804 / 10.924; at
        three, 8440^2: 9.742 / 3.384, 14.384 / 10.694; at two, 2040^2:
        0.6172 / 0.2318, 0.9050 / 0.6828; at one, 440^2: 0.0418 /
        0.0454, 0.0571 / 0.0445 (the host loop at 440^2 is launch-bound;
        torch.profiler's device time, phase 3: 0.0399 / 0.0193, 0.0571 /
        0.0440);
      flickr's encoder at two levels, 2090^2, B=16: 1.249 / 0.4947,
        3.186 / 3.223 (K3 draws Philox per element there); at one,
        490^2: 0.0865 / 0.0499, 0.2115 / 0.1906;
      flickr's decoder, 16 x 490: 0.0706 / 0.0729, 0.0492 / 0.0577.
    At 16 queries one 64-query tile is a quarter full. K3 runs in
    training, with dropout, so its reading with dropout decides; REC's
    bf16 step (chip_smoke.py phase 5) is no slower by the rule than with
    K3 on "tc" at 440^2 (208.03 against 215.89 ms a step, in turns)."""
    if d > MAX_HEAD_DIM:
        return "plain"
    if sq < TC_MIN_ROWS:
        return "dec"
    if sk < TC_MIN_ROWS:
        return "simt"
    if dtype != torch.bfloat16:
        return "tf32x3"
    return "wg" if _wg("dkv", sq, sk, dtype, d) else "tc"


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
_DROPOUT_ARGS = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float]
# each C entry point: its source under csrc/ and its arguments before the
# stream, which every entry point takes last: pointers, then B, H, Sq, Sk,
# D, the softmax scale, then the dtype and threads per row where the kernel
# takes them, then the dropout
_ARGTYPES = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",
                       [_PTR] * 6 + [_INT] * 5 + [_FLOAT] + [_INT] * 2
                       + _DROPOUT_ARGS),
    "flash_attn_fwd_tc": ("flash_attn_fwd_tc.cu",
                          [_PTR] * 6 + [_INT] * 5 + [_FLOAT] + _DROPOUT_ARGS),
    "flash_attn_fwd_wg": ("flash_attn_fwd_wg.cu",
                          [_PTR] * 6 + [_INT] * 5 + [_FLOAT] + _DROPOUT_ARGS),
    "flash_attn_fwd_f32tc": ("flash_attn_fwd_f32tc.cu",
                             [_PTR] * 6 + [_INT] * 5 + [_FLOAT]
                             + _DROPOUT_ARGS),
    "flash_attn_fwd_dec": ("flash_attn_fwd_dec.cu",
                           [_PTR] * 6 + [_INT] * 5 + [_FLOAT, _INT]
                           + _DROPOUT_ARGS),
    "flash_attn_bwd_dq": ("flash_attn_bwd.cu",
                          [_PTR] * 8 + [_INT] * 5 + [_FLOAT] + [_INT] * 2
                          + _DROPOUT_ARGS),
    "flash_attn_bwd_dq_tc": ("flash_attn_bwd_dq_tc.cu",
                             [_PTR] * 9 + [_INT] * 5 + [_FLOAT]
                             + _DROPOUT_ARGS),
    "flash_attn_bwd_dq_wg": ("flash_attn_bwd_dq_wg.cu",
                             [_PTR] * 9 + [_INT] * 5 + [_FLOAT]
                             + _DROPOUT_ARGS),
    "flash_attn_bwd_dq_f32tc": ("flash_attn_bwd_dq_f32tc.cu",
                                [_PTR] * 8 + [_INT] * 5 + [_FLOAT]
                                + _DROPOUT_ARGS),
    "flash_attn_bwd_dkv": ("flash_attn_bwd.cu",
                           [_PTR] * 9 + [_INT] * 5 + [_FLOAT, _INT]
                           + _DROPOUT_ARGS),
    "flash_attn_bwd_dkv_tc": ("flash_attn_bwd_dkv_tc.cu",
                              [_PTR] * 9 + [_INT] * 5 + [_FLOAT]
                              + _DROPOUT_ARGS),
    "flash_attn_bwd_dkv_wg": ("flash_attn_bwd_dkv_wg.cu",
                              [_PTR] * 9 + [_INT] * 5 + [_FLOAT]
                              + _DROPOUT_ARGS),
    "flash_attn_bwd_dkv_f32tc": ("flash_attn_bwd_dkv_f32tc.cu",
                                 [_PTR] * 9 + [_INT] * 5 + [_FLOAT]
                                 + _DROPOUT_ARGS),
    "flash_attn_bwd_dec": ("flash_attn_bwd_dec.cu",
                           [_PTR] * 10 + [_INT] * 5 + [_FLOAT, _INT]
                           + _DROPOUT_ARGS),
}


def _entry(name: str):
    """The C entry point ``name``, built from its source on first use."""
    from reftr_torch.kernels import _nvcc

    source, argtypes = _ARGTYPES[name]
    fn = getattr(_nvcc.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes + [_PTR]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dropout_args(rate: float, seed: Optional[int]):
    if rate == 0.0:
        return 0, 0, 1.0
    return seed, dropout_threshold(rate), 1.0 / (1.0 - rate)


def padded_head_dim(d: int) -> int:
    """The instance a head dim d <= MAX_HEAD_DIM runs at: the smallest of
    HEAD_DIMS at least d."""
    return next(x for x in HEAD_DIMS if x >= d)


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t zero-padded on its last dim to dp (t itself where it is dp)."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             valid_mask: Optional[torch.Tensor], dropout_rate: float,
             seed: Optional[int], return_lse: bool = True):
    """K1 without autograd, on checked inputs, through the registered op
    ``torch.ops.reftr.flash_attention_fwd``: (out [B, Sq, H, D], lse
    [B, H, Sq] f32 or None)."""
    out, lse = torch.ops.reftr.flash_attention_fwd(
        q, k, v, valid_mask, dropout_rate, seed, return_lse)
    return out, (lse if return_lse else None)


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= max(size, 1)
    return tuple(reversed(strides))


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t with the row-major strides of its shape (the op's fake gives
    those): t itself where it has them, else a copy. A permuted einsum
    result, or a size-1 dim with another stride, has others."""
    if t.stride() == _contiguous_strides(t.shape):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _plain_fwd(q, k, v, valid_mask, dropout_rate: float,
               seed: Optional[int], return_lse: bool):
    """``attention_plain`` as K1's launchers return it: (out, lse or
    None), row-major."""
    if return_lse:
        out, lse = attention_plain(q, k, v, valid_mask, True,
                                   dropout_rate=dropout_rate, seed=seed)
        return _dense(out), _dense(lse)
    return _dense(attention_plain(q, k, v, valid_mask,
                                  dropout_rate=dropout_rate, seed=seed)), None


def _check_aligned(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """16-byte aligned data, for the kernels' 16-byte vector loads and
    cp.async tile copies."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the {what} kernels need 16-byte aligned inputs")


def _check_tc(*tensors: Optional[torch.Tensor],
              dtype: torch.dtype = torch.bfloat16) -> None:
    """What the tensor-core kernels take beyond ``_check_cuda``: their
    dtype (bf16, or float32 for the 3xTF32 kernels), and 16-byte aligned
    rows for their cp.async tile copies."""
    if tensors[0].dtype != dtype:
        name = "bf16" if dtype == torch.bfloat16 else "3xTF32"
        raise TypeError(f"the {name} tensor-core kernels take "
                        f"{str(dtype).removeprefix('torch.')}, not "
                        f"{tensors[0].dtype}")
    _check_aligned("tensor-core", *tensors)


def _check_wg(*tensors: Optional[torch.Tensor]) -> None:
    """What the warpgroup kernels take beyond ``_check_tc``: a head dim
    that pads to their instance's (their TMA tiles are one swizzle row of
    D bf16)."""
    _check_tc(*tensors)
    if padded_head_dim(tensors[0].shape[-1]) != WG_HEAD_DIM:
        raise ValueError(f"the warpgroup kernels take head dims padded to "
                         f"{WG_HEAD_DIM}, not {tensors[0].shape[-1]}")


def _launch_fwd(variant: str, q, k, v, valid_mask, dropout_rate: float,
                seed: Optional[int], return_lse: bool = True):
    """Launch K1's ``variant`` ("dec", "tc", "wg", "tf32x3" or "simt"; "plain"
    runs ``attention_plain``) on CUDA tensors: (out, lse or None), both
    row-major. A head dim between the instances is zero-padded to the next
    one."""
    if variant == "plain":
        flash_attention.launches_plain += 1
        return _plain_fwd(q, k, v, valid_mask, dropout_rate, seed, return_lse)
    _check_cuda(q, k, v, valid_mask)
    b, sq, h, d = q.shape
    dp = padded_head_dim(d)
    q, k, v = (_pad(x, dp) for x in (q, k, v))
    # row-major, as the op's fake gives it (empty_like would copy a size-1
    # dim's stride from q)
    out = q.new_empty(q.shape)
    lse = (torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
           if return_lse else None)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(valid_mask), _ptr(out), _ptr(lse))
    shape = (b, h, sq, k.shape[1], dp, 1.0 / math.sqrt(d))
    drop = _dropout_args(dropout_rate, seed)
    if variant == "dec":
        _check_aligned("decode", q, k, v)
        _launch("flash_attn_fwd_dec", q.device, *ptrs, *shape,
                _DTYPES[q.dtype], *drop)
        flash_attention.launches_dec += 1
    elif variant == "tc":
        _check_tc(q, k, v)
        _launch("flash_attn_fwd_tc", q.device, *ptrs, *shape, *drop)
        flash_attention.launches_tc += 1
    elif variant == "wg":
        _check_wg(q, k, v)
        _launch("flash_attn_fwd_wg", q.device, *ptrs, *shape, *drop)
        flash_attention.launches_wg += 1
    elif variant == "tf32x3":
        _check_tc(q, k, v, dtype=torch.float32)
        _launch("flash_attn_fwd_f32tc", q.device, *ptrs, *shape, *drop)
        flash_attention.launches_tf32x3 += 1
    elif variant == "simt":
        _launch("flash_attn_fwd", q.device, *ptrs, *shape, _DTYPES[q.dtype],
                _threads_per_row(sq), *drop)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    flash_attention.launches += 1
    return _unpad(out, d), lse


def flash_attn_bwd_dq(q, k, v, valid_mask, o, lse, do,
                      dropout_rate: float = 0.0,
                      seed: Optional[int] = None) -> torch.Tensor:
    """K2: dq [B, Sq, H, D] in the input dtype. The plain version on a CPU
    tensor."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, valid_mask, o, lse, do,
                                   dropout_rate, seed)[0]
    return _launch_dq(dq_variant(q.shape[1], k.shape[1], q.dtype,
                                 q.shape[-1]),
                      q, k, v, valid_mask, o, lse, do, dropout_rate, seed)


def _bwd_inputs(q, k, v, valid_mask, o, lse, do):
    """The backward kernels' checked inputs, the head dim padded to its
    instance: (q, k, v, o, do, d, shape args up to the scale)."""
    _check_cuda(q, k, v, valid_mask, o, lse, do)
    _check_bwd(q, o, lse, do)
    b, sq, h, d = q.shape
    dp = padded_head_dim(d)
    q, k, v, o, do = (_pad(x, dp) for x in (q, k, v, o, do))
    return q, k, v, o, do, d, (b, h, sq, k.shape[1], dp, 1.0 / math.sqrt(d))


def _launch_dq(variant: str, q, k, v, valid_mask, o, lse, do,
               dropout_rate: float, seed: Optional[int],
               di_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2's ``variant`` ("dec", "tc", "wg", "tf32x3" or "simt";
    "plain" runs ``attention_bwd_plain``) on CUDA tensors: dq. With
    ``di_out`` ([B, H, Sq] f32, "tc" and "wg" only) K2 also writes di =
    rowsum(dO * O) there, for K3's "wg" kernel."""
    if variant in ("dec", "plain"):
        return _bwd_shared(variant, q, k, v, valid_mask, o, lse, do,
                           dropout_rate, seed)[0]
    q, k, v, o, do, d, shape = _bwd_inputs(q, k, v, valid_mask, o, lse, do)
    dq = torch.empty_like(q)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(valid_mask), _ptr(o), _ptr(do),
            _ptr(lse), _ptr(dq))
    drop = _dropout_args(dropout_rate, seed)
    if di_out is not None and (variant not in ("tc", "wg") or di_out.dtype
                               != torch.float32 or di_out.shape
                               != lse.shape or di_out.device != q.device
                               or not di_out.is_contiguous()):
        raise ValueError(f"di_out is K2-TC's and K2-wg's: float32 "
                         f"{tuple(lse.shape)}, contiguous, on {q.device}, "
                         f"not for variant {variant}")
    if variant == "tc":
        _check_tc(q, k, v, o, do)
        _launch("flash_attn_bwd_dq_tc", q.device, *ptrs, _ptr(di_out),
                *shape, *drop)
        flash_attn_bwd_dq.launches_tc += 1
    elif variant == "wg":
        _check_wg(q, k, v, o, do)
        _launch("flash_attn_bwd_dq_wg", q.device, *ptrs, _ptr(di_out),
                *shape, *drop)
        flash_attn_bwd_dq.launches_wg += 1
    elif variant == "tf32x3":
        _check_tc(q, k, v, o, do, dtype=torch.float32)
        _launch("flash_attn_bwd_dq_f32tc", q.device, *ptrs, *shape, *drop)
        flash_attn_bwd_dq.launches_tf32x3 += 1
    elif variant == "simt":
        _launch("flash_attn_bwd_dq", q.device, *ptrs, *shape,
                _DTYPES[q.dtype], _threads_per_row(shape[2]), *drop)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    flash_attn_bwd_dq.launches += 1
    return _unpad(dq, d)


def flash_attn_bwd_dkv(q, k, v, valid_mask, o, lse, do,
                       dropout_rate: float = 0.0, seed: Optional[int] = None,
                       di: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) [B, Sk, H, D] in the input dtype. The plain version on
    a CPU tensor. The "wg" kernel reads di = rowsum(dO * O) [B, H, Sq]
    float32: ``di`` where given (K2's ``di_out``), else ``di_plain``;
    the other variants ignore it."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, valid_mask, o, lse, do,
                                   dropout_rate, seed)[1:]
    return _launch_dkv(dkv_variant(q.shape[1], k.shape[1], q.dtype,
                                   q.shape[-1]),
                       q, k, v, valid_mask, o, lse, do, dropout_rate, seed,
                       di)


def di_plain(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) [B, H, Sq] in float32: K3-wg's input where K2
    has not written it."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_dkv(variant: str, q, k, v, valid_mask, o, lse, do,
                dropout_rate: float, seed: Optional[int],
                di: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3's ``variant`` ("dec", "tc", "wg", "tf32x3" or "simt";
    "plain" runs ``attention_bwd_plain``) on CUDA tensors: (dk, dv). "wg"
    reads ``di`` (``_launch_dkv_wg``)."""
    if variant in ("dec", "plain"):
        return _bwd_shared(variant, q, k, v, valid_mask, o, lse, do,
                           dropout_rate, seed)[1:]
    if variant == "wg":
        return _launch_dkv_wg(q, k, v, valid_mask, o, lse, do, dropout_rate,
                              seed, di)
    q, k, v, o, do, d, shape = _bwd_inputs(q, k, v, valid_mask, o, lse, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(valid_mask), _ptr(o), _ptr(do),
            _ptr(lse), _ptr(dk), _ptr(dv))
    drop = _dropout_args(dropout_rate, seed)
    if variant == "tc":
        _check_tc(q, k, v, o, do)
        _launch("flash_attn_bwd_dkv_tc", q.device, *ptrs, *shape, *drop)
        flash_attn_bwd_dkv.launches_tc += 1
    elif variant == "tf32x3":
        _check_tc(q, k, v, o, do, dtype=torch.float32)
        _launch("flash_attn_bwd_dkv_f32tc", q.device, *ptrs, *shape, *drop)
        flash_attn_bwd_dkv.launches_tf32x3 += 1
    elif variant == "simt":
        _launch("flash_attn_bwd_dkv", q.device, *ptrs, *shape,
                _DTYPES[q.dtype], *drop)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    flash_attn_bwd_dkv.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def _launch_dkv_wg(q, k, v, valid_mask, o, lse, do, dropout_rate: float,
                   seed: Optional[int], di: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3-wg (flash_attn_bwd_dkv_wg.cu) on CUDA tensors: (dk, dv).
    The kernel reads di = rowsum(dO * O) and never O: ``di`` where the
    caller has it (K2's ``di_out``), else ``di_plain(o, do)``."""
    q, k, v, o, do, d, shape = _bwd_inputs(q, k, v, valid_mask, o, lse, do)
    if di is None:
        di = di_plain(o, do)
    if (di.dtype != torch.float32 or di.shape != lse.shape
            or di.device != q.device or not di.is_contiguous()):
        raise ValueError(f"di must be float32 {tuple(lse.shape)}, contiguous, "
                         f"on {q.device}, got {di.dtype} {tuple(di.shape)}")
    _check_wg(q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attn_bwd_dkv_wg", q.device, _ptr(q), _ptr(k), _ptr(v),
            _ptr(valid_mask), _ptr(do), _ptr(lse), _ptr(di), _ptr(dk),
            _ptr(dv), *shape, *_dropout_args(dropout_rate, seed))
    flash_attn_bwd_dkv.launches_wg += 1
    flash_attn_bwd_dkv.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def _bwd_shared(variant: str, q, k, v, valid_mask, o, lse, do,
                dropout_rate: float, seed: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The variants that give K2's and K3's gradients in one call: "dec",
    the decode backward, and "plain", ``attention_bwd_plain`` on the card.
    The call counts once on K2 and once on K3."""
    if variant == "plain":
        grads = attention_bwd_plain(q, k, v, valid_mask, o, lse, do,
                                    dropout_rate, seed)
        for wrapper in (flash_attn_bwd_dq, flash_attn_bwd_dkv):
            wrapper.launches_plain += 1
        return grads
    if variant != "dec":
        raise ValueError(f"unknown variant {variant!r}")
    return _launch_bwd_dec(q, k, v, valid_mask, o, lse, do, dropout_rate,
                           seed)


def _launch_bwd_dec(q, k, v, valid_mask, o, lse, do, dropout_rate: float,
                    seed: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the decode backward (flash_attn_bwd_dec.cu: K2 and K3 in one
    kernel, fewer than TC_MIN_ROWS queries) on CUDA tensors: (dq, dk, dv).
    The launch counts once on K2 and once on K3."""
    q, k, v, o, do, d, shape = _bwd_inputs(q, k, v, valid_mask, o, lse, do)
    if q.dtype not in _DTYPES:
        raise TypeError(f"the decode kernels take float32 or bfloat16, not "
                        f"{q.dtype}")
    _check_aligned("decode", q, k, v, o, do)
    if q.shape[1] >= TC_MIN_ROWS:
        raise ValueError(f"the decode backward takes fewer than "
                         f"{TC_MIN_ROWS} queries, got {q.shape[1]}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attn_bwd_dec", q.device, _ptr(q), _ptr(k), _ptr(v),
            _ptr(valid_mask), _ptr(o), _ptr(do), _ptr(lse), _ptr(dq),
            _ptr(dk), _ptr(dv), *shape, _DTYPES[q.dtype],
            *_dropout_args(dropout_rate, seed))
    for wrapper in (flash_attn_bwd_dq, flash_attn_bwd_dkv):
        wrapper.launches += 1
        wrapper.launches_dec += 1
    return _unpad(dq, d), _unpad(dk, d), _unpad(dv, d)


# kernel launches per wrapper, and among them those of each variant but the
# SIMT kernels; launches_plain counts the CUDA calls that the rule sent to
# the plain versions, which launch no kernel of this module
for _wrapper in (flash_attn_bwd_dq, flash_attn_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.launches_tc = 0
    _wrapper.launches_wg = 0
    _wrapper.launches_tf32x3 = 0
    _wrapper.launches_dec = 0
    _wrapper.launches_plain = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the flash kernels' backward (the ``custom_vjp`` of
    reftr_tpu's ``_attention``): the forward saves q, k, v, the mask, O,
    lse and the dropout seed; the backward runs K2 and K3 (one launch of the
    decode backward for fewer than TC_MIN_ROWS queries, one call of
    ``attention_bwd_plain`` for a head dim above MAX_HEAD_DIM; their plain
    versions on the CPU; where K3 takes "wg", K2 ("tc" or "wg") writes di
    for it) and gives no gradient for the mask, the rate or the seed."""

    @staticmethod
    def forward(ctx, q, k, v, valid_mask, dropout_rate, seed):
        out, lse = _forward(q, k, v, valid_mask, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, valid_mask, out, lse)
        ctx.dropout = (dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid_mask, out, lse = ctx.saved_tensors
        do = do.to(out.dtype).contiguous()
        variant = dq_variant(q.shape[1], k.shape[1], q.dtype, q.shape[-1])
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(q, k, v, valid_mask, out, lse,
                                             do, *ctx.dropout)
        elif variant in ("dec", "plain"):
            dq, dk, dv = _bwd_shared(variant, q, k, v, valid_mask, out, lse,
                                     do, *ctx.dropout)
        elif dkv_variant(q.shape[1], k.shape[1], q.dtype,
                         q.shape[-1]) == "wg":
            # K2 hands K3-wg each query's di = rowsum(dO * O)
            di = torch.empty_like(lse)
            dq = _launch_dq(variant, q, k, v, valid_mask, out, lse, do,
                            *ctx.dropout, di_out=di)
            dk, dv = _launch_dkv("wg", q, k, v, valid_mask, out, lse, do,
                                 *ctx.dropout, di)
        else:
            dq = flash_attn_bwd_dq(q, k, v, valid_mask, out, lse, do,
                                   *ctx.dropout)
            dk, dv = flash_attn_bwd_dkv(q, k, v, valid_mask, out, lse, do,
                                        *ctx.dropout)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False, *, dropout_rate: float = 0.0,
                    seed: Optional[int] = None
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """softmax(q k^T / sqrt(D) - 1e9 * ~valid) v per batch and head, with
    attention dropout at ``dropout_rate`` keyed by ``seed``.

    q [B, Sq, H, D]; k, v [B, Sk, H, D] in float32 or bfloat16, any head
    dim; valid_mask [B, Sk] bool (True = keep) or None. Returns out
    [B, Sq, H, D] in the input dtype and, with return_lse, the row
    logsumexp [B, H, Sq] f32. Where grad is enabled and q, k or v needs
    it, the call goes through ``FlashAttentionFn`` (K1, then K2 and K3 in
    the backward); return_lse is for calls without grad.
    """
    _check(q, k, v, valid_mask)
    _check_dropout(dropout_rate, seed)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if return_lse:
            raise ValueError("return_lse is for calls without grad")
        return FlashAttentionFn.apply(q, k, v, valid_mask, dropout_rate,
                                      seed)
    out, lse = _forward(q, k, v, valid_mask, dropout_rate, seed,
                        return_lse=return_lse)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_wg = 0
flash_attention.launches_tf32x3 = 0
flash_attention.launches_dec = 0
flash_attention.launches_plain = 0


# K1 as an operator of the dispatcher, so that a traced program
# (torch.export) holds it as one node and runs the kernel when it is
# called; flash_attention and FlashAttentionFn reach K1 through it alone.
# Defined with torch.library.Library and not custom_op: the dispatcher
# calls the Python implementation directly, where custom_op's wrapper adds
# Python work to each of a forward's 30 calls (PERF.md §6, phase 12d).
# lse is an empty float32 tensor without return_lse (the schema has no
# optional output), and the launchers then write none. K2 and K3 are not
# ops: no traced program runs the backward.
_LIB = torch.library.Library("reftr", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, "
            "Tensor? valid_mask, float dropout_rate, int? seed, "
            "bool return_lse) -> (Tensor, Tensor)")


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


def _fwd_op_cpu(q, k, v, valid_mask, dropout_rate, seed, return_lse):
    """The op on CPU tensors: the plain version."""
    out, lse = _plain_fwd(q, k, v, valid_mask, dropout_rate, seed,
                          return_lse)
    return out, _no_lse(q) if lse is None else lse


def _fwd_op_cuda(q, k, v, valid_mask, dropout_rate, seed, return_lse):
    """The op on CUDA tensors: K1's variant by the rule (fwd_variant)."""
    out, lse = _launch_fwd(fwd_variant(q.shape[1], k.shape[1], q.dtype,
                                       q.shape[-1]),
                           q, k, v, valid_mask, dropout_rate, seed,
                           return_lse)
    return out, _no_lse(q) if lse is None else lse


def _fwd_op_fake(q, k, v, valid_mask, dropout_rate, seed, return_lse):
    """The op's outputs as both implementations give them: out [B, Sq, H,
    D] in q's dtype, lse [B, H, Sq] float32 (or [0]), row-major."""
    b, sq, h, _ = q.shape
    lse_shape = (b, h, sq) if return_lse else (0,)
    return q.new_empty(q.shape), q.new_empty(lse_shape, dtype=torch.float32)


_LIB.impl("flash_attention_fwd", _fwd_op_cpu, "CPU")
_LIB.impl("flash_attention_fwd", _fwd_op_cuda, "CUDA")
torch.library.register_fake("reftr::flash_attention_fwd", _fwd_op_fake,
                            lib=_LIB)
