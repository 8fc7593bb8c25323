"""Flash-attention forward: the CUDA kernel for Hopper and its plain version.

Port of the Pallas forward kernel ``_flash_kernel`` / ``_fwd`` of
reftr_tpu/kernels/attention.py. The kernel is
``csrc/flash_attn_fwd.cu`` (see its header for the design and its bound on
the card); it is built with nvcc on first use and called through ctypes.

``flash_attention`` is the wrapper. It takes the layout the attention
projections produce, ``[B, S, H, D]``, and a validity mask ``[B, Sk]``
(True = keep) that becomes an additive -1e9, like the TPU kernel's bias row.
On a CPU tensor it runs ``attention_plain``; on a CUDA tensor it launches
the kernel or raises. ``flash_attention.launches`` counts kernel launches.

Not ported yet (training slice): the backward kernels ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel``, the in-kernel attention dropout and the autograd
contract of ``fused_attention``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e9
SOURCE = "flash_attn_fwd.cu"
HEAD_DIMS = (16, 32, 64)  # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """The kernel's function in plain PyTorch: f32 logits and softmax with
    an additive -1e9 on masked keys, output in the input dtype.

    q [B, Sq, H, D]; k, v [B, Sk, H, D]; valid_mask [B, Sk] bool or None.
    Returns out [B, Sq, H, D] and, with return_lse, lse [B, H, Sq] f32.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if valid_mask is not None:
        bias = torch.where(valid_mask[:, None, None, :], 0.0, NEG_INF)
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _check(q, k, v, valid_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if valid_mask is not None and (valid_mask.dtype != torch.bool
                                   or valid_mask.shape != (b, k.shape[1])):
        raise ValueError(f"valid_mask must be bool [{b}, {k.shape[1]}], got "
                         f"{valid_mask.dtype} {tuple(valid_mask.shape)}")


def _threads_per_row(sq: int) -> int:
    """Threads that share one query row in the kernel: a short query side
    (the decoder's single query) spreads its keys over up to a warp."""
    for g, most in ((32, 4), (16, 8), (8, 16)):
        if sq <= most:
            return g
    return 4


def _library() -> ctypes.CDLL:
    from reftr_torch.kernels import _nvcc

    lib = _nvcc.load(SOURCE)
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """softmax(q k^T / sqrt(D) - 1e9 * ~valid) v, per batch and head.

    q [B, Sq, H, D]; k, v [B, Sk, H, D] in float32 or bfloat16;
    valid_mask [B, Sk] bool (True = keep) or None. Returns out
    [B, Sq, H, D] in the input dtype and, with return_lse, the row
    logsumexp [B, H, Sq] f32.
    """
    _check(q, k, v, valid_mask)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid_mask, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {HEAD_DIMS}")
    tensors = (q, k, v) if valid_mask is None else (q, k, v, valid_mask)
    for t in tensors:
        if t.device != q.device:
            raise ValueError("q, k, v and valid_mask must be on one device")
        if not t.is_contiguous():
            raise ValueError("flash_attention needs contiguous inputs")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
           if return_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, h, sq, sk, d, _DTYPES[q.dtype], _threads_per_row(sq), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
