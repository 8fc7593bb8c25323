"""The int8 serving path's kernels: the quantize pass and the int8
implicit-GEMM convolution, with their plain PyTorch versions.

Neither replaces a Pallas kernel. The JAX package computes QuantConv and
QuantDense (reftr_tpu/nn/quant.py:74-84, 115-126) as XLA's
``conv_general_dilated`` and ``dot_general`` on int8 with int32 results,
and torch has no int8 convolution on the card (and on the CPU its int8
``conv2d`` returns int8 and wraps around), so the port writes both by hand
for Hopper:

  ``quantize_int8``  ``csrc/int8_quantize.cu``: clip(rint(x * (1 /
                     in_scale)), -127, 127) as int8, float32 or bf16 in
  ``int8_conv``      int8 NHWC activations times an int8 [Cout, K * K *
                     Cin] weight on the int8 tensor cores (int32 sums),
                     then float(sum) * (w_scale * in_scale) (+ bias), in
                     float32 or bf16; a QuantDense is a 1x1 convolution
                     over [M, 1, 1, K] (``int8_dense``). Two variants,
                     picked by shape (``int8_conv_variant``): "wg",
                     ``csrc/int8_conv_wg.cu`` (wgmma s8, a TMA ring,
                     persistent blocks, the output staged in shared memory
                     and stored by TMA), and "tc", ``csrc/int8_conv.cu``
                     (mma.sync m16n8k32), for an output whose rows are not
                     a multiple of 16 bytes or a convolution TMA's im2col
                     map cannot describe; every shape of the model takes
                     "wg"

Both are operators of the dispatcher, ``torch.ops.reftr.quantize_int8``
and ``torch.ops.reftr.int8_conv``, registered with a CPU implementation
(the plain version), a CUDA one (the kernel) and a fake one, as K1 is
(``kernels/attention.py``), so an exported int8 program holds them as
nodes and runs the kernels when it is called. The wrappers call the ops:
a CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises on what the kernel does not take; nothing falls back. Each CUDA
implementation counts its launches in ``quantize_int8.launches`` and
``int8_conv.launches``, and the latter also by variant in
``int8_conv.launches_wg`` and ``launches_tc``.

The plain versions are the arithmetic the kernels must match bit for bit.
``int8_conv_plain`` sums the int8 products in float64 (``conv2d`` or a
product on ``.double()``), which is exact (|sum| <= K * 127^2 < 2^53), casts
the sums to int32, and applies JAX's float32 epilogue
(``y.astype(f32) * (w_scale * in_scale)``, then the bias).
``quantize_plain`` is JAX's chain, ``inv = 1.0 / in_scale`` in float32:
the kernel computes the same inv from ``in_scale`` on the device (an IEEE
division), so the host never reads the scale.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from reftr_torch.kernels import _nvcc

QMAX = 127.0
# the convolution's K tile: Cin must be a multiple of it (one tile never
# spans two taps)
CONV_K_STEP = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# "wg": the output tile's columns it is built for, and the least count of
# 128-column tiles at which int8_conv_tile takes them: half the card's 132
# SMs (NVIDIA H100 SXM), each a persistent block
WG_TILES = (64, 128)
WG_MIN_TILES = 66

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# each C entry point: its source under csrc/ and its arguments before the
# stream, which it takes last
_ARGTYPES = {
    "int8_quantize": ("int8_quantize.cu",
                      [_PTR] * 3 + [ctypes.c_longlong, _INT, _INT]),
    "int8_conv": ("int8_conv.cu", [_PTR] * 6 + [_INT] * 11),
    # int8_conv's arguments and the output tile's columns
    "int8_conv_wg": ("int8_conv_wg.cu", [_PTR] * 6 + [_INT] * 12),
}
# _launch(name, device, *args): the entry point ``name`` on the device's
# current stream, built from its source on first use
_launch = functools.partial(_nvcc.launch, _ARGTYPES)


def conv_out_hw(h: int, w: int, k: int, stride: int, dilation: int):
    """The output side of a k x k convolution padded by dilation * (k - 1)
    // 2 on each side, as the backbone's (reftr_tpu/nn/resnet.py:85-110)."""
    pad = dilation * (k - 1) // 2
    return tuple((side + 2 * pad - dilation * (k - 1) - 1) // stride + 1
                 for side in (h, w))


def quantize_plain(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """int8 of ``x`` on the grid of ``in_scale``: JAX's
    clip(round(x_f32 * (1.0 / in_scale)), -127, 127), half to even."""
    inv = 1.0 / in_scale.float()
    return torch.clamp(torch.round(x.float() * inv), -QMAX, QMAX).to(
        torch.int8)


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                    in_scale: torch.Tensor, bias: Optional[torch.Tensor],
                    k: int, stride: int, dilation: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 k x k convolution: x int8 [N, H, W, C], w int8 [Cout,
    k*k*C] in (r, s, c) order -> [N, Ho, Wo, Cout] in ``out_dtype``,
    row-major. Integer sums exact in float64, then JAX's float32
    epilogue."""
    n, h, wd, c = x.shape
    cout = w.shape[0]
    if k == 1 and stride == 1:
        y = x.reshape(-1, c).double() @ w.double().t()
        y = y.reshape(n, h, wd, cout)
    else:
        w4 = w.reshape(cout, k, k, c).permute(0, 3, 1, 2).double()
        y = F.conv2d(x.permute(0, 3, 1, 2).double(), w4, stride=stride,
                     padding=dilation * (k - 1) // 2,
                     dilation=dilation).permute(0, 2, 3, 1)
    out = y.to(torch.int32).float() * (w_scale.float() * in_scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype).contiguous()


def im2col_takes(h: int, w: int, k: int, stride: int,
                 dilation: int) -> bool:
    """Whether TMA's im2col map over an NHWC input describes a k x k
    convolution (csrc/int8_conv_wg.cu): its bounding box's corners (the
    padding from the top left; (out - 1) * stride - padding - (side - 1)
    from the bottom right) within [-128, 127], the taps' offsets within
    255, a stride up to 8."""
    pad = dilation * (k - 1) // 2
    ho, wo = conv_out_hw(h, w, k, stride, dilation)
    corners = [(out - 1) * stride - pad - (side - 1)
               for out, side in ((ho, h), (wo, w))]
    return (pad <= 128 and all(-128 <= c <= 127 for c in corners)
            and dilation * (k - 1) <= 255 and stride <= 8)


def int8_conv_variant(n: int, h: int, w: int, c: int, cout: int, k: int = 1,
                      stride: int = 1, dilation: int = 1,
                      out_dtype: torch.dtype = torch.bfloat16) -> str:
    """The int8 conv kernel for a k x k convolution of an int8 [n, h, w, c]
    input to ``cout`` channels in ``out_dtype``, by shape alone: "wg"
    (csrc/int8_conv_wg.cu) wherever it takes the shape: an output row a
    multiple of 16 bytes (its TMA store) and, for a convolution other than
    a 1x1 at stride 1 (a dense), one ``im2col_takes``; else "tc"
    (csrc/int8_conv.cu). At the model's 31 product shapes "wg" was the
    faster at every one, in bf16 at B=8 and B=64 (time_int8_conv.py --tc
    all on an NVIDIA H100 80GB HBM3 at 700 W: 2.760 against 5.915 and
    11.344 against 27.570 ms over a forward's 220 products; PERF.md §6)."""
    esize = 2 if out_dtype == torch.bfloat16 else 4
    dense = k == 1 and stride == 1
    takes = cout * esize % 16 == 0 and (
        dense or im2col_takes(h, w, k, stride, dilation))
    return "wg" if takes else "tc"


def int8_conv_tile(n: int, h: int, w: int, c: int, cout: int, k: int = 1,
                   stride: int = 1, dilation: int = 1,
                   out_dtype: torch.dtype = torch.bfloat16) -> int:
    """The output tile's columns of "wg" for that shape: 128 where Cout is
    above 64 and there are at least WG_MIN_TILES tiles of 128 columns,
    else 64. Over a forward's 220 products (time_int8_conv.py on an
    NVIDIA H100 80GB HBM3 at 700 W, device ms in bf16 at B=8 / B=64) this
    gives 2.773 / 11.358 ms, against 2.756 / 11.233 for the fastest width
    at every shape, 2.985 / 13.425 for 64 everywhere and 3.224 / 11.762
    for 128 everywhere; tiles of 256 columns (bf16 only, 3 ring stages)
    were nowhere more than 5 % faster than 128 and up to 20 % slower, so
    the kernel is no longer built for them. In float32: 3.185 / 14.862
    against 3.143 / 14.661."""
    ho, wo = conv_out_hw(h, w, k, stride, dilation)
    tiles = -(-n * ho * wo // 128) * -(-cout // 128)
    return 128 if cout > 64 and tiles >= WG_MIN_TILES else 64


def _check_same_device(*tensors: Optional[torch.Tensor]) -> None:
    dev = tensors[0].device
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError("every input must be on one device")


def _check_quantize(x: torch.Tensor, in_scale: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_int8 takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if in_scale.numel() != 1 or in_scale.dtype != torch.float32:
        raise ValueError("in_scale must be one float32")
    _check_same_device(x, in_scale)


def _check_conv(x, w, w_scale, in_scale, bias, k: int, stride: int,
                dilation: int, out_dtype) -> None:
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"x must be int8 [N, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    if w.dim() != 2 or w.dtype != torch.int8 or w.shape[1] != k * k * c:
        raise ValueError(f"w must be int8 [Cout, {k}*{k}*{c}], got "
                         f"{w.dtype} {tuple(w.shape)}")
    cout = w.shape[0]
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (cout,)):
            raise ValueError(f"{name} must be float32 [{cout}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if in_scale.numel() != 1 or in_scale.dtype != torch.float32:
        raise ValueError("in_scale must be one float32")
    if min(k, stride, dilation) < 1:
        raise ValueError("kernel side, stride and dilation must be >= 1")
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_conv gives float32 or bfloat16, not "
                        f"{out_dtype}")
    ho, wo = conv_out_hw(x.shape[1], x.shape[2], k, stride, dilation)
    if min(ho, wo) < 1:
        raise ValueError(f"an input of {x.shape[1]} x {x.shape[2]} has no "
                         f"output under a {k} x {k} kernel")
    _check_same_device(x, w, w_scale, in_scale, bias)


def _check_cuda_conv(variant: str, x, w, w_scale, in_scale, bias,
                     out_dtype) -> None:
    """What the kernel ``variant`` takes beyond ``_check_conv``: contiguous
    tensors, Cin a multiple of the K step (a K tile never spans two taps),
    fewer than 2^31 input elements and output pixels, 16-byte aligned
    activations and weights (cp.async and TMA copies); "tc" an even Cout
    (its epilogue stores column pairs), "wg" an output row that is a
    multiple of 16 bytes (its TMA store) and 8-byte aligned scales and
    bias (read as column pairs)."""
    if not all(t is None or t.is_contiguous()
               for t in (x, w, w_scale, in_scale, bias)):
        raise ValueError("the int8 conv kernel needs contiguous inputs")
    if x.shape[3] % CONV_K_STEP:
        raise ValueError(f"the int8 conv kernel takes Cin a multiple of "
                         f"{CONV_K_STEP}, not {x.shape[3]}")
    cout = w.shape[0]
    if variant == "tc" and cout % 2:
        raise ValueError(f"the int8 conv kernel takes an even Cout, not "
                         f"{cout}")
    esize = 2 if out_dtype == torch.bfloat16 else 4
    if variant == "wg" and cout * esize % 16:
        raise ValueError(f"the int8 conv kernel \"wg\" takes output rows "
                         f"of a multiple of 16 bytes, not {cout} x {esize}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the int8 conv kernel needs 16-byte aligned "
                         "activations and weights")
    if variant == "wg" and any(t is not None and t.data_ptr() % 8
                               for t in (w_scale, bias)):
        raise ValueError("the int8 conv kernel \"wg\" needs 8-byte "
                         "aligned scales and bias")
    if x.numel() >= 2 ** 31 or x.shape[0] * x.shape[1] * x.shape[2] >= 2 ** 31:
        raise ValueError("the int8 conv kernel takes fewer than 2^31 "
                         "input elements")


# The ops. Defined with torch.library.Library as K1 is, as a fragment of
# the "reftr" namespace that kernels/attention.py defines.
_LIB = torch.library.Library("reftr", "FRAGMENT")
_LIB.define("quantize_int8(Tensor x, Tensor in_scale) -> Tensor")
_LIB.define("int8_conv(Tensor x, Tensor w, Tensor w_scale, Tensor in_scale, "
            "Tensor? bias, int k, int stride, int dilation, "
            "ScalarType out_dtype) -> Tensor")


def _quantize_cpu(x, in_scale):
    return quantize_plain(x, in_scale)


def _quantize_cuda(x, in_scale):
    """The quantize kernel on a CUDA tensor (made contiguous)."""
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    vec = int(n % 8 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 8 == 0)
    _launch("int8_quantize", x.device, x.data_ptr(), in_scale.data_ptr(),
            out.data_ptr(), n, _DTYPES[x.dtype], vec)
    quantize_int8.launches += 1
    return out


def _quantize_fake(x, in_scale):
    return x.new_empty(x.shape, dtype=torch.int8)


def _conv_cpu(x, w, w_scale, in_scale, bias, k, stride, dilation,
              out_dtype):
    return int8_conv_plain(x, w, w_scale, in_scale, bias, k, stride,
                           dilation, out_dtype)


def _launch_conv(variant: str, x, w, w_scale, in_scale, bias, k, stride,
                 dilation, out_dtype, bn: Optional[int] = None):
    """The int8 conv kernel ``variant`` ("wg" or "tc") on CUDA tensors,
    "wg" with ``bn`` columns a tile (by default ``int8_conv_tile``'s):
    counted in ``int8_conv.launches`` and ``launches_<variant>``. CPU
    tensors are refused: the op sends them to the plain version."""
    if x.device.type != "cuda":
        raise ValueError("the int8 conv kernels take CUDA tensors")
    _check_cuda_conv(variant, x, w, w_scale, in_scale, bias, out_dtype)
    n, h, wd, c = x.shape
    cout = w.shape[0]
    ho, wo = conv_out_hw(h, wd, k, stride, dilation)
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
            in_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), n, h, wd, c, cout, k, stride, dilation, ho, wo,
            _DTYPES[out_dtype])
    if variant == "wg":
        if bn is None:
            bn = int8_conv_tile(n, h, wd, c, cout, k, stride, dilation,
                                out_dtype)
        if bn not in WG_TILES:
            raise ValueError(f"int8 conv \"wg\" tiles of {bn} columns: "
                             f"one of {WG_TILES}")
        _launch("int8_conv_wg", x.device, *args, bn)
        int8_conv.launches_wg += 1
    elif variant == "tc":
        _launch("int8_conv", x.device, *args)
        int8_conv.launches_tc += 1
    else:
        raise ValueError(f"no int8 conv kernel {variant!r}")
    int8_conv.launches += 1
    return out


def _conv_cuda(x, w, w_scale, in_scale, bias, k, stride, dilation,
               out_dtype):
    """The int8 conv kernel that ``int8_conv_variant`` picks for the shape,
    on CUDA tensors."""
    variant = int8_conv_variant(*x.shape, w.shape[0], k, stride, dilation,
                                out_dtype)
    return _launch_conv(variant, x, w, w_scale, in_scale, bias, k, stride,
                        dilation, out_dtype)


def _conv_fake(x, w, w_scale, in_scale, bias, k, stride, dilation,
               out_dtype):
    ho, wo = conv_out_hw(x.shape[1], x.shape[2], k, stride, dilation)
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]), dtype=out_dtype)


_LIB.impl("quantize_int8", _quantize_cpu, "CPU")
_LIB.impl("quantize_int8", _quantize_cuda, "CUDA")
torch.library.register_fake("reftr::quantize_int8", _quantize_fake,
                            lib=_LIB)
_LIB.impl("int8_conv", _conv_cpu, "CPU")
_LIB.impl("int8_conv", _conv_cuda, "CUDA")
torch.library.register_fake("reftr::int8_conv", _conv_fake, lib=_LIB)


def quantize_int8(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """int8 of float32 or bf16 ``x`` (any shape) on the grid of the float32
    scalar ``in_scale``: the kernel on a CUDA tensor, ``quantize_plain`` on
    a CPU one."""
    _check_quantize(x, in_scale)
    return torch.ops.reftr.quantize_int8(x, in_scale)


def int8_conv(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
              in_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              k: int = 1, stride: int = 1, dilation: int = 1,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 k x k convolution of int8 NHWC ``x`` with int8 ``w`` [Cout,
    k*k*Cin] ((r, s, c) order), padded by dilation * (k - 1) // 2: [N, Ho,
    Wo, Cout] in ``out_dtype``. The kernel on CUDA tensors,
    ``int8_conv_plain`` on CPU ones. One side: every convolution of the
    backbone is square."""
    _check_conv(x, w, w_scale, in_scale, bias, k, stride, dilation,
                out_dtype)
    return torch.ops.reftr.int8_conv(x, w, w_scale, in_scale, bias, k,
                                     stride, dilation, out_dtype)


def int8_dense(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
               in_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 product of int8 rows ``x`` [..., K] with ``w`` [Cout, K]:
    [..., Cout], as ``int8_conv`` over [M, 1, 1, K]."""
    lead = x.shape[:-1]
    y = int8_conv(x.reshape(-1, 1, 1, x.shape[-1]), w, w_scale, in_scale,
                  bias, out_dtype=out_dtype)
    return y.reshape(*lead, w.shape[0])


quantize_int8.launches = 0
int8_conv.launches = 0
int8_conv.launches_wg = 0
int8_conv.launches_tc = 0
