"""The int8 conv kernel's route on the CPU (kernels/quant.py:
int8_conv_variant, int8_conv_tile), the wrapper's refusals, and the plain
version against JAX's QuantConv and QuantDense at the shapes that sit on
the edges of the "wg" kernel's tiles (Cout = 64 with M not a multiple of
128, Cin = 64 at stride 2 and at dilation 2, Cin = 128 and 2048 with the
128-byte K tile, a dense of K = 256 -> 2048 at a ragged M).

The route is written out here as a table, apart from the code, and checked
at the 31 product shapes of a refcoco_det forward (chip_smoke.INT8_SHAPES)
at phase 14a's batches (B = 8, 32 and 64) in both output dtypes, and at
the card tests' shapes
(tests/test_torch_cuda.py's INT8_CONVS). Nothing here needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from reftr_tpu.nn import quant as jax_quant
from reftr_torch.kernels import quant as kquant
from test_torch_cuda import INT8_CONVS
from torch_parity_utils import t

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
# half the card's 132 SMs: the least count of 128-column tiles "wg"
# takes them at
MIN_TILES = 66


def geometry(shape):
    """(n, h, w, c, cout, k, stride, dilation) of a product shape."""
    if shape[0] == "conv":
        return shape[1:]
    _, m, k, n = shape
    return (m, 1, 1, k, n, 1, 1, 1)


def want_variant(cout: int, dtype) -> str:
    """"wg" where its TMA store takes the output's rows (a multiple of 16
    bytes), else "tc"."""
    return "wg" if cout * ESIZE[dtype] % 16 == 0 else "tc"


def want_tile(n, h, w, c, cout, k, s, d, dtype) -> int:
    """Tiles of 128 columns where Cout is above 64 and they number at least
    MIN_TILES, else 64 (in either dtype)."""
    pad = d * (k - 1) // 2
    ho = (h + 2 * pad - d * (k - 1) - 1) // s + 1
    wo = (w + 2 * pad - d * (k - 1) - 1) // s + 1
    m_tiles = -(-n * ho * wo // 128)
    return 128 if cout > 64 and m_tiles * -(-cout // 128) >= MIN_TILES else 64


MODEL_SHAPES = [chip_smoke.scaled(shape, b // chip_smoke.SERVE_BATCH)
                for shape in chip_smoke.INT8_SHAPES
                for b in chip_smoke.INT8_BATCHES]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=[str(s[1:]) for s in MODEL_SHAPES])
def test_route_at_the_model_shapes(shape, dtype):
    """Every product of the model takes "wg" (every Cout is a multiple of
    64), with the table's tile."""
    tdt = DTYPES[dtype][1]
    geo = geometry(shape)
    assert kquant.int8_conv_variant(*geo, tdt) == "wg"
    assert kquant.int8_conv_tile(*geo, tdt) == want_tile(*geo, tdt)
    assert kquant.int8_conv_tile(*geo, tdt) in kquant.WG_TILES


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("conv", INT8_CONVS)
def test_route_at_the_card_tests_shapes(conv, dtype):
    """The card tests' shapes: "tc" only where "wg" cannot store the
    output's rows (Cout = 2, 10 and 130: rows not a multiple of 16 bytes
    in either dtype)."""
    tdt = DTYPES[dtype][1]
    assert kquant.int8_conv_variant(*conv, tdt) == want_variant(conv[4], tdt)
    if want_variant(conv[4], tdt) == "wg":
        assert kquant.int8_conv_tile(*conv, tdt) == want_tile(*conv, tdt)


def test_model_shapes_count_a_forwards_products():
    """31 shapes and 220 products a forward, as phase 14 counts them."""
    assert len(chip_smoke.INT8_SHAPES) == 31
    assert sum(chip_smoke.INT8_SHAPES.values()) == chip_smoke.INT8_PRODUCTS


def _operands(shape, cout, k, c, dtype=torch.float32):
    x = torch.zeros(shape, dtype=torch.int8)
    w = torch.zeros(cout, k * k * c, dtype=torch.int8)
    return (x, w, torch.ones(cout), torch.ones(()), None)


@pytest.mark.parametrize("variant,shape,cout,k,dtype,match", [
    ("tc", (1, 4, 4, 32), 8, 1, torch.bfloat16, "Cin a multiple of 64"),
    ("wg", (1, 4, 4, 96), 8, 1, torch.bfloat16, "Cin a multiple of 64"),
    ("tc", (1, 4, 4, 64), 7, 1, torch.float32, "even Cout"),
    ("wg", (1, 4, 4, 64), 10, 1, torch.bfloat16, "multiple of 16 bytes"),
    ("wg", (1, 4, 4, 64), 6, 3, torch.float32, "multiple of 16 bytes"),
])
def test_cuda_conv_check_refuses_what_a_kernel_does_not_take(
        variant, shape, cout, k, dtype, match):
    x, w, ws, scale, bias = _operands(shape, cout, k, shape[3])
    with pytest.raises(ValueError, match=match):
        kquant._check_cuda_conv(variant, x, w, ws, scale, bias, dtype)


def test_cuda_conv_check_refuses_unaligned_and_strided_inputs():
    x, w, ws, scale, bias = _operands((1, 4, 4, 64), 8, 1, 64)
    with pytest.raises(ValueError, match="contiguous"):
        kquant._check_cuda_conv("wg", x.transpose(1, 2), w, ws, scale,
                                bias, torch.bfloat16)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.int8)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kquant._check_cuda_conv("tc", shifted, w, ws, scale, bias,
                                torch.bfloat16)
    odd = torch.ones(9)[1:]
    with pytest.raises(ValueError, match="8-byte aligned"):
        kquant._check_cuda_conv("wg", x, w, odd, scale, bias, torch.bfloat16)


@pytest.mark.parametrize("variant", ["wg", "tc"])
def test_launcher_refuses_cpu_tensors(variant):
    """Only the op's CPU implementation takes CPU tensors (the plain
    version); the launcher raises before it allocates or launches, and no
    counter moves."""
    x, w, ws, scale, bias = _operands((1, 4, 4, 64), 64, 1, 64)
    before = (kquant.int8_conv.launches, kquant.int8_conv.launches_wg,
              kquant.int8_conv.launches_tc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kquant._launch_conv(variant, x, w, ws, scale, bias, 1, 1, 1,
                            torch.bfloat16)
    assert (kquant.int8_conv.launches, kquant.int8_conv.launches_wg,
            kquant.int8_conv.launches_tc) == before


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 5, 5, 64), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (64, 9 * 64), np.int8))
    ws, scale = torch.full((64,), 1e-3), torch.tensor(0.02)
    before = (kquant.int8_conv.launches, kquant.int8_conv.launches_wg,
              kquant.int8_conv.launches_tc)
    got = kquant.int8_conv(x, w, ws, scale, None, 3, 2, 1, torch.bfloat16)
    want = kquant.int8_conv_plain(x, w, ws, scale, None, 3, 2, 1,
                                  torch.bfloat16)
    assert torch.equal(got, want) and got.shape == (2, 3, 3, 64)
    assert (kquant.int8_conv.launches, kquant.int8_conv.launches_wg,
            kquant.int8_conv.launches_tc) == before


# (N, H, W, Cin, Cout, k, stride, dilation): the "wg" tile edges
EDGE_CONVS = [(3, 13, 11, 64, 64, 1, 1, 1), (3, 13, 11, 64, 64, 3, 1, 1),
              (2, 17, 15, 64, 128, 3, 2, 1), (2, 11, 13, 64, 64, 3, 1, 2),
              (2, 9, 7, 128, 64, 3, 1, 1), (1, 6, 6, 2048, 64, 3, 1, 1)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("conv", EDGE_CONVS, ids=[str(c) for c in EDGE_CONVS])
def test_plain_conv_matches_jax_at_the_tile_edges(conv, dtype):
    """int8_conv_plain, the arithmetic both kernels are held to bit for
    bit on the card, against JAX's QuantConv on the same int8 params and
    input: bit for bit."""
    n, h, w, cin, cout, k, s, d = conv
    rng = np.random.default_rng(cin + cout + k + s + d)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    kernel = rng.normal(size=(k, k, cin, cout)).astype(np.float32) * 0.1
    qp = jax_quant.quantize_conv_kernel(kernel, float(np.abs(x).max()) * .7)
    jdt, tdt = DTYPES[dtype]
    pad = d * (k - 1) // 2
    want = jax_quant.QuantConv(
        cout, (k, k), strides=(s, s), padding=((pad, pad), (pad, pad)),
        kernel_dilation=(d, d), dtype=jdt).apply(
            {"params": qp}, jnp.asarray(x).astype(jdt))
    scale = t(np.asarray(qp["in_scale"], np.float32))
    xq = kquant.quantize_plain(t(x).to(tdt), scale)
    kq = np.asarray(qp["kernel_q"])
    wq = torch.from_numpy(np.ascontiguousarray(
        kq.transpose(3, 0, 1, 2).reshape(cout, -1)))
    got = kquant.int8_conv_plain(xq, wq,
                                 t(np.asarray(qp["w_scale"], np.float32)),
                                 scale, None, k, s, d, tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_dense_matches_jax_at_a_ragged_m(dtype):
    """The VL encoder's FFN dense, 256 -> 2048 with its bias, at 333 rows
    (not a multiple of 128): bit for bit against JAX's QuantDense."""
    rng = np.random.default_rng(256)
    x = rng.normal(size=(333, 256)).astype(np.float32)
    kernel = rng.normal(size=(256, 2048)).astype(np.float32) * 0.05
    bias = rng.normal(size=(2048,)).astype(np.float32) * 0.05
    qp = jax_quant.quantize_dense_kernel(kernel, bias, float(np.abs(x).max()))
    jdt, tdt = DTYPES[dtype]
    want = jax_quant.QuantDense(2048, dtype=jdt, use_bias=True).apply(
        {"params": qp}, jnp.asarray(x).astype(jdt))
    scale = t(np.asarray(qp["in_scale"], np.float32))
    xq = kquant.quantize_plain(t(x).to(tdt), scale)
    wq = torch.from_numpy(np.ascontiguousarray(np.asarray(qp["kernel_q"]).T))
    got = kquant.int8_dense(xq, wq, t(np.asarray(qp["w_scale"], np.float32)),
                            scale, t(np.asarray(qp["bias"], np.float32)),
                            out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
