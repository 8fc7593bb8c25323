"""The mxu_bf16 mode of K1-K3 against reftr_tpu (CPU).

``fused_attention(..., mxu_bf16=True)`` (reftr_tpu/kernels/attention.py,
``_mxu`` :69-83) rounds each product's operands to bf16 and keeps the
sums, the softmax, lse and di in float32. The port's plain versions
(``attention_plain(mxu_bf16=)``, ``attention_bwd_plain(mxu_bf16=)``),
which the CPU runs and the card's checks hold the kernels to, against the
Pallas kernels in interpret mode and ``jax.vjp`` of them, with dropout 0
(interpret mode refuses dropout): a masked batch, fewer than 16 queries
(the decode kernels' side), fewer than 16 keys and head dims off 32 and
64. And the rule that sends such a call to the "dec" and "tc" kernels.

Tolerance: 5e-5 of the largest magnitude of each JAX output or gradient.
Readings over CASES, float32 against JAX: at most 6.1e-6 of the largest
(dq and dk at 40 x 7, where a ds lands on the other side of a bf16
rounding; elsewhere at most 3.2e-7); the port's float32 against its own
float64 with the same roundings (the float64 reading): at most 2.0e-7.
The mode moves the output and gradients 2.8e-3 to 6.3e-3 of the largest
away from plain float32's (test_mxu_moves_the_result), 55 to 125 times
the tolerance, so the test sees a missing rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reftr_tpu.kernels.attention import fused_attention
from reftr_torch.kernels.attention import (_running_max,
                                           attention_bwd_plain,
                                           attention_plain, dkv_variant,
                                           dq_variant, flash_attention,
                                           fwd_variant, mxu_key_blocks,
                                           uses_mxu)
from torch_parity_utils import t

torch.set_num_threads(1)
REL_TOL = 5e-5

# (batch, Sq, Sk, heads, head_dim): REC's BERT and encoder shape cut down,
# fewer than 16 queries (the decode kernels), fewer than 16 keys (K3 below
# 16 keys), head dims that pad to 32 and 64
CASES = [
    (2, 40, 40, 2, 32),
    (2, 5, 23, 2, 32),
    (2, 1, 1, 2, 32),
    (2, 40, 7, 2, 32),
    (2, 24, 30, 2, 24),
    (2, 20, 20, 2, 48),
]


def make_inputs(seed, b, sq, sk, h, d):
    """q, k, v, a validity mask with a random number of valid keys per
    batch row (row 0 all valid) and the output's cotangent."""
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(sk)[None, :] < rng.integers(1, sk + 1, size=b)[:, None]
    valid[0, :] = True
    return q, k, v, valid, do


def jax_mxu(q, k, v, valid, do):
    """JAX's mxu_bf16 output and (dq, dk, dv), Pallas in interpret mode."""
    fn = lambda q, k, v: fused_attention(q, k, v, jnp.asarray(valid),
                                         interpret=True, mxu_bf16=True)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


def port_mxu(q, k, v, valid, do, dtype=torch.float32):
    """The port's output and gradients through flash_attention on the CPU
    in the mode (FlashAttentionFn: K1's op, then K2's and K3's plain
    versions)."""
    qt, kt, vt = (t(x).to(dtype).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, t(valid), mxu_bf16=True)
    out.backward(t(do).to(dtype))
    return [x.detach().double().numpy()
            for x in (out, qt.grad, kt.grad, vt.grad)]


def assert_close(got, want, what):
    err = np.abs(got - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (what, err,
                                                 np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_mxu_matches_jax(case):
    q, k, v, valid, do = make_inputs(0, *case)
    want = jax_mxu(q, k, v, valid, do)
    for what, got, w in zip(("out", "dq", "dk", "dv"),
                            port_mxu(q, k, v, valid, do), want):
        assert_close(got, w, what)


@pytest.mark.parametrize("case", CASES[:2])
def test_mxu_plain_functions_match_jax(case):
    """attention_plain and attention_bwd_plain called directly, as the
    card's checks call them, on the forward's O and lse."""
    q, k, v, valid, do = make_inputs(1, *case)
    want = jax_mxu(q, k, v, valid, do)
    o, lse = attention_plain(t(q), t(k), t(v), t(valid), True,
                             mxu_bf16=True)
    assert_close(o.double().numpy(), want[0], "out")
    grads = attention_bwd_plain(t(q), t(k), t(v), t(valid), o, lse, t(do),
                                mxu_bf16=True)
    for what, g, w in zip(("dq", "dk", "dv"), grads, want[1:]):
        assert_close(g.double().numpy(), w, what)


@pytest.mark.parametrize("case", CASES[:2])
def test_mxu_float64_reading(case):
    """The float32 plain versions against the same roundings in float64:
    the sums alone differ."""
    q, k, v, valid, do = make_inputs(2, *case)
    got = port_mxu(q, k, v, valid, do)
    ref = port_mxu(q, k, v, valid, do, torch.float64)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
        assert_close(g, w, what)


def test_mxu_key_blocks_match_jax_blocks():
    """Past one key block the TPU kernel rounds p against its running max
    over blocks of block_k keys (:113-123): attention_plain with
    mxu_key_blocks(block_k, Sk) is its forward there, and the row max,
    one block's rounding, is not."""
    q, k, v, valid, _ = make_inputs(4, 2, 20, 300, 2, 32)
    want = np.asarray(fused_attention(
        *(jnp.asarray(x) for x in (q, k, v, valid)), block_k=128,
        interpret=True, mxu_bf16=True))
    args = (t(q), t(k), t(v), t(valid))
    got = attention_plain(*args, mxu_bf16=True,
                          key_blocks=mxu_key_blocks(128, 300))
    assert_close(got.double().numpy(), want, "out")
    row_max = attention_plain(*args, mxu_bf16=True).double().numpy()
    assert np.abs(row_max - want).max() > 10 * REL_TOL * np.abs(want).max()


def _kernel_owners(layout, sk):
    """{key: (owner, step)} by walking the forward kernels' loops: "dec"
    as flash_attn_fwd_dec.cu's lanes take their keys, else tiles of
    ``layout`` keys."""
    if layout != "dec":
        return {j: (0, j // layout) for j in range(sk)}
    quarter = ((sk + 3) // 4 + 3) // 4 * 4
    owners = {}
    for warp in range(4):
        end = min((warp + 1) * quarter, sk)
        for lane in range(32):
            for step, j0 in enumerate(range(warp * quarter + lane * 4, end,
                                            128)):
                for j in range(j0, min(j0 + 4, end)):
                    owners[j] = (warp * 32 + lane, step)
    return owners


@pytest.mark.parametrize("layout,sk", [("dec", 1), ("dec", 130),
                                       ("dec", 513), ("dec", 2090),
                                       (64, 440), (64, 63)])
def test_mxu_key_blocks_follow_the_kernels(layout, sk):
    """mxu_key_blocks gives each key the owner and step of the kernels'
    loops ("tc" is tiles of 64), and _running_max the max of the owner's
    keys up to that step."""
    owner, step = mxu_key_blocks(layout, sk)
    owners = _kernel_owners(layout, sk)
    assert [(int(o), int(s)) for o, s in zip(owner, step)] == [
        owners[j] for j in range(sk)]
    x = torch.randn(2, 3, sk, generator=torch.Generator().manual_seed(sk),
                    dtype=torch.float64)
    want = torch.stack([x[..., [i for i in range(sk)
                                if owners[i][0] == owners[j][0]
                                and owners[i][1] <= owners[j][1]]].amax(-1)
                        for j in range(sk)], -1)
    assert torch.equal(_running_max(x, owner, step), want)
    if layout == 64:
        assert all(torch.equal(a, b) for a, b in zip(
            mxu_key_blocks("tc", sk), (owner, step)))


def mxu_check_readings(sq, sk, d, rate):
    """chip_smoke.mxu_errors at a card test's shape (batch 2, 3 heads,
    batch row 0 with a masked tail) of three stand-ins for a kernel
    against the plain versions in float32: the plain versions in float64
    with the same roundings (a sound kernel: its sums in another order),
    the plain versions without the mode (the control), and the plain
    backward with di from the rounded dO and O (a mode done wrong)."""
    import chip_smoke

    gen = torch.Generator().manual_seed(sq * 1009 + sk * 31 + d)
    q, k, v = (torch.randn(2, s, 3, d, generator=gen) for s in (sq, sk, sk))
    valid = torch.ones(2, sk, dtype=torch.bool)
    valid[0, sk // 2 + 1:] = False
    seed = 0x5EED if rate else None
    variant = fwd_variant(sq, sk, torch.float32, d, True)
    out, lse = attention_plain(q, k, v, valid, True, dropout_rate=rate,
                               seed=seed, mxu_bf16=True,
                               key_blocks=mxu_key_blocks(variant, sk))
    do = torch.randn(out.shape, generator=gen)
    args = (q, k, v, valid, out, lse, do, rate, seed)
    (w, _), ws = chip_smoke.mxu_plain(*args, variant)
    (r, _), rs = chip_smoke.mxu_plain(*args, variant, torch.float64)
    bf16 = lambda x: x.to(torch.bfloat16).float()
    di_rounded = attention_bwd_plain(q, k, v, valid, bf16(out), lse,
                                     bf16(do), rate, seed, mxu_bf16=True)
    want = (w, *ws)
    return (chip_smoke.mxu_errors(want, (r, *rs)),
            chip_smoke.mxu_errors(chip_smoke.mxu_control(*args), want),
            chip_smoke.mxu_errors((w, *di_rounded), want))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", [24, 64])
@pytest.mark.parametrize("sq,sk", [(16, 1), (63, 15), (65, 63), (64, 440),
                                   (1, 1), (5, 65), (15, 440)])
def test_mxu_checks_tell_the_mode(sq, sk, d, rate):
    """The card's checks of the mode (chip_smoke.MXU_TOL, mxu_errors) on
    the CPU's stand-ins (mxu_check_readings): a sound kernel passes them,
    its mean readings at most a quarter of the limit; the control fails
    the mean checks of the output and of a gradient; a backward with di
    from rounded operands fails a gradient's. Readings over the cases:
    sound at most 1.1e-5 in the mean (8.3e-4 on the output and 8.9e-4 of
    the largest gradient at the largest); the control at least 1.4e-3
    (output) and 2.1e-3 (gradient) in the mean; di from rounded operands
    at least 6.5e-4."""
    import chip_smoke

    sound, control, di_rounded = mxu_check_readings(sq, sk, d, rate)
    assert chip_smoke.mxu_failures(sound) == [], sound
    assert max(v for key, v in sound.items() if key.endswith("_mean")) <= (
        chip_smoke.MXU_TOL["mean"] / 4), sound
    assert chip_smoke.mxu_control_caught(
        chip_smoke.mxu_failures(control)), control
    assert max(di_rounded["dq_mean"], di_rounded["dk_mean"]) > (
        chip_smoke.MXU_TOL["mean"]), di_rounded


def test_mxu_moves_the_result():
    """The mode is seen: the float32 output and gradients move from plain
    float32's by far more than the tolerance."""
    q, k, v, valid, do = make_inputs(3, *CASES[0])
    mxu = port_mxu(q, k, v, valid, do)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, t(valid))
    out.backward(t(do))
    for what, a, b in zip(("out", "dq", "dk", "dv"), mxu,
                          (out, qt.grad, kt.grad, vt.grad)):
        b = b.detach().double().numpy()
        assert np.abs(a - b).max() > 20 * REL_TOL * np.abs(b).max(), what


def test_mxu_is_a_no_op_for_bf16():
    """A bf16 call ignores the mode: its operands are bf16 already, and the
    bf16 kernels round p and ds to bf16 for their products anyway. The
    port's bf16 output and gradients are bit-identical with and without
    it; JAX's two bf16 modes differ by its p rounding alone (one bf16 ulp
    here), and the port's bf16 output is within that of JAX's in the
    mode."""
    q, k, v, valid, do = make_inputs(4, *CASES[0])
    runs = []
    for mxu in (False, True):
        qt, kt, vt = (t(x).bfloat16().requires_grad_() for x in (q, k, v))
        out = flash_attention(qt, kt, vt, t(valid), mxu_bf16=mxu)
        out.backward(t(do).bfloat16())
        runs.append([x.detach() for x in (out, qt.grad, kt.grad, vt.grad)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jm = [np.asarray(fused_attention(qb, kb, vb, jnp.asarray(valid),
                                     interpret=True, mxu_bf16=m), np.float32)
          for m in (False, True)]
    ulp = np.abs(jm[0] - jm[1]).max()
    assert 0 < ulp <= 2.0 ** -6 * np.abs(jm[1]).max()
    assert np.abs(runs[1][0].float().numpy() - jm[1]).max() <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_rule(dtype):
    """The rule sends a float32 call in the mode to "dec" below 16 queries
    and to "tc" from there (never "tf32x3" or "wg"), at every REC site and
    at K3 below 16 keys; a bf16 call takes its usual variant."""
    sites = [(40, 40, 64), (440, 440, 32), (1, 1, 32), (1, 440, 32),
             (440, 8, 32), (2040, 2040, 32), (70, 130, 48), (70, 130, 160)]
    for sq, sk, d in sites:
        for rule in (fwd_variant, dq_variant, dkv_variant):
            got = rule(sq, sk, dtype, d, True)
            if dtype == torch.bfloat16:
                assert got == rule(sq, sk, dtype, d)
            elif d > 128:
                assert got == "plain"
            else:
                assert got == ("dec" if sq < 16 else "tc"), (rule, sq, sk)
    assert uses_mxu(torch.float32, True) and not uses_mxu(dtype, False)
    assert not uses_mxu(torch.bfloat16, True)
