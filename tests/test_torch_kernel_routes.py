"""The port's kernel routes on the CPU: which kernel the dispatch rule
sends each attention call of the model to, that the card's smoke builds
and names every kernel source, and the smoke's launch expectations and
bound.

The rule (kernels/attention.py: fwd_variant, dq_variant, dkv_variant) is
written out here as a table, apart from the code: below 16 queries the
decode kernels; bf16 K1, K2 and K3 on their warpgroup kernels ("wg") at a
head dim padding to 32 from WG_MIN's queries and keys (for K3 from 2040
keys only a multiple of 4), on the mma.sync tensor-core kernels ("tc")
elsewhere; float32 on the 3xTF32 kernels. It is checked at every attention site of
refcoco_det (one to four feature levels), flickr (one and two) and the
decoder, in both dtypes, at the shapes chip_smoke.py uses on the card
(CALL_SITES, NEW_SITES). Nothing here needs a card.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from reftr_torch.kernels import attention as attn

CSRC = Path(attn.__file__).parent / "csrc"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# every attention site of the model the smoke runs: refcoco_det's at the
# serve batch, the multi-phrase and four-level sites of phase 8 and the
# from-scratch recipe's of phase 10
SITES = sorted(chip_smoke.CALL_SITES) + sorted(chip_smoke.NEW_SITES)


def want_variant(kernel: str, sq: int, sk: int, dtype_name: str,
                 d: int) -> str:
    """The rule as a table: "fwd", "dq" or "dkv" at (Sq, Sk, D)."""
    if d > 128:
        return "plain"
    if sq < 16:
        return "dec"
    if kernel == "dkv" and sk < 16:
        return "simt"
    if dtype_name == "float32":
        return "tf32x3"
    least = {"fwd": 2040, "dq": 490, "dkv": 256}[kernel]
    aligned = kernel != "dkv" or sk < 2040 or sk % 4 == 0
    if 16 < d <= 32 and sq >= least and sk >= least and aligned:
        return "wg"
    return "tc"


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("site", SITES)
def test_rule_at_every_model_site(site, dtype_name):
    """K1, K2 and K3 at each site and dtype take the table's kernel."""
    _, sq, sk, _, d = chip_smoke.site_shape(site)
    dt = DTYPES[dtype_name]
    assert attn.fwd_variant(sq, sk, dt, d) == want_variant(
        "fwd", sq, sk, dtype_name, d)
    assert attn.dq_variant(sq, sk, dt, d) == want_variant(
        "dq", sq, sk, dtype_name, d)
    assert attn.dkv_variant(sq, sk, dt, d) == want_variant(
        "dkv", sq, sk, dtype_name, d)


def test_warpgroup_kernels_take_the_sites_they_measured_faster_at():
    """The sites the rule gives "wg" in bf16: K1 the encoders at two to
    four levels (refcoco_det's 2040, 8440, 8540 tokens, flickr's 2090), K2
    those and flickr's encoder at one level (490), K3 refcoco_det's at two
    to four levels and both encoders at one level (440, at B=8 and at the
    from-scratch recipe's 16, and 490), not
    flickr's at two levels (2090 tokens, not a multiple of 4: K3 draws
    Philox per element there); the short sites (BERT, the decoder at 16
    queries) keep "tc", and float32 never takes "wg"."""
    bf16 = torch.bfloat16
    rules = {"fwd": attn.fwd_variant, "dkv": attn.dkv_variant,
             "dq": attn.dq_variant}
    wg = {(kernel, site) for site in SITES for kernel, rule in rules.items()
          if rule(*chip_smoke.site_shape(site)[1:3], bf16,
                  chip_smoke.site_shape(site)[4]) == "wg"}
    levels = ("vl_encoder_4_levels", "vl_encoder_4_levels_b8",
              "vl_encoder_4_levels_b8_padded", "vl_encoder_3_levels_b8",
              "vl_encoder_2_levels_b8")
    assert wg == ({(kernel, site) for kernel in rules
                   for site in levels + ("multi_vl_encoder_2_levels",)}
                  | {("dq", "multi_vl_encoder_self"),
                     ("dkv", "multi_vl_encoder_self"),
                     ("dkv", "vl_encoder_self"),
                     ("dkv", "scratch_vl_encoder_self")}) - {
                         ("dkv", "multi_vl_encoder_2_levels")}
    for site in SITES:
        _, sq, sk, _, d = chip_smoke.site_shape(site)
        assert "wg" not in (rule(sq, sk, torch.float32, d)
                            for rule in rules.values())


def test_every_source_is_built_by_the_smoke():
    """Every .cu under csrc/ is a source of chip_smoke.KERNELS (phase 1
    builds them all), and every entry point there has its argtypes in
    kernels/attention.py with the same source."""
    sources = {p.name for p in CSRC.glob("*.cu")}
    assert sources == {src for src, _, _ in chip_smoke.KERNELS.values()}
    for name, (source, _, _) in chip_smoke.KERNELS.items():
        assert attn._ARGTYPES[name][0] == source
    assert set(attn._ARGTYPES) == set(chip_smoke.KERNELS)


@pytest.mark.parametrize("name",
                         ["flash_attn_fwd_wg", "flash_attn_bwd_dq_wg",
                          "flash_attn_bwd_dkv_wg"])
def test_warpgroup_sources_use_wgmma_tma_and_mbarriers(name):
    """The warpgroup kernels' sources (with their header) issue wgmma,
    TMA tile loads and mbarrier waits, and include no library kernel."""
    source = attn._ARGTYPES[name][0]
    text = (CSRC / source).read_text() + (CSRC / "flash_wg.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                "mbarrier.try_wait.parity", "setmaxnreg"):
        assert ptx in text
    includes = set(re.findall(r'#include [<"]([^>"]+)[>"]', text))
    assert includes <= {"cuda.h", "cuda_bf16.h", "cuda_runtime.h", "math.h",
                        "stdint.h", "flash_common.cuh", "flash_tc.cuh",
                        "flash_wg.cuh"}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("sites,per_step", [
    ("REC_SITES", 30), ("MULTI_FORWARD_SITES", 42), ("LEVELS_SITES", 30)])
def test_smoke_launch_expectations_follow_the_rule(sites, per_step,
                                                   dtype_name):
    """chip_smoke.expected_launches over a preset's sites: K1, K2 and K3
    launch per_step times a step (a decode-backward launch counts on K2
    and on K3), split over the variants the table gives each site."""
    table = getattr(chip_smoke, sites)
    want = chip_smoke.expected_launches(2, dtype_name, True, table)
    assert sum(calls for calls, *_ in table) == per_step
    for name, kernel in (("flash_attention", "fwd"),
                         ("flash_attn_bwd_dq", "dq"),
                         ("flash_attn_bwd_dkv", "dkv")):
        assert want[name] == 2 * per_step
        for variant in ("tc", "wg", "tf32x3", "dec"):
            assert want[f"{name}_{variant}"] == 2 * sum(
                calls for calls, sq, sk, d in table
                if want_variant(kernel, sq, sk, dtype_name, d) == variant)
        assert want[f"{name}_plain"] == 0
    forward = chip_smoke.expected_launches(3, dtype_name, False, table)
    assert forward["flash_attention"] == 3 * per_step
    assert forward["flash_attn_bwd_dq"] == forward["flash_attn_bwd_dkv"] == 0


def test_four_level_bf16_step_runs_k1_and_k3_on_the_warpgroup_kernels():
    """At four feature levels a bf16 step launches 6 encoder calls of K1,
    of K2 and of K3 on "wg", BERT's on "tc", the decoder's on the decode
    kernels."""
    want = chip_smoke.expected_launches(1, "bfloat16", True,
                                        chip_smoke.LEVELS_SITES)
    assert (want["flash_attention_wg"], want["flash_attention_tc"],
            want["flash_attention_dec"]) == (6, 12, 12)
    assert (want["flash_attn_bwd_dq_wg"], want["flash_attn_bwd_dq_tc"],
            want["flash_attn_bwd_dq_dec"]) == (6, 12, 12)
    assert (want["flash_attn_bwd_dkv_wg"], want["flash_attn_bwd_dkv_tc"],
            want["flash_attn_bwd_dkv_dec"]) == (6, 12, 12)


def test_bound_takes_the_largest_of_its_terms(monkeypatch):
    """attention_bound_ms at the four-level encoder (B=8, 8540^2, H=8,
    D=32, every key valid) on an H100's numbers: the exponentials (one
    MUFU.EX2 a pair at 16 a clock per SM) bound K1 above its tensor
    products, Philox's multiplies with dropout above both, and every
    variant of a kernel has one bound."""
    monkeypatch.setattr(chip_smoke, "CARD", {
        "sms": 132, "sm_clock_hz": 1.98e9, "philox_imad_per_call": 20.0})
    b, sq, sk, h, d = 8, 8540, 8540, 8, 32
    valid = torch.ones(b, sk, dtype=torch.bool)
    terms = chip_smoke.attention_bound_terms(b, sq, sk, h, d, valid,
                                             "bfloat16")
    pairs = b * h * sq * sk
    assert terms["exp"] == pytest.approx(pairs / (16 * 132 * 1.98e9) * 1e3)
    assert terms["tensor"] == pytest.approx(4 * d * pairs / 989e12 * 1e3)
    assert terms["exp"] > terms["tensor"] > terms["bytes"]
    assert "philox" not in terms
    bound, by = chip_smoke.attention_bound_ms(b, sq, sk, h, d, valid,
                                              "bfloat16")
    assert (bound, by) == (terms["exp"], "operations")
    drop = chip_smoke.attention_bound_terms(b, sq, sk, h, d, valid,
                                            "bfloat16", dropout=0.1)
    assert drop["philox"] == pytest.approx(
        pairs / 4 * 20.0 / (64 * 132 * 1.98e9) * 1e3)
    assert drop["philox"] > drop["exp"]
    for kernel in ("flash_attn_fwd", "flash_attn_bwd_dkv"):
        base = chip_smoke.attention_bound_ms(b, sq, sk, h, d, valid,
                                             "bfloat16", kernel, 0.1)
        for suffix in ("_tc", "_wg"):
            assert chip_smoke.attention_bound_ms(
                b, sq, sk, h, d, valid, "bfloat16", kernel + suffix,
                0.1) == base


@pytest.mark.parametrize("form,per_product", [
    ("IMAD.WIDE.U32 R4, R2, {imm}, RZ", 1),
    ("IMAD.HI.U32 R5, R2, {imm}, RZ ;\n /*0*/ IMAD R4, R2, {imm}, RZ", 2)])
def test_philox_multiplies_are_counted_from_machine_code(form, per_product):
    """philox_imad_per_call over cuobjdump-like lines of 3 calls: 10
    products by the first multiplier and 9 by the second a call (round 0
    multiplies the zero word 2), each one IMAD.WIDE or an IMAD.HI and an
    IMAD."""
    m0, m1 = chip_smoke.PHILOX_M
    lines = []
    for _ in range(3):
        lines += [form.format(imm=f"-0x{(1 << 32) - m0:x}")] * 10
        lines += [form.format(imm=f"-0x{(1 << 32) - m1:x}")] * 9
    text = "\n".join(f"        /*0a10*/   {line} ;" for line in lines)
    assert chip_smoke.philox_imad_per_call(text) == 19 * per_product
    assert chip_smoke.philox_imad_per_call("IMAD R1, R2, R3, RZ ;") is None


def test_di_plain_is_the_row_sum_the_backward_uses():
    """di_plain(O, dO) = rowsum(dO * O) [B, H, Sq] in float32, the di of
    attention_bwd_plain: the plain backward's ds with it and with an O
    that gives it agree."""
    gen = torch.Generator().manual_seed(0)
    o, do = (torch.randn(2, 5, 3, 8, generator=gen).to(torch.bfloat16)
             for _ in range(2))
    di = attn.di_plain(o, do)
    assert di.dtype == torch.float32 and di.shape == (2, 3, 5)
    assert di.is_contiguous()
    torch.testing.assert_close(
        di, torch.einsum("bqhd,bqhd->bhq", o.float(), do.float()),
        rtol=1e-6, atol=1e-6)
