"""The dropout draw of K1 and K2 and the backward pair (K2 and K3) in one
checkout of the port: ptxas's registers and spills of each kernel that
draws the mask, and the times of K1, K2 and K3 on their bf16 and 3xTF32
variants at the model's sites, without dropout and with 0.1, with a digest
of every output.

    python3 time_keep_ab.py ROOT LABEL [step | rec | SITE,SITE,...]

ROOT is a checkout holding ``reftr_torch/`` (its kernels are built from
that checkout's sources on first use). Run it once per checkout in one
call to the card, in turns (base, change, change, base), to compare two
versions of the kernels. Prints one JSON line of ptxas's lines per source
(each D=32 instance: the "tc" and "tf32x3" kernels' whose mangled
name holds ILi32E, the "wg" one; where the kernel has an instance per
dropout path, both), then one JSON line per site,
kernel, variant and rate: the device milliseconds per call (CUDA events
around back-to-back calls queued behind a sleep kernel, so the host's
launch time is kept out, after a warm-up; the median of three turns) and
the digest of the output (the sum of its bits as integers), which two
checkouts that draw the same mask give alike. K2 and K3 take O and lse
from K1-TC of the same checkout; K3-wg takes di and, where the checkout's
K2-wg writes them (``new_keep_bits``), the keep bits from a K2-wg call
before the timed calls, as a training step hands them over, and K2-wg is
timed writing them, and with dropout also without them ("wg-nobits"),
which prices the store. Sites (B, Sq, Sk, H, D), or those named in the
third argument: flickr's encoder at one and
two feature levels (490^2, 2090^2, B=16), its phrase BERT (22 keys,
B=256) and sentence BERT (90 keys), its decoder over 490 keys at 16
queries, refcoco_det's encoder at one, two and four levels (440^2,
2040^2, 8540^2, B=8), the from-scratch recipe's at one (440^2, B=16) and
256^2 (B=8, the least at which the rule sends K2 and K3 to "wg"), in
bf16; flickr's encoder in float32. Key masks: batch row b keeps its first
Sk - (b * 7) % (Sk / 2) keys.

With ``step``, instead: refcoco_det's bf16 train step at four feature
levels (batch 8, dropout 0.1), as the checkout's chip_smoke.py phase 13e
times it (its ``step_turns``, three turns): device ms by torch.profiler,
peak device memory and the attention kernels' device ms, one JSON line.

With ``rec``, instead: refcoco_det's bf16 step at one feature level (the
checkout's phase 5 step, batch 8, dropout 0.1), whose encoder's K2 and K3
take "wg" by the rule at 440^2 from PR 18 on, by the rule and with both
sent to "tc" (chip_smoke.bwd_route_steps: host ms a step, in turns), and
the host's microseconds to queue one K2 and one K3 call at that site
(B=8, 440^2, dropout 0.1) on each route, in turns (the mean over 200
calls queued without a synchronize, so the card's time is kept out), one
JSON line.
"""

import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402

import reftr_torch  # noqa: E402
from reftr_torch.kernels import _nvcc  # noqa: E402
from reftr_torch.kernels import attention  # noqa: E402
from reftr_torch.kernels.attention import (_launch_dkv, _launch_dq,  # noqa: E402
                                           _launch_fwd)

assert Path(reftr_torch.__file__).resolve().is_relative_to(
    Path(root).resolve()), reftr_torch.__file__
CALLERS = ("flash_attn_fwd_tc.cu", "flash_attn_fwd_wg.cu",
           "flash_attn_fwd_f32tc.cu", "flash_attn_bwd_dq_tc.cu",
           "flash_attn_bwd_dq_f32tc.cu", "flash_attn_bwd_dq_wg.cu",
           "flash_attn_bwd_dkv_tc.cu", "flash_attn_bwd_dkv_wg.cu")
SITES = {
    "flickr_encoder_490": ((16, 490, 490, 8, 32), torch.bfloat16),
    "flickr_encoder_2090": ((16, 2090, 2090, 8, 32), torch.bfloat16),
    "phrase_bert_22": ((256, 22, 22, 12, 64), torch.bfloat16),
    "sentence_bert_90": ((16, 90, 90, 12, 64), torch.bfloat16),
    "flickr_decoder_16x490": ((16, 16, 490, 8, 32), torch.bfloat16),
    "encoder_440": ((8, 440, 440, 8, 32), torch.bfloat16),
    "encoder_2040": ((8, 2040, 2040, 8, 32), torch.bfloat16),
    "encoder_8540": ((8, 8540, 8540, 8, 32), torch.bfloat16),
    "scratch_encoder_440": ((16, 440, 440, 8, 32), torch.bfloat16),
    "encoder_256": ((8, 256, 256, 8, 32), torch.bfloat16),
    "f32_flickr_encoder_490": ((16, 490, 490, 8, 32), torch.float32),
}
TURNS = 3


def ptxas_lines(source: str, so: Path) -> dict:
    """ptxas's lines of each D=32 instance: the one where a kernel has one
    (a checkout before the instances per path), else those of Sk % 4 == 0's
    path (Lb1E) and the general one (Lb0E)."""
    log = so.with_suffix(".log").read_text().split("\n")

    def lines(marker):
        at = next((i for i, line in enumerate(log)
                   if "Compiling entry" in line and marker in line), None)
        return None if at is None else [
            line.split(":", 1)[-1].strip() for line in log[at + 1:at + 4]
            if "spill" in line or "registers" in line or "C7514" in line]

    base = "wg_kernel" if "_wg" in source else "ILi32E"
    sep = "I" if "_wg" in source else ""
    out = {path: lines(f"{base}{sep}{flag}") for path, flag in (
        ("Sk % 4 == 0", "Lb1E"), ("Sk % 4 != 0", "Lb0E"))}
    if source == "flash_attn_bwd_dq_wg.cu":  # instances per dropout path
        out = {path: lines(f"wg_kernelI{flag}") for path, flag in (
            ("no dropout", "Lb0E"), ("dropout", "Lb1E"),
            ("dropout, Sk % 4 == 0", "Lb1ELb1E"),
            ("dropout, Sk % 4 != 0", "Lb1ELb0E"))}
    out = {path: got for path, got in out.items() if got is not None}
    return out or {"": lines(base)}


def ms(fn, iters):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # about 20 ms at 1980 MHz: the host queues the calls meanwhile
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def digest(t: torch.Tensor) -> int:
    view = torch.int32 if t.dtype == torch.float32 else torch.int16
    return int(t.contiguous().view(view).to(torch.int64).sum())


def main():
    csrc = Path(root) / "reftr_torch" / "kernels" / "csrc"
    sources = [s for s in CALLERS if (csrc / s).exists()]
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_nvcc.build, sources)))
    print(json.dumps({"label": label, "ptxas": {
        s: ptxas_lines(s, so) for s, so in libs.items()}}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    names = sys.argv[3].split(",") if sys.argv[3:] else list(SITES)
    for site, ((b, sq, sk, h, d), dt) in ((n, SITES[n]) for n in names):
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(dt) for s in (sq, sk, sk, sq))
        keep = sk - (torch.arange(b, device="cuda") * 7) % max(1, sk // 2)
        valid = torch.arange(sk, device="cuda")[None] < keep[:, None]
        iters = 10 if b * h * sq * sk > 1e9 else 50
        if dt == torch.float32:
            variants = ("tf32x3",)
        elif d == 32 and sq >= 16:
            variants = ("tc", "wg")
        else:
            variants = ("tc",)
        for rate in (0.0, 0.1):
            seed = 0xAB0000 + sk if rate else None
            base = "tf32x3" if dt == torch.float32 else "tc"
            out, lse = _launch_fwd(base, q, k, v, valid, rate, seed)
            bwd = (q, k, v, valid, out, lse, do, rate, seed)
            fns = {}
            # K2-wg as a step runs it: writing di and, where this checkout
            # hands K3-wg the mask, the keep bits
            di = torch.empty_like(lse)
            bits = (attention.new_keep_bits(q, k)
                    if rate and hasattr(attention, "new_keep_bits") else None)
            wg_out = {"di_out": di}
            if bits is not None:
                wg_out["bits_out"] = bits
            for variant in variants:
                fns[("K1", variant)] = (lambda variant=variant: _launch_fwd(
                    variant, q, k, v, valid, rate, seed, False)[0])
                if variant == "wg":
                    _launch_dq("wg", *bwd, **wg_out)
                    fns[("K2", "wg")] = lambda: _launch_dq("wg", *bwd,
                                                           **wg_out)
                    if bits is not None:
                        fns[("K2", "wg-nobits")] = lambda: _launch_dq(
                            "wg", *bwd, di_out=di)
                    fns[("K3", "wg")] = lambda: _launch_dkv(
                        "wg", *bwd, di, *(() if bits is None else (bits,)))[1]
                else:
                    fns[("K2", variant)] = (lambda variant=variant:
                                            _launch_dq(variant, *bwd))
                    if sk >= 16:
                        fns[("K3", variant)] = (lambda variant=variant:
                                                _launch_dkv(variant, *bwd)[1])
            turns = {key: [] for key in fns}
            for _ in range(TURNS):
                for key, fn in fns.items():
                    turns[key].append(ms(fn, iters))
            for (kernel, variant), fn in fns.items():
                print(json.dumps({
                    "label": label, "site": site, "shape": [b, sq, sk, h, d],
                    "dtype": str(dt).removeprefix("torch."),
                    "kernel": kernel, "variant": variant, "dropout": rate,
                    "ms": statistics.median(turns[(kernel, variant)]),
                    "turns": turns[(kernel, variant)],
                    "digest": digest(fn())}), flush=True)
            del out, lse, bwd, fns, di, bits
        del q, k, v, do
        torch.cuda.empty_cache()


def step():
    """The four-level bf16 step of this checkout, as its phase 13e times
    it."""
    import numpy as np

    import chip_smoke
    from reftr_torch.cli.presets import preset_config
    from reftr_torch.kernels.attention import (flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq)

    assert Path(chip_smoke.__file__).resolve().is_relative_to(
        Path(root).resolve()), chip_smoke.__file__
    sources = sorted({src for src, _, _ in chip_smoke.KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_nvcc.build, sources))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = preset_config("refcoco_det", num_feature_levels=4)
    batch, targets = chip_smoke.train_batch(
        np.random.default_rng(18), cfg.data.img_size, cfg.data.max_query_len,
        cfg.model.bert.vocab_size, chip_smoke.SERVE_BATCH)
    state, train_step = chip_smoke.bf16_state(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    with torch.no_grad():  # gradients reach the attentions
        torch.nn.init.xavier_uniform_(
            state.model.bbox_embed.layers[-1].weight, generator=gen)
    chip_smoke.STEP_TURNS = 3
    runs = chip_smoke.step_turns(
        {"card": chip_smoke.card_line()},
        [flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv],
        {label: (state, train_step, None)}, batch, targets,
        f"{label}: bf16 batch 8 step at 4 feature levels",
        sites=chip_smoke.LEVELS_SITES)[label]
    print(json.dumps({
        "label": label, "step": "refcoco_det 4 levels bf16 B=8",
        "device_ms": [r["device_ms"] for r in runs],
        "peak_gb": [r["peak_gb"] for r in runs],
        "step_peak_gb": [r["step_peak_gb"] for r in runs],
        "attention_ms": [sum(v for k, v in (r["by_category_ms"] or {}).items()
                             if k.startswith("flash_attn")) for r in runs],
        "launches": runs[0]["launches"]}), flush=True)


def rec():
    """REC's bf16 step with K2 and K3 at the encoder on "wg" (the rule)
    and on "tc", and the host's time to queue them there."""
    import time

    import numpy as np

    import chip_smoke
    from reftr_torch.cli.presets import preset_config

    assert Path(chip_smoke.__file__).resolve().is_relative_to(
        Path(root).resolve()), chip_smoke.__file__
    sources = sorted({src for src, _, _ in chip_smoke.KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_nvcc.build, sources))
    cfg = preset_config("refcoco_det", dtype="bfloat16")
    batch, targets = chip_smoke.train_batch(
        np.random.default_rng(2), cfg.data.img_size, cfg.data.max_query_len,
        cfg.model.bert.vocab_size, chip_smoke.SERVE_BATCH)
    state, train_step = chip_smoke.bf16_state(cfg)
    for _ in range(3):
        state, _ = train_step(state, batch, targets)
    steps = chip_smoke.bwd_route_steps(train_step, state, batch, targets)
    del state, train_step
    torch.cuda.empty_cache()

    (b, sq, sk, h, d), dt = SITES["encoder_440"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(dt) for s in (sq, sk, sk, sq))
    valid = torch.arange(sk, device="cuda")[None] < (
        sk - (torch.arange(b, device="cuda") * 7) % (sk // 2))[:, None]
    rate, seed = 0.1, 0xAB0440
    out, lse = _launch_fwd("tc", q, k, v, valid, rate, seed)
    bwd = (q, k, v, valid, out, lse, do, rate, seed)
    di = torch.empty_like(lse)
    bits = attention.new_keep_bits(q, k)

    def pair(route):
        if route == "wg":
            _launch_dq("wg", *bwd, di_out=di, bits_out=bits)
            _launch_dkv("wg", *bwd, di, bits)
        else:
            _launch_dq("tc", *bwd)
            _launch_dkv("tc", *bwd)

    host = {"wg": [], "tc": []}
    for turn in range(8):
        route = ("wg", "tc", "tc", "wg")[turn % 4]
        for _ in range(5):
            pair(route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            pair(route)
        host[route].append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    print(json.dumps({
        "label": label, "rec_step_host_ms": steps,
        "queue_us_k2_k3_440": {r: {"turns": t, "median":
                                   statistics.median(t)}
                               for r, t in host.items()}}), flush=True)


if __name__ == "__main__":
    {"step": step, "rec": rec}.get(sys.argv[3] if sys.argv[3:] else "",
                                   main)()
