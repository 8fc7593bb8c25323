"""Smoke run of the PyTorch port (reftr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card's name and power limit, then build every kernel of the
   serving path from the sources in this checkout
   (reftr_torch/kernels/csrc/flash_attn_fwd.cu, nvcc for sm_90a).
2. Kernel against its plain PyTorch version on the card, at the four call
   sites of the refcoco_det forward (B=8), with random key padding and one
   row whose keys are all masked, in float32 and bfloat16, each against
   the plain version in float32 on the same inputs. Tolerances: 1e-5 max
   abs in float32 (the sums run in another order), 2e-2 in bfloat16 (the
   kernel rounds its output to bf16: half a bf16 ulp is 7.8e-3 at
   magnitudes up to 4). Times of the kernel, the
   plain version and F.scaled_dot_product_attention (a yardstick only;
   the port never calls it) with CUDA events after a warm-up.
3. The serving path at full width: refcoco_det (ResNet-50, BERT-base,
   6+6 VL layers, d=256) at 640x640 with seeded random weights, bfloat16,
   behind a MicroBatcher with serve batch 8. Six requests of 1-3 phrases
   each (random uint8 canvases with ragged valid regions, token ids of
   length 5-40). Every request must come back without error, with finite
   boxes inside its image, and the kernel's launch count must rise by
   exactly 30 per batch forward (12 BERT + 6 encoder + 12 decoder
   attentions). Then full batches time the forward (host to host, median
   of four turns each with the kernel and with the plain attention, after
   a warm-up), torch.profiler splits one forward's device time by kernel
   category, and one padded batch runs through the kernel and through
   the plain attention on the card and the encoder memory and decoder
   states are compared: float32 kernel against float32 plain at 1e-4 max
   abs (the per-attention 1e-6 gap carried through 30 attentions and
   their LayerNorms), bfloat16 kernel against bfloat16 plain and against
   float32 plain at 5e-2 relative L2 error (bf16 rounding of every
   activation of a 100-layer network).
4. Print one JSON line listing each kernel with its launches on the main
   path, its error, its times and its bound on this card.
5. Print {"ok": true, "device": {...}} as the last line.

It needs a CUDA card and the reftr_torch package beside it; without
either it fails before it prints any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SERVE_BATCH = 8
N_REQUESTS = 6
ATTN_PER_FORWARD = 30  # 12 BERT-base + 6 encoder + 6 + 6 decoder layers
# (Sq, Sk, H, D) of each attention call site of refcoco_det at 640 px
CALL_SITES = {
    "vl_encoder_self": (440, 440, 8, 32),
    "decoder_self": (1, 1, 8, 32),
    "decoder_cross": (1, 440, 8, 32),
    "bert_self": (40, 40, 12, 64),
}
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL_F32_ABS = 1e-4
MODEL_TOL_BF16_REL = 5e-2
# NVIDIA H100 SXM data sheet: HBM rate, f32 outside the tensor cores, bf16
# dense tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, sq, sk, h, d, valid, dtype_name) -> tuple:
    """Least time for one attention on this card: each input read once and
    the output written once, against the two products over the keys this
    data needs (the valid keys; all sk keys for a row with none valid)."""
    import torch

    es = 4 if dtype_name == "float32" else 2
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * es + b * sk
    keys = torch.where(valid.any(-1), valid.sum(-1), sk)
    flops = 4.0 * h * d * sq * float(keys.sum())
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_kernel(report: dict) -> dict:
    """Phase 2: the flash kernel against its plain version per call site."""
    import torch
    import torch.nn.functional as F

    from reftr_torch.kernels.attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for site, (sq, sk, h, d) in CALL_SITES.items():
        b = SERVE_BATCH
        q32, k32, v32 = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                         for s in (sq, sk, sk))
        lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
        valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
        valid[0] = False  # a row whose keys are all masked
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            want = attention_plain(q.float(), k.float(), v.float(), valid)
            got = flash_attention(q, k, v, valid)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            if not math.isfinite(err) or err > KERNEL_TOL[name]:
                raise AssertionError(
                    f"{site} {name}: kernel vs plain max abs error {err:.3g}"
                    f" > {KERNEL_TOL[name]}")
            worst[name] = max(worst[name], err)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bias_dt = bias.to(dt)
            ms = cuda_ms(lambda: flash_attention(q, k, v, valid))
            plain_ms = cuda_ms(lambda: attention_plain(q, k, v, valid))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias_dt))
            bound, bound_by = attention_bound_ms(b, sq, sk, h, d, valid, name)
            row = {"site": site, "dtype": name, "B": b, "Sq": sq, "Sk": sk,
                   "H": h, "D": d, "max_abs_err": err, "tol": KERNEL_TOL[name],
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": bound_by}
            rows.append(row)
            print(f"kernel {site:16s} {name:8s} B={b} Sq={sq} Sk={sk} H={h} "
                  f"D={d}: max_abs_err {err:.3g} (tol {KERNEL_TOL[name]}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})",
                  flush=True)
    report["call_sites"] = rows
    report["max_abs_err"] = worst
    return report


def make_requests(rng: np.random.Generator, img: int, seq: int, vocab: int):
    from reftr_torch.serve import Request

    reqs = []
    for i in range(N_REQUESTS):
        k = int(rng.integers(1, 4))
        vh, vw = (int(x) for x in rng.integers(img // 2, img + 1, size=2))
        if i == 0:
            vh = vw = img  # one canvas filled to the edge
        canvas = np.zeros((img, img, 3), np.uint8)
        canvas[:vh, :vw] = rng.integers(0, 256, (vh, vw, 3), dtype=np.uint8)
        valid = np.zeros((img, img), bool)
        valid[:vh, :vw] = True
        sent = np.zeros((k, seq), np.int32)
        sent_valid = np.zeros((k, seq), np.int32)
        for j in range(k):
            n = int(rng.integers(5, seq + 1))
            sent[j, :n] = rng.integers(1, vocab, n)
            sent_valid[j, :n] = 1
        rows = {"image": np.repeat(canvas[None], k, 0),
                "image_valid": np.repeat(valid[None], k, 0),
                "sentence": sent, "sentence_valid": sent_valid}
        # the canvas holds the image resized by 1/2: the served box is in
        # the original image's pixels
        reqs.append(Request(rows=rows, k=k, orig_hw=(2 * vh, 2 * vw),
                            valid_hw=(vh, vw)))
    return reqs


def forward_ms(model, batch, iters: int = 10) -> float:
    """Mean host time of one ServingModel call (device forward and fetch)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def ms_list(values) -> str:
    return ", ".join(f"{v:.2f}" for v in values)


def kernel_category(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_attn_fwd"
    if "conv" in low or "fprop" in low or "dgrad" in low or "cudnn" in low:
        return "convolution"
    if "gemm" in low or "nvjet" in low or "cublas" in low:
        return "gemm"
    if "norm" in low:
        return "normalization"
    if "softmax" in low or "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def profile_forward(model, batch, step_ms: float, iters: int = 5) -> dict:
    """Device time of the steady-state serving forward by kernel category
    (torch.profiler's device events), the kernels launched per forward, and
    the device's busy share of the forward's unprofiled host time
    ``step_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            model(batch)
        torch.cuda.synchronize()
    by_cat: dict = {}
    by_name: dict = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        ms = ev.device_time_total / 1e3 / iters
        n_kernels += 1
        cat = kernel_category(ev.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    device_ms = sum(by_cat.values())
    if device_ms == 0:
        print("profile: torch.profiler saw no device time: not measured",
              flush=True)
        return {"device_ms": None}
    busy = device_ms / step_ms
    print(f"profile: bf16 batch {SERVE_BATCH} forward: device {device_ms:.3f}"
          f" ms in {n_kernels / iters:.0f} kernels, of {step_ms:.3f} ms host"
          f" time unprofiled: busy share {busy:.3f}", flush=True)
    for cat, ms in sorted(by_cat.items(), key=lambda x: -x[1]):
        print(f"profile:   {cat:14s} {ms:8.3f} ms {ms / device_ms:6.1%}",
              flush=True)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
    for name, ms in top:
        print(f"profile:   top {ms:8.3f} ms  {name[:90]}", flush=True)
    return {"device_ms": device_ms, "kernels_per_forward": n_kernels / iters,
            "host_ms": step_ms, "busy_share": busy, "by_category_ms": by_cat,
            "top_kernels_ms": dict(top)}


def serve(report: dict, counters) -> dict:
    """Phase 3: refcoco_det at full width behind the MicroBatcher."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.kernels.attention import flash_attention
    from reftr_torch.nn.attention import set_plain_attention
    from reftr_torch.serve import MicroBatcher, ServingModel, pad_batch

    cfg = {name: preset_config("refcoco_det", dtype=name)
           for name in ("float32", "bfloat16")}
    img = cfg["bfloat16"].data.img_size
    seq = cfg["bfloat16"].data.max_query_len
    vocab = cfg["bfloat16"].model.bert.vocab_size
    rng = np.random.default_rng(0)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ServingModel(cfg["bfloat16"], SERVE_BATCH, device="cuda", seed=0)
    warm = make_requests(np.random.default_rng(1), img, seq, vocab)[:1]
    model(pad_batch(warm, SERVE_BATCH))  # first forward: cuDNN, kernel set-up
    torch.cuda.synchronize()
    print(f"serve: model built and warmed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    reqs = make_requests(rng, img, seq, vocab)
    for c in counters:
        c.launches = 0
    batcher = MicroBatcher(model, timeout_ms=5.0)
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    for r in reqs:
        if not r.done.wait(timeout=300):
            raise AssertionError("a request was not answered in 300 s")
    served_s = time.perf_counter() - t0
    batcher.stop()
    launches = {c.__name__: c.launches for c in counters}
    if batcher.thread.is_alive():
        raise AssertionError("the MicroBatcher thread did not stop")
    for i, r in enumerate(reqs):
        if r.error is not None:
            raise AssertionError(f"request {i} failed: {r.error}")
        if r.result is None or len(r.result) != r.k:
            raise AssertionError(f"request {i}: {r.k} phrases, result "
                                 f"{r.result}")
        h0, w0 = r.orig_hw
        for res in r.result:
            x0, y0, x1, y1 = res["box_xyxy"]
            if not all(math.isfinite(v) for v in (x0, y0, x1, y1)):
                raise AssertionError(f"request {i}: box {res['box_xyxy']}")
            if not (0 <= x0 <= x1 <= w0 and 0 <= y0 <= y1 <= h0):
                raise AssertionError(f"request {i}: box {res['box_xyxy']} "
                                     f"outside its {w0}x{h0} image")
    n_batches = batcher.stats["batches"]
    rows = sum(r.k for r in reqs)
    if n_batches < 1 or launches["flash_attention"] != \
            ATTN_PER_FORWARD * n_batches:
        raise AssertionError(
            f"flash_attention launched {launches['flash_attention']} times "
            f"for {n_batches} batch forwards, not {ATTN_PER_FORWARD} each")
    print(f"serve: {len(reqs)} requests, {rows} phrases in {n_batches} "
          f"batches of {SERVE_BATCH}, {served_s:.3f} s; launches {launches}",
          flush=True)

    # steady state: full padded batches through ServingModel, host to host,
    # with the kernel and with the plain attention in turns, after a warm-up
    # (the first timed forwards of a fresh process run slower)
    full = pad_batch(reqs[:1], SERVE_BATCH)
    forward_ms(model, full, iters=20)
    step_ms = {"kernel": [], "plain": []}
    for mode in ("kernel", "plain", "plain", "kernel") * 2:
        set_plain_attention(model.model, mode == "plain")
        step_ms[mode].append(forward_ms(model, full))
    set_plain_attention(model.model, False)
    step_s = statistics.median(step_ms["kernel"]) / 1e3
    plain_s = statistics.median(step_ms["plain"]) / 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve: bf16 batch {SERVE_BATCH} forward + fetch median "
          f"{step_s * 1e3:.2f} ms = {SERVE_BATCH / step_s:.1f} img/s (runs "
          f"{ms_list(step_ms['kernel'])} ms); with the plain attention "
          f"{plain_s * 1e3:.2f} ms = {SERVE_BATCH / plain_s:.1f} img/s (runs "
          f"{ms_list(step_ms['plain'])} ms); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)

    report["profile"] = profile_forward(model, full, step_s * 1e3)

    # kernel path against the plain attention path on one batch
    compare = pad_batch(reqs[:3], SERVE_BATCH)
    f32 = ServingModel(cfg["float32"], SERVE_BATCH, device="cuda", seed=0)
    outs = {}
    with torch.inference_mode():
        for name, m in (("float32", f32.model), ("bfloat16", model.model)):
            dev = {k: torch.from_numpy(v).cuda() for k, v in compare.items()}
            for plain in (False, True):
                set_plain_attention(m, plain)
                o = m(dev, return_internals=True)["internals"]
                outs[(name, plain)] = {k: o[k].float() for k in
                                       ("memory", "hs")}
            set_plain_attention(m, False)
    del f32
    errs = {}
    for key in ("memory", "hs"):
        want = outs[("float32", True)][key]
        if not torch.isfinite(want).all():
            raise AssertionError(f"plain float32 {key} is not finite")
        e32 = (outs[("float32", False)][key] - want).abs().max().item()
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
        e16 = rel(outs[("bfloat16", False)][key], want)
        e16p = rel(outs[("bfloat16", False)][key],
                   outs[("bfloat16", True)][key])
        errs[key] = {"f32_kernel_vs_plain_max_abs": e32,
                     "bf16_kernel_vs_f32_plain_rel_l2": e16,
                     "bf16_kernel_vs_bf16_plain_rel_l2": e16p}
        print(f"serve: {key} {tuple(want.shape)}: f32 kernel vs plain max abs"
              f" {e32:.3g} (tol {MODEL_TOL_F32_ABS}); bf16 kernel vs f32 plain"
              f" rel L2 {e16:.3g}, vs bf16 plain {e16p:.3g} (tol "
              f"{MODEL_TOL_BF16_REL})", flush=True)
        if not e32 <= MODEL_TOL_F32_ABS:
            raise AssertionError(f"{key}: f32 kernel vs plain {e32:.3g}")
        if not (e16 <= MODEL_TOL_BF16_REL and e16p <= MODEL_TOL_BF16_REL):
            raise AssertionError(f"{key}: bf16 rel L2 {e16:.3g}, {e16p:.3g}")
    report["serve"] = {"requests": len(reqs), "phrases": rows,
                       "batches": n_batches, "launches": launches,
                       "served_s": served_s, "bf16_forward_ms": step_s * 1e3,
                       "bf16_img_per_s": SERVE_BATCH / step_s,
                       "bf16_forward_runs_ms": step_ms,
                       "bf16_plain_attention_forward_ms": plain_s * 1e3,
                       "peak_memory_gb": peak_gb, "internals": errs}
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from reftr_torch.kernels import _nvcc
    from reftr_torch.kernels.attention import SOURCE, flash_attention

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _nvcc.build(SOURCE)
    print(f"built {SOURCE} in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    report = {"card": card}
    check_kernel(report)
    serve(report, [flash_attention])

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # the main path serves in bfloat16; its dominant call site is the VL
    # encoder (call_sites in chiprun_out/chip_smoke.json has every site)
    enc = next(r for r in report["call_sites"]
               if r["site"] == "vl_encoder_self" and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "reftr_torch/kernels/csrc/flash_attn_fwd.cu",
        "replaces": "reftr_tpu/kernels/attention.py:86",
        "launches": report["serve"]["launches"]["flash_attention"],
        "max_abs_err": max(report["max_abs_err"].values()),
        "max_abs_err_f32": report["max_abs_err"]["float32"],
        "shape": "vl_encoder_self bfloat16 B=8 Sq=Sk=440 H=8 D=32",
        "ms": enc["ms"], "kernel_ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": enc["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
