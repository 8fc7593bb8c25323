"""Op-level time breakdown of a serving forward or a train step, by
``torch.profiler`` (port of reftr_tpu/tools/op_profile.py).

``profile(mode)`` runs the port's model at one of the JAX tool's
configurations, warms it up, records ``steps`` calls and prints a rank
table: self ms, share, calls per step, category and name. On the card the
rows are the device's kernels (CUDA activity); on the CPU (the tests, and
``--device cpu``) they are the host's ops by self time, labelled "host".

  rec    refcoco_det's serving forward in bf16 at batch 64, 640 px
  train  its bf16 autocast train step (aux losses) at batch 32
  tiny   a micro model (BERT-tiny, 1+1 VL layers, d=32) at batch 2, 64 px,
         float32: the tests' mode
  rec_int8 refused: int8 is ROADMAP.md queue 1 item 9

``rec`` and ``train`` run the JAX tool's folded model
(reftr_tpu/tools/op_profile.py:85-86): FrozenBN and the normalisation
folded into the convolutions (``fold_bn``, ``fold_normalize``;
``nn/fold.py``), the uint8 canvases cast as they come; ``unfolded=True``
(``--unfolded``) runs the standard model, which normalises on the device
and applies each FrozenBN's scale and shift. Inputs are perturbed on
every call. The module also holds the
smoke's per-category breakdown (``kernel_category``, ``profile_device``),
so that one reader of the profiler's events serves both.

Usage (on the card)::

    python -m reftr_torch.tools.op_profile [rec|train|tiny] [topk] \\
        [--steps 3] [--device cuda] [--trace_dir DIR]

``--trace_dir`` also writes the Chrome trace (``trace.json``) there.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

MODES = ("rec", "train", "tiny")
# the JAX tool's batch sizes (reftr_tpu/tools/op_profile.py:52, 83-87)
BATCH = {"rec": 64, "train": 32, "tiny": 2}
# the host's matrix-product ops, by their aten names (a CPU profile)
HOST_GEMMS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear")


def kernel_category(name: str) -> str:
    """The category of a kernel (or, on the CPU, an op) by its name: each
    flash kernel of this package by its source, then NCCL, convolution,
    optimizer, GEMM, normalization, reduction, elementwise, copy."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if name.startswith("reftr::"):
        return name.removeprefix("reftr::")
    for kernel, category in (
            ("flash_fwd_tc_kernel", "flash_attn_fwd_tc"),
            ("flash_fwd_wg_kernel", "flash_attn_fwd_wg"),
            ("flash_bwd_dkv_wg_kernel", "flash_attn_bwd_dkv_wg"),
            ("flash_bwd_dq_wg_kernel", "flash_attn_bwd_dq_wg"),
            ("flash_fwd_f32tc_kernel", "flash_attn_fwd_f32tc"),
            ("flash_fwd_dec_kernel", "flash_attn_fwd_dec"),
            ("flash_bwd_dq_tc_kernel", "flash_attn_bwd_dq_tc"),
            ("flash_bwd_dkv_tc_kernel", "flash_attn_bwd_dkv_tc"),
            ("flash_bwd_dq_f32tc_kernel", "flash_attn_bwd_dq_f32tc"),
            ("flash_bwd_dkv_f32tc_kernel", "flash_attn_bwd_dkv_f32tc"),
            ("flash_bwd_dec_kernel", "flash_attn_bwd_dec"),
            ("flash_fwd_kernel", "flash_attn_fwd"),
            ("flash_bwd_dq_kernel", "flash_attn_bwd_dq"),
            ("flash_bwd_dkv_kernel", "flash_attn_bwd_dkv")):
        if kernel in name:
            return category
    if ("conv" in low or "fprop" in low or "dgrad" in low or "wgrad" in low
            or "cudnn" in low):
        return "convolution"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer"
    if ("gemm" in low or "nvjet" in low or "cublas" in low
            or low.removeprefix("aten::") in HOST_GEMMS):
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


def events_ms(prof, iters: int, device: bool = True
              ) -> Dict[str, Tuple[float, float]]:
    """name -> (ms per call, occurrences per call) of a finished profile of
    ``iters`` calls: the device's kernels (``device``), else the host's
    ops by self time. A user annotation on the device (an optimizer's
    span) covers kernels counted on their own, and is left out."""
    from torch.autograd import DeviceType

    out: Dict[str, Tuple[float, float]] = {}
    for ev in prof.events():
        if device:
            if (ev.device_type != DeviceType.CUDA
                    or ev.device_time_total <= 0
                    or getattr(ev, "is_user_annotation", False)):
                continue
            us = ev.device_time_total
        else:
            if ev.device_type != DeviceType.CPU or ev.self_cpu_time_total <= 0:
                continue
            us = ev.self_cpu_time_total
        ms, n = out.get(ev.name, (0.0, 0.0))
        out[ev.name] = (ms + us / 1e3 / iters, n + 1 / iters)
    return out


def profile_device(run: Callable[[], object], what: str, step_ms: float,
                   iters: int = 5, split=None) -> dict:
    """Device time of ``iters`` calls of ``run`` by kernel category
    (torch.profiler's device events), the kernels launched per call, and
    the device's busy share of one call's unprofiled host time
    ``step_ms``. ``split(prof, iters)`` -> {row: (category, ms per call)}
    moves part of a category to a row of its own (the profile then
    records the ops' input shapes). Prints lines that start "profile:"."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=split is not None) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    found = events_ms(prof, iters)
    by_name = {name: ms for name, (ms, _) in found.items()}
    n_kernels = sum(n for _, n in found.values())
    by_cat: dict = {}
    for name, ms in by_name.items():
        cat = kernel_category(name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    device_ms = sum(by_cat.values())
    if device_ms == 0:
        print("profile: torch.profiler saw no device time: not measured",
              flush=True)
        return {"device_ms": None}
    for row, (cat, ms) in (split(prof, iters) if split else {}).items():
        by_cat[cat] = by_cat.get(cat, 0.0) - ms
        by_cat[row] = ms
    busy = device_ms / step_ms
    print(f"profile: {what}: device {device_ms:.3f}"
          f" ms in {n_kernels:.0f} kernels, of {step_ms:.3f} ms host"
          f" time unprofiled: busy share {busy:.3f}", flush=True)
    for cat, ms in sorted(by_cat.items(), key=lambda x: -x[1]):
        print(f"profile:   {cat:14s} {ms:8.3f} ms {ms / device_ms:6.1%}",
              flush=True)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
    for name, ms in top:
        print(f"profile:   top {ms:8.3f} ms  {name[:90]}", flush=True)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters, e.count
                    / iters) for e in prof.key_averages()),
                  key=lambda x: -x[1])[:10]
    for name, ms, calls in host:
        print(f"profile:   host {ms:8.3f} ms in {calls:6.0f} calls  "
              f"{name[:70]}", flush=True)
    # casts and layout copies (direct_copy_kernel), in "elementwise" above
    copies = sum(ms for name, ms in by_name.items() if "copy_kernel" in name)
    print(f"profile:   copy kernels (casts, layout) {copies:8.3f} ms",
          flush=True)
    return {"device_ms": device_ms, "kernels_per_call": n_kernels,
            "host_ms": step_ms, "busy_share": busy, "by_category_ms": by_cat,
            "copy_kernels_ms": copies,
            "top_kernels_ms": dict(top),
            "top_host_ops_ms": {name: ms for name, ms, _ in host}}


def make_batch(rng: np.random.Generator, b: int, hw: int, seq: int,
               vocab: int) -> Dict[str, np.ndarray]:
    """A batch of random uint8 canvases, every pixel valid, and token ids
    of 5 to ``seq`` valid tokens (the tool's own; bench.make_batch is the
    JAX package's)."""
    lengths = rng.integers(5, seq + 1, size=b)
    sentence_valid = (np.arange(seq)[None] < lengths[:, None]).astype(
        np.int32)
    sentence = rng.integers(1, vocab, (b, seq)).astype(np.int32)
    return {"image": rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
            "image_valid": np.ones((b, hw, hw), bool),
            "sentence": sentence * sentence_valid,
            "sentence_valid": sentence_valid}


def _config(mode: str, unfolded: bool = False):
    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                         RefTRConfig)

    if mode == "tiny":
        return RefTRConfig(
            model=ModelConfig(enc_layers=1, dec_layers=1, dim_feedforward=64,
                              hidden_dim=32, nheads=4, bert=BertConfig.tiny(),
                              aux_loss=False),
            data=DataConfig(img_size=64, max_img_size=64))
    return preset_config("refcoco_det", dtype="bfloat16",
                         aux_loss=mode == "train", fold_bn=not unfolded,
                         fold_normalize=not unfolded)


def _build_step(mode: str, device: torch.device, batch_size: int,
                unfolded: bool = False) -> Callable[[int], None]:
    """run(i): one call of ``mode`` on inputs perturbed by i, ending in a
    read of its result on the host."""
    from reftr_torch.serve import serving_module

    cfg = _config(mode, unfolded)
    mc, d = cfg.model, cfg.data
    rng = np.random.default_rng(0)
    batch = make_batch(rng, batch_size, d.img_size, d.max_query_len,
                       mc.bert.vocab_size)
    if mode == "train":
        from reftr_torch.core.config import LossConfig, TrainConfig
        from reftr_torch.models.criterion import weight_dict
        from reftr_torch.train.state import TrainState
        from reftr_torch.train.steps import make_train_step

        targets = {"boxes": rng.uniform(0.3, 0.6, (batch_size, 1, 4)).astype(
            np.float32), "box_valid": np.ones((batch_size, 1), bool)}
        holder = {"state": TrainState.create(mc, TrainConfig(lr=1e-4), 100,
                                             device=device)}
        lc = LossConfig()
        step = make_train_step(holder["state"].model,
                               weight_dict(lc, mc.dec_layers, mc.aux_loss),
                               lc, device=device)

        def run(i: int) -> None:
            image = ((batch["image"].astype(np.int32) + i) % 256).astype(
                np.uint8)
            holder["state"], metrics = step(holder["state"],
                                            dict(batch, image=image), targets)
            metrics.get()
        return run

    model = serving_module(cfg, device)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    @torch.inference_mode()
    def run(i: int) -> None:
        image = ((inputs["image"].int() + i) % 256).to(torch.uint8)
        model(dict(inputs, image=image))["pred_boxes"].cpu()
    return run


def rank_rows(prof, steps: int, device: bool) -> List[dict]:
    """The profile's rows by self time, largest first: name, category, ms
    per step, share of the total, calls per step."""
    found = events_ms(prof, steps, device)
    total = sum(ms for ms, _ in found.values()) or 1.0
    return sorted(({"name": name, "category": kernel_category(name),
                    "ms": ms, "share": ms / total, "calls": n}
                   for name, (ms, n) in found.items()),
                  key=lambda r: -r["ms"])


def profile(mode: str = "rec", topk: int = 25, steps: int = 3,
            device="cuda", trace_dir: str = "", print_fn=print,
            unfolded: bool = False) -> List[dict]:
    """Profile ``steps`` calls of ``mode`` after two warm-up calls and
    print the ``topk`` rows of ``rank_rows``; returns every row. With
    ``trace_dir`` the Chrome trace goes there too (the JAX tool's raw
    trace). ``unfolded``: ``rec`` and ``train`` without the folds."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from reftr_torch.core.device import resolve_device

    if mode == "rec_int8":
        raise NotImplementedError(
            "op_profile rec_int8: int8 (ROADMAP.md queue 1 item 9) is not "
            "ported yet")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    dev = resolve_device(device)
    b = BATCH[mode]
    run = _build_step(mode, dev, b, unfolded)
    for i in range(2):  # the kernels' build, cuDNN's plans, warm caches
        run(i)
    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with torch_profile(activities=activities) as prof:
        for i in range(steps):
            run(10 + i)
        if on_card:
            torch.cuda.synchronize(dev)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    rows = rank_rows(prof, steps, on_card)
    if on_card and not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    total = sum(r["ms"] for r in rows)
    where = torch.cuda.get_device_name(dev) if on_card else "the CPU"
    folds = ("" if mode == "tiny" else
             "  unfolded" if unfolded else "  fold_bn fold_normalize")
    print_fn(f"mode={mode}{folds}  batch={b}  "
             f"{'device' if on_card else 'host'} "
             f"ops={len(rows)} on {where}  total self time={total:.3f} ms a "
             f"step ({steps} steps)")
    print_fn(f"{'self ms':>9} {'%':>6} {'calls':>6} {'category':>22}  "
             f"name")
    for r in rows[:topk]:
        print_fn(f"{r['ms']:9.3f} {100 * r['share']:6.2f} {r['calls']:6.0f} "
                 f"{r['category'][:22]:>22}  {r['name'][:80]}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser("op-level profile of the port")
    p.add_argument("mode", nargs="?", default="rec",
                   choices=MODES + ("rec_int8",))
    p.add_argument("topk", nargs="?", type=int, default=25)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace_dir", default="")
    p.add_argument("--unfolded", action="store_true",
                   help="rec and train without fold_bn and fold_normalize")
    a = p.parse_args(argv)
    profile(a.mode, a.topk, a.steps, a.device, a.trace_dir,
            unfolded=a.unfolded)
    return 0


if __name__ == "__main__":
    sys.exit(main())
