"""The serving forward of two checkouts of the port on one CUDA card, timed
in turns within one run.

    python3 serve_ab.py BASE_ROOT CHANGE_ROOT [--rounds 8]

Each root is a checkout holding ``reftr_torch/``. One worker process per
root imports that checkout's package, builds refcoco_det (bfloat16, seeded
random weights) as a ``ServingModel`` at serve batch 8 (its kernels are
built from that checkout's sources on first use) and warms it. The driver
then asks the workers in turns, base, change, change, base, ..., for the
mean host time of 10 calls of the model on one full batch (forward and
fetch, as ``chip_smoke.py``'s ``forward_ms`` times it), and at the end each
for one forward's device time by torch.profiler. It prints the card's
``nvidia-smi`` name and power limit, each worker's runs and medians, and
one JSON line, which it also writes to ``chiprun_out/serve_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SERVE_BATCH = 8
TAG = "@@ "  # prefix of the workers' protocol lines on their stdout


def worker(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import reftr_torch
    from reftr_torch.cli.presets import preset_config
    from reftr_torch.serve import ServingModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = preset_config("refcoco_det", dtype="bfloat16")
    img, seq = cfg.data.img_size, cfg.data.max_query_len
    rng = np.random.default_rng(0)
    sentence_valid = np.zeros((SERVE_BATCH, seq), np.int32)
    for i in range(SERVE_BATCH):
        sentence_valid[i, :int(rng.integers(5, seq + 1))] = 1
    batch = {"image": rng.integers(0, 256, (SERVE_BATCH, img, img, 3),
                                   dtype=np.uint8),
             "image_valid": np.ones((SERVE_BATCH, img, img), bool),
             "sentence": (rng.integers(1, cfg.model.bert.vocab_size,
                                       (SERVE_BATCH, seq)) * sentence_valid
                          ).astype(np.int32),
             "sentence_valid": sentence_valid}
    model = ServingModel(cfg, SERVE_BATCH, device="cuda", seed=0)
    for _ in range(20):
        model(batch)
    torch.cuda.synchronize()
    print(f"{TAG}ready {Path(reftr_torch.__file__).parent}", flush=True)

    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "time":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                model(batch)
            torch.cuda.synchronize()
            print(f"{TAG}{(time.perf_counter() - t0) / 10 * 1e3}", flush=True)
        elif cmd == "device":
            iters = 5
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    model(batch)
                torch.cuda.synchronize()
            kernels = [ev.device_time_total for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA
                       and ev.device_time_total > 0
                       and not getattr(ev, "is_user_annotation", False)]
            print(f"{TAG}{sum(kernels) / 1e3 / iters} "
                  f"{len(kernels) / iters}", flush=True)
        elif cmd == "quit":
            return


def ask(proc: subprocess.Popen, cmd: str) -> str:
    proc.stdin.write(cmd + "\n")
    proc.stdin.flush()
    for line in proc.stdout:
        if line.startswith(TAG):
            return line[len(TAG):].strip()
        sys.stdout.write(line)
    raise RuntimeError(f"worker {proc.args} ended (exit {proc.wait()})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", metavar="ROOT")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--worker", metavar="ROOT")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    if len(args.roots) != 2:
        ap.error("give BASE_ROOT and CHANGE_ROOT")
    import torch

    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    names = ("base", "change")
    procs = {name: subprocess.Popen(
        [sys.executable, __file__, "--worker", root], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True) for name, root in zip(names,
                                                                  args.roots)}
    try:
        result = {"card": card}
        for name, proc in procs.items():
            result[name] = {"root": _ready(proc), "runs_ms": []}
        for _ in range(args.rounds // 2):
            for name in names + names[::-1]:
                result[name]["runs_ms"].append(float(ask(procs[name],
                                                         "time")))
        for name in names:
            r = result[name]
            r["median_ms"] = statistics.median(r["runs_ms"])
            device_ms, kernels = ask(procs[name], "device").split()
            r["device_ms"], r["kernels"] = float(device_ms), float(kernels)
            print(f"{name} ({r['root']}): bf16 batch {SERVE_BATCH} forward + "
                  f"fetch median {r['median_ms']} ms over runs "
                  f"{r['runs_ms']}; device {r['device_ms']} ms in "
                  f"{r['kernels']} kernels", flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    proc.stdin.write("quit\n")
                    proc.stdin.flush()
                    proc.wait(timeout=60)
                except (OSError, subprocess.TimeoutExpired):
                    proc.kill()
                    proc.wait()
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "serve_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


def _ready(proc: subprocess.Popen) -> str:
    """Wait for a worker's ready line; returns the package it imported."""
    for line in proc.stdout:
        if line.startswith(TAG + "ready "):
            return line[len(TAG + "ready "):].strip()
        sys.stdout.write(line)
    raise RuntimeError(f"worker {proc.args} ended (exit {proc.wait()})")


if __name__ == "__main__":
    sys.exit(main())
