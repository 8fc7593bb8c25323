"""The cost of each ResNet-50 stage on the card, forward and forward +
backward (port of reftr_tpu/tools/conv_profile.py:35-93).

A whole-step profile says how much the convolutions take in all, not
which. This tool times cumulative programs, the stem with layer1, then
with layers 1-2, up to 1-4, each run alone (in eager PyTorch a program
runs its prefix only), and reports each one's time and its delta over the
one before: the delta is the next stage's cost. The stem is not separable
(layer1's input is no output), so it is inside the first row.

Each program is the port's backbone (``nn/resnet.py``, FrozenBN, the
convolutions channels-last on the card) under bf16 autocast, as the train
step runs it, summing its stages' outputs in float32; forward + backward
takes the gradient of that sum with respect to every weight (the JAX
tool's ``jax.grad``; no stage frozen). As in the JAX tool, the stem is
the space-to-depth one (``s2d``) and FrozenBN is folded (``fold``) unless
asked otherwise (reftr_tpu/tools/conv_profile.py:36-45). Times: CUDA
events around ``steps`` back-to-back calls after ``warmup``, each call on
inputs perturbed for it and made before the timed calls.

Usage (on the card)::

    python -m reftr_torch.tools.conv_profile [batch] [--hw 640] \
        [--no_s2d] [--no_fold]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Sequence

import torch

STAGES = ["stem", "layer1", "layer2", "layer3", "layer4"]


def prefix_sum(net, x: torch.Tensor, k: int) -> torch.Tensor:
    """The stem and layers 1..k+1 of ``net`` (a ``nn.resnet.ResNet``) on
    NHWC ``x``, as ``ResNet.forward`` runs them: the float32 sum of their
    outputs."""
    x = net.stem(x)
    total = x.new_zeros((), dtype=torch.float32)
    for stage in range(1, k + 2):
        x = net.run_stage(stage, x)
        total = total + x.float().sum()
    return total


def time_ms(fn: Callable[[torch.Tensor], object],
            inputs: Sequence[torch.Tensor], warmup: int) -> float:
    """ms per call of ``fn`` over ``inputs[warmup:]``, one input a call,
    after ``fn`` on ``inputs[:warmup]``: CUDA events on the card, the
    host's clock on the CPU."""
    for x in inputs[:warmup]:
        fn(x)
    timed = inputs[warmup:]
    if inputs[0].device.type != "cuda":
        t0 = time.perf_counter()
        for x in timed:
            fn(x)
        return (time.perf_counter() - t0) / len(timed) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x in timed:
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(timed)


def profile(batch: int = 32, hw: int = 640, device="cuda", steps: int = 10,
            warmup: int = 2, print_fn=print, s2d: bool = True,
            fold: bool = True) -> List[dict]:
    """Time the four cumulative programs at ``batch`` x ``hw``^2, with the
    space-to-depth stem (``s2d``) and folded FrozenBN (``fold``) or
    without; returns a row each (program, fwd_ms, fwd_delta_ms,
    fwd_bwd_ms, fwd_bwd_delta_ms) and prints them."""
    from reftr_torch.core.device import resolve_device
    from reftr_torch.nn.resnet import ResNet
    from reftr_torch.ops.image import normalize_images

    dev = resolve_device(device)
    net = ResNet("resnet50", return_interm_layers=True, space_to_depth=s2d,
                 fold_bn=fold).to(dev)
    if dev.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    params = [p for p in net.parameters()]
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.randint(0, 256, (batch, hw, hw, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
    x0 = normalize_images(image, torch.float32)
    inputs = [x0 + i * 1e-3 for i in range(warmup + steps)]
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print_fn(f"# cumulative programs, B={batch} {hw}px bf16 autocast, "
             f"s2d={s2d} fold={fold}, on {where}: ms a call")
    rows: List[dict] = []
    prev_f = prev_t = 0.0
    for k in range(4):
        def fwd(x, k=k):
            with torch.no_grad(), torch.autocast(dev.type,
                                                 dtype=torch.bfloat16):
                return prefix_sum(net, x, k)

        def fwd_bwd(x, k=k):
            with torch.autocast(dev.type, dtype=torch.bfloat16):
                loss = prefix_sum(net, x, k)
            return torch.autograd.grad(loss, params, allow_unused=True)

        t_f = time_ms(fwd, inputs, warmup)
        t_t = time_ms(fwd_bwd, inputs, warmup)
        name = f"stem+layer1..{k + 1}"
        rows.append({"program": name, "fwd_ms": t_f,
                     "fwd_delta_ms": t_f - prev_f, "fwd_bwd_ms": t_t,
                     "fwd_bwd_delta_ms": t_t - prev_t})
        print_fn(f"{name:18s} fwd {t_f:8.3f} ms (+{t_f - prev_f:7.3f})   "
                 f"fwd+bwd {t_t:8.3f} ms (+{t_t - prev_t:7.3f})")
        prev_f, prev_t = t_f, t_t
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser("per-stage ResNet-50 cost")
    p.add_argument("batch", nargs="?", type=int, default=32)
    p.add_argument("--hw", type=int, default=640)
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--no_s2d", action="store_true",
                   help="the 7x7/stride-2 stem")
    p.add_argument("--no_fold", action="store_true",
                   help="FrozenBN's scale and shift applied, not folded")
    a = p.parse_args(argv)
    profile(a.batch, a.hw, a.device, a.steps, s2d=not a.no_s2d,
            fold=not a.no_fold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
