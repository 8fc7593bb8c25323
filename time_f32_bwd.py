"""Device time of the 3xTF32 kernels (K1, K2 and K3 in float32) of one
checkout of the port, at the VL encoder's and BERT's shapes, each checked
against its plain version.

    python3 time_f32_bwd.py ROOT LABEL

ROOT is a checkout holding ``reftr_torch/`` (its kernels are built from
that checkout's sources on first use). Run it once per checkout in one
call to the card, in turns (base, change, change, base), to compare two
versions of the kernels. For each site (B=8 with random key padding and
batch row 0 fully masked; encoder 440×440, H=8, D=32; BERT 40×40, H=12,
D=64), without dropout and at 0.1, it prints one JSON line: the device
ms per call of K1 (``_launch_fwd("tf32x3")``), K2
(``_launch_dq("tf32x3")``) and K3 (``_launch_dkv``) by torch.profiler
over 20 calls after 3 warm-up calls, K2's and K3's sum, K1's largest error of out and lse against
``attention_plain``, and the largest error of dq, dk and dv against
``attention_bwd_plain`` as a share of the largest plain gradient.
"""

import json
import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import reftr_torch  # noqa: E402
from reftr_torch.kernels.attention import (_launch_dkv, _launch_dq,  # noqa: E402
                                           _launch_fwd, attention_bwd_plain,
                                           attention_plain)

assert reftr_torch.__file__.startswith(root), reftr_torch.__file__
SITES = {"encoder": (8, 440, 440, 8, 32), "bert": (8, 40, 40, 12, 64)}


def device_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window with no device activity is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and e.device_time_total > 0
                 and not getattr(e, "is_user_annotation", False))
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError("torch.profiler recorded no device time")


def main():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for site, (b, sq, sk, h, d) in SITES.items():
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   for s in (sq, sk, sk))
        lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
        valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
        valid[0] = False
        do = torch.randn(b, sq, h, d, device="cuda", generator=gen)
        for rate in (0.0, 0.1):
            seed = 1234 if rate else None
            out, lse = (x.contiguous() for x in attention_plain(
                q, k, v, valid, True, dropout_rate=rate, seed=seed))
            fwd = (q, k, v, valid, rate, seed)
            got_out, got_lse = _launch_fwd("tf32x3", *fwd)
            fwd_err = (got_out - out).abs().max().item()
            lse_err = (got_lse - lse).abs().max().item()
            k1 = device_ms(lambda: _launch_fwd("tf32x3", *fwd))
            args = (q, k, v, valid, out, lse, do, rate, seed)
            wants = attention_bwd_plain(*args)
            got = (_launch_dq("tf32x3", *args), *_launch_dkv("tf32x3", *args))
            scale = max(w.abs().max().item() for w in wants)
            err = max((g - w).abs().max().item()
                      for g, w in zip(got, wants)) / scale
            dq = device_ms(lambda: _launch_dq("tf32x3", *args))
            dkv = device_ms(lambda: _launch_dkv("tf32x3", *args))
            print(json.dumps({"label": label, "site": site, "dropout": rate,
                              "fwd_device_ms": k1,
                              "fwd_max_abs_err": fwd_err,
                              "lse_max_abs_err": lse_err,
                              "dq_device_ms": dq, "dkv_device_ms": dkv,
                              "pair": dq + dkv, "rel_err": err}), flush=True)


if __name__ == "__main__":
    main()
