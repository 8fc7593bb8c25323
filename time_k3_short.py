"""Device time of K3 (dk, dv) with 16 or more queries and fewer than 16
keys, through the dispatch rule of one checkout of the port, beside
SDPA's backward.

    python3 time_k3_short.py ROOT LABEL

ROOT is a checkout holding ``reftr_torch/`` (its kernels are built from
that checkout's sources on first use). Run it once per checkout in one
call to the card, in turns (base, change, change, base), to compare two
versions of the route. At B=8, Sq=440, H=8, D=32 (chip_smoke.py phase
3c's site) with Sk = 1, 8 and 15, random key padding and batch row 0
fully masked, in float32 and bf16, without dropout and at 0.1, it prints
one JSON line: the variant ``dkv_variant`` picks, K3's device ms a call
(CUDA events around 20 calls queued behind a sleep kernel), the largest
error of dk and dv against ``attention_bwd_plain`` as a share of the
largest plain gradient, whether a second call gave the same bits, and
SDPA's backward (which also gives dq) timed the same way. The card's name
and power limit come first.
"""

import json
import os
import subprocess
import sys

root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import reftr_torch  # noqa: E402
from reftr_torch.kernels.attention import (attention_bwd_plain,  # noqa: E402
                                           attention_plain, dkv_variant,
                                           flash_attn_bwd_dkv)

assert reftr_torch.__file__.startswith(root), reftr_torch.__file__
B, SQ, H, D = 8, 440, 8, 32
KEYS = (1, 8, 15)


def queued_ms(fn, iters=20):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # the host queues the calls meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for sk in KEYS:
        q32, k32, v32, do32 = (
            torch.randn(B, s, H, D, device="cuda", generator=gen)
            for s in (SQ, sk, sk, SQ))
        lens = torch.randint(1, sk + 1, (B,), device="cuda", generator=gen)
        valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
        valid[0] = False
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
            for rate in (0.0, 0.1):
                seed = 4321 if rate else None
                out, lse = (x.contiguous() for x in attention_plain(
                    q, k, v, valid, True, dropout_rate=rate, seed=seed))
                out = out.to(dt)
                bwd = (q, k, v, valid, out, lse, do, rate, seed)
                wants = attention_bwd_plain(*bwd)
                got = flash_attn_bwd_dkv(*bwd)
                again = flash_attn_bwd_dkv(*bwd)
                scale = max(w.float().abs().max().item() for w in wants)
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, wants[1:])) / scale
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ms = queued_ms(lambda: flash_attn_bwd_dkv(*bwd))
                bias = torch.where(valid, 0.0, -1e9)[:, None, None, :].to(dt)
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                              for x in (q, k, v))
                sdpa = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias, dropout_p=rate)
                dot = do.transpose(1, 2)
                sdpa_ms = queued_ms(lambda: torch.autograd.grad(
                    sdpa, (qt, kt, vt), dot, retain_graph=True))
                print(json.dumps({
                    "label": label, "card": card, "Sq": SQ, "Sk": sk,
                    "dtype": name, "dropout": rate,
                    "variant": dkv_variant(SQ, sk, dt, D),
                    "dkv_device_ms": ms, "rel_err": err,
                    "bitwise_repeatable": same,
                    "sdpa_bwd_device_ms": sdpa_ms}), flush=True)


if __name__ == "__main__":
    main()
