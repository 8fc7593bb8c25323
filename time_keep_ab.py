"""The dropout draw of K1 and K2 (flash_tc::keep_bits) in one checkout of
the port: ptxas's registers and spills of each kernel that calls it, and
the times of K1 and K2 on their bf16 and 3xTF32 variants at the model's
sites, without dropout and with 0.1, with a digest of every output.

    python3 time_keep_ab.py ROOT LABEL

ROOT is a checkout holding ``reftr_torch/`` (its kernels are built from
that checkout's sources on first use). Run it once per checkout in one
call to the card, in turns (base, change, change, base), to compare two
versions of the draw. Prints one JSON line of ptxas's lines per source
(each D=32 instance: the "tc" and "tf32x3" kernels' whose mangled
name holds ILi32E, the "wg" one; where the kernel has an instance per
dropout path, both), then one JSON line per site,
kernel, variant and rate: the milliseconds per call (CUDA events around
back-to-back launches after a warm-up, the median of three turns) and the
digest of the output (the sum of its bits as integers), which two
checkouts that draw the same mask give alike. K2 takes O and lse from
K1-TC of the same checkout. Sites (B, Sq, Sk, H, D): flickr's encoder at
one and two feature levels (490^2, 2090^2, B=16), its phrase BERT (22
keys, B=256) and sentence BERT (90 keys), its decoder over 490 keys at 16
queries, and refcoco_det's encoder at one, two and four levels (440^2,
2040^2, 8540^2, B=8), in bf16; flickr's encoder in float32. Key masks:
batch row b keeps its first Sk - (b * 7) % (Sk / 2) keys.
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
from reftr_torch.kernels.attention import _launch_dq, _launch_fwd  # noqa: E402

assert Path(reftr_torch.__file__).resolve().is_relative_to(
    Path(root).resolve()), reftr_torch.__file__
CALLERS = ("flash_attn_fwd_tc.cu", "flash_attn_fwd_wg.cu",
           "flash_attn_fwd_f32tc.cu", "flash_attn_bwd_dq_tc.cu",
           "flash_attn_bwd_dq_f32tc.cu", "flash_attn_bwd_dq_wg.cu")
SITES = {
    "flickr_encoder_490": ((16, 490, 490, 8, 32), torch.bfloat16),
    "flickr_encoder_2090": ((16, 2090, 2090, 8, 32), torch.bfloat16),
    "phrase_bert_22": ((256, 22, 22, 12, 64), torch.bfloat16),
    "sentence_bert_90": ((16, 90, 90, 12, 64), torch.bfloat16),
    "flickr_decoder_16x490": ((16, 16, 490, 8, 32), torch.bfloat16),
    "encoder_440": ((8, 440, 440, 8, 32), torch.bfloat16),
    "encoder_2040": ((8, 2040, 2040, 8, 32), torch.bfloat16),
    "encoder_8540": ((8, 8540, 8540, 8, 32), torch.bfloat16),
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
    out = {path: got for path, got in out.items() if got is not None}
    return out or {"": lines(base)}


def ms(fn, iters):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    for site, ((b, sq, sk, h, d), dt) in SITES.items():
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
            for variant in variants:
                fns[("K1", variant)] = (lambda variant=variant: _launch_fwd(
                    variant, q, k, v, valid, rate, seed, False)[0])
                if variant != "wg" or (csrc / "flash_attn_bwd_dq_wg.cu"
                                       ).exists():
                    fns[("K2", variant)] = (lambda variant=variant:
                                            _launch_dq(variant, *bwd))
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
            del out, lse, bwd, fns
        del q, k, v, do
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
