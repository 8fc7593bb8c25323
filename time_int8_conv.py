"""Device time of the int8 conv kernel's variants at the 31 product shapes
of a refcoco_det forward (chip_smoke.INT8_SHAPES), each checked bit for bit
against ``int8_conv_plain`` before it is timed.

    python3 time_int8_conv.py [--batches 8,64] [--dtypes bfloat16,float32]
                              [--tc main|all|none]

For each batch size, output dtype and shape it prints one JSON line: the
device ms a call (CUDA events around 20 calls queued behind a sleep kernel,
``chip_smoke.queued_ms``) of "wg" at each tile width it takes
(``kernels/quant.py::WG_TILES``) and at the width ``int8_conv_tile``
picks, of "tc" (at every shape with ``--tc all``, at the VL encoder's FFN
dense and layer3's 3x3 with ``main``), the bound
(``chip_smoke.int8_conv_bound``) and the yardstick: ``torch._int_mm`` at a
dense of more than 16 rows (the int32 product alone), cuDNN's bf16
convolution at a conv shape (another function). Then, for each batch and
dtype, one line of sums over a forward's 220 products (each shape times
its calls): the route's, the fastest width's, "tc"'s where timed, the
bound and the yardstick. It needs a CUDA card; the kernels are built from
this checkout's sources on first use. The card's name and power limit
come first.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from reftr_torch.kernels import quant as kq  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the shapes "tc" is timed at with --tc main: phase 14a's (the VL
# encoder's first FFN dense and layer3's 3x3 convolution at stride 1)
TC_MAIN = {cs.INT8_TIMED[name] for name in cs.INT8_TC_TIMED}


def geometry(shape):
    """(n, h, w, c, cout, k, stride, dilation) of a product shape."""
    if shape[0] == "conv":
        return shape[1:]
    _, m, k, n = shape
    return (m, 1, 1, k, n, 1, 1, 1)


def time_shape(gen, shape, calls, dtype, tc: bool) -> dict:
    x, w, ws, scale, bias, geo, _ = cs.int8_inputs(gen, shape, torch.bfloat16)
    want = kq.int8_conv_plain(x, w, ws, scale, bias, *geo, dtype)
    runs = {}
    for bn in kq.WG_TILES:
        runs[f"wg{bn}"] = lambda bn=bn: kq._launch_conv(
            "wg", x, w, ws, scale, bias, *geo, dtype, bn=bn)
    if tc:
        runs["tc"] = lambda: kq._launch_conv("tc", x, w, ws, scale, bias,
                                             *geo, dtype)
    row = {"shape": list(shape), "calls": calls, "dtype": str(dtype)[6:],
           "variant": kq.int8_conv_variant(*geometry(shape), dtype),
           "tile": kq.int8_conv_tile(*geometry(shape), dtype)}
    for name, fn in runs.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} at {shape} {dtype} differs from "
                                 f"int8_conv_plain")
        row[f"{name}_ms"] = cs.queued_ms(fn, iters=cs.INT8_TIME_ITERS)
    row["route_ms"] = row[f"wg{row['tile']}_ms"]
    row["best_tile"] = min(kq.WG_TILES,
                           key=lambda bn: row[f"wg{bn}_ms"])
    esize = 2 if dtype == torch.bfloat16 else 4
    row["bound_ms"], row["bound_by"] = cs.bound_pick(
        cs.int8_conv_bound(shape, esize))
    if shape[0] == "dense" and shape[1] > 16:
        a2, wt = x.view(shape[1], shape[2]), w.t()
        row["library"] = "torch._int_mm"
        row["library_ms"] = cs.queued_ms(lambda: torch._int_mm(a2, wt),
                                         iters=cs.INT8_TIME_ITERS)
    elif shape[0] == "conv":
        k, s, d = geo
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = w.view(shape[5], k, k, shape[4]).permute(0, 3, 1, 2).to(
            torch.bfloat16)
        row["library"] = "cuDNN bf16 conv2d"
        row["library_ms"] = cs.queued_ms(lambda: F.conv2d(
            xb, wb, stride=s, padding=d * (k - 1) // 2, dilation=d),
            iters=cs.INT8_TIME_ITERS)
    else:
        row["library"], row["library_ms"] = None, None
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="8,64")
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--tc", choices=("main", "all", "none"), default="main")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_int8_conv.py needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0x14A)
    for batch in (int(b) for b in args.batches.split(",")):
        for dname in args.dtypes.split(","):
            dtype = DTYPES[dname]
            rows = []
            for shape, calls in cs.INT8_SHAPES.items():
                big = cs.scaled(shape, batch // cs.SERVE_BATCH)
                tc = args.tc == "all" or (args.tc == "main"
                                          and shape in TC_MAIN)
                row = time_shape(gen, big, calls, dtype, tc)
                row.update({"batch": batch, "card": card})
                rows.append(row)
                print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()
            total = {"batch": batch, "dtype": dname, "card": card,
                     "products": sum(r["calls"] for r in rows)}
            for key in ("route_ms", "bound_ms"):
                total[key] = sum(r["calls"] * r[key] for r in rows)
            total["best_ms"] = sum(
                r["calls"] * r[f"wg{r['best_tile']}_ms"] for r in rows)
            for kind in ("conv", "dense"):
                mine = [r for r in rows if r["shape"][0] == kind]
                total[f"{kind}_route_ms"] = sum(r["calls"] * r["route_ms"]
                                                for r in mine)
                lib = [r for r in mine if r["library_ms"] is not None]
                total[f"{kind}_library_ms"] = sum(
                    r["calls"] * r["library_ms"] for r in lib)
                total[f"{kind}_route_ms_where_library"] = sum(
                    r["calls"] * r["route_ms"] for r in lib)
            timed_tc = [r for r in rows if "tc_ms" in r]
            if len(timed_tc) == len(rows):
                total["tc_ms"] = sum(r["calls"] * r["tc_ms"] for r in rows)
            print(json.dumps({"total": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
