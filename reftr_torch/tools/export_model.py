"""Serving export: the serving forward saved as a ``torch.export`` program
that loads and runs without the model code, the config system or the
checkpoint (port of reftr_tpu/tools/export_model.py).

The program is ``torch.export.export`` of the serving forward at a fixed
batch, traced under ``torch.no_grad()`` with the weights inside it, cast
to the compute dtype as ``serve.ServingModel`` casts them. Every attention
is one node of the registered op ``torch.ops.reftr.flash_attention_fwd``
(K1, ``kernels/attention.py``), so the loaded program runs the kernels on
the card and counts their launches as the live model does; a loader must
import ``reftr_torch.kernels.attention`` to register the op, which
``load_exported`` does (the manifest's ``requires``).

A difference from JAX: a ``jax.export`` artefact is lowered for a list of
platforms, and a CPU host can write one for a TPU. An exported torch
program holds tensors on the device it was traced on, so it is exported
on the device that will serve it: ``--export_platforms`` is exactly one
of ``cuda`` (the default) or ``cpu``, and raises for ``tpu`` or a list.

Artefact layout (``<out>/``):
  ``serving_fn.pt2`` -- ``torch.export.save`` of the program
  ``manifest.json``  -- JAX's keys (the inputs and outputs from the
                        graph's signature, the platform, the model's
                        flags, the batch size, the parameter count) with
                        ``format`` and ``torch_version`` in place of
                        ``jax.export.v*`` and ``jax_version``, and
                        ``requires``

CLI (every flag of ``cli.main`` plus the export's)::

    python -m reftr_torch.tools.export_model --preset refcoco_det \\
        --resume <checkpoint, reference .pth, or URL> --out exported/ \\
        [--export_batch 16] [--export_platforms cuda|cpu] [--selfcheck]

With ``--fold_bn`` and ``--fold_normalize`` (and the other backbone
folds) the program holds the folded weights (``nn/fold.py``; a standard
checkpoint is folded as it loads), and under ``--fold_normalize`` it takes
the uint8 canvases as they are; the manifest says which, under JAX's keys
``fold_bn`` and ``fold_normalize``. With ``--quantize_int8`` the program
is the int8 model (``nn/quant.py``), calibrated as JAX's export
calibrates it (one synthetic batch unless the caller gives batches,
``serve.serving_module``): its products are nodes of
``torch.ops.reftr.quantize_int8`` and ``torch.ops.reftr.int8_conv``
(``kernels/quant.py``), the manifest says ``quantize_int8: true`` and its
``requires`` adds that module.

Loading (deployment side)::

    from reftr_torch.tools.export_model import load_exported
    call, manifest = load_exported("exported/")
    out = call(batch)  # a dict of tensors on the manifest's device
"""

from __future__ import annotations

import importlib
import json
import os
import sys
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from reftr_torch.nn.quant import QUANT_MODULES

ARTIFACT_NAME = "serving_fn.pt2"
MANIFEST_NAME = "manifest.json"
# the modules a loader imports before torch.export.load: they register the
# ops the program calls (an int8 program's also INT8_REQUIRES)
REQUIRES = ("reftr_torch.kernels.attention",)
INT8_REQUIRES = ("reftr_torch.kernels.quant",)
# --selfcheck: the loaded program's pred_boxes against the live model's
# (JAX's limit)
SELFCHECK_TOL = 1e-5


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: np.dtype


def serving_batch_spec(cfg, batch_size: int) -> Dict[str, TensorSpec]:
    """The serving inputs' shapes and numpy dtypes, JAX's keys
    (reftr_tpu/tools/export_model.py:47-74): uint8 NHWC canvases and their
    validity masks, int32 token ids; multi-phrase (``cfg.data.multi_phrase``)
    adds the phrase tensors the model dispatches on (``"phrases" in
    batch``)."""
    d = cfg.data
    b, hw = batch_size, d.max_img_size
    s = d.max_sentence_len if d.multi_phrase else d.max_query_len
    i32 = np.dtype(np.int32)
    spec = {
        "image": TensorSpec((b, hw, hw, 3), np.dtype(np.uint8)),
        "image_valid": TensorSpec((b, hw, hw), np.dtype(np.bool_)),
        "sentence": TensorSpec((b, s), i32),
        "sentence_valid": TensorSpec((b, s), i32),
    }
    if d.multi_phrase:
        p, sp = d.max_num_phrases, d.phrase_seq_len
        spec.update({
            "phrases": TensorSpec((b, p, sp), i32),
            "phrase_valid": TensorSpec((b, p, sp), i32),
            "phrase_pos_l": TensorSpec((b, p), i32),
            "phrase_pos_r": TensorSpec((b, p), i32),
        })
    return spec


def example_batch(spec: Dict[str, TensorSpec]) -> Dict[str, np.ndarray]:
    """A well-formed batch of the spec's shapes: zero pixels, the whole
    image valid, [CLS] and one more token valid (the model's [CLS]/[SEP]
    context rule), and so in each phrase slot."""
    batch = {k: np.zeros(v.shape, v.dtype) for k, v in spec.items()}
    batch["image_valid"][:] = True
    batch["sentence_valid"][:, :2] = 1
    if "phrase_valid" in batch:
        batch["phrase_valid"][:, :, :2] = 1
        batch["phrase_pos_r"][:] = 1
    return batch


class _ServingForward(torch.nn.Module):
    """The model's forward with only the serving outputs kept: pred_boxes,
    and pred_masks and phrase_mask where the model gives them."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        out = self.model(batch)
        return {k: out[k] for k in ("pred_boxes", "pred_masks",
                                    "phrase_mask") if k in out}


def export_serving(model: torch.nn.Module, batch_spec: Dict[str, TensorSpec],
                   device: torch.device) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``model``'s serving forward (in eval mode,
    on ``device``, its weights inside the program) at the spec's shapes,
    under ``torch.no_grad()``. Eval draws no dropout seed, so the trace
    holds no host draw."""
    example = {k: torch.from_numpy(v).to(device)
               for k, v in example_batch(batch_spec).items()}
    with torch.no_grad():
        return torch.export.export(_ServingForward(model), (example,),
                                   strict=False)


def _signature_specs(exported: torch.export.ExportedProgram):
    """(inputs, outputs): each user input's and output's shape and dtype,
    from the graph's signature."""
    nodes = {n.name: n for n in exported.graph.nodes}
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = {a.name: a for a in out_node.args[0] if hasattr(a, "name")}

    def spec(node):
        val = node.meta["val"]
        return {"shape": list(val.shape),
                "dtype": str(val.dtype).removeprefix("torch.")}

    sig = exported.graph_signature
    return ([spec(nodes[n]) for n in sig.user_inputs],
            [spec(outs[n]) for n in sig.user_outputs])


def save_exported(exported: torch.export.ExportedProgram, out_dir: str,
                  extra_manifest: Optional[Dict] = None) -> Dict:
    """Write the program and its manifest; returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ARTIFACT_NAME)
    torch.export.save(exported, path)
    inputs, outputs = _signature_specs(exported)
    devices = {t.device.type for t in exported.state_dict.values()}
    manifest = {
        "format": "torch.export.save",
        "torch_version": torch.__version__,
        "platforms": sorted(devices),
        "artifact_bytes": os.path.getsize(path),
        "in_tree": str(exported.call_spec.in_spec),
        "inputs": inputs,
        "outputs": outputs,
        "requires": list(REQUIRES),
    }
    manifest.update(extra_manifest or {})
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def read_manifest(path: str) -> Dict:
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        return json.load(f)


def load_exported(path: str):
    """Load an exported program; returns ``(call, manifest)``. ``call`` is
    the program as a module: it takes the batch dict of tensors the model
    takes, on the manifest's device, and returns the serving outputs. It
    needs torch and the manifest's ``requires`` (the op's registration),
    not the model code, the flags or the checkpoint."""
    manifest = read_manifest(path)
    for module in manifest["requires"]:
        importlib.import_module(module)
    call = torch.export.load(os.path.join(path, ARTIFACT_NAME)).module()
    return call.requires_grad_(False), manifest


def export_device(platforms) -> torch.device:
    """The one device of ``platforms`` ("cuda" or "cpu", a string or a
    sequence of one): an exported torch program holds its tensors on the
    device it was traced on, so it cannot be lowered for several, or for a
    TPU, as a jax.export artefact can (ROADMAP.md's differences from
    JAX). "cuda" raises without a card (``core/device.resolve_device``)."""
    from reftr_torch.core.device import resolve_device

    names = ([platforms] if isinstance(platforms, str)
             else list(platforms))
    names = [p.strip() for n in names for p in n.split(",") if p.strip()]
    if len(names) != 1 or names[0] not in ("cuda", "cpu"):
        raise ValueError(
            f"--export_platforms {','.join(names)}: a torch program is tied "
            f"to the device it was traced on, so export one artefact for "
            f"each device, cuda or cpu (a jax.export artefact may name "
            f"several; ROADMAP.md, differences from JAX)")
    return resolve_device(names[0])


def _build_serving_model(cfg, resume: str, device: torch.device,
                         calib_batches=None,
                         print_fn=print) -> torch.nn.Module:
    """The model as ``ServingModel`` builds and loads it
    (``serve.serving_module``): seeded init, then ``resume`` through
    ``train.loop.load_pretrained`` (a URL, a reference ``.pth`` or the
    port's checkpoint), eval mode, the compute dtype; with
    ``quantize_int8`` calibrated on ``calib_batches`` and quantized."""
    from reftr_torch.serve import serving_module

    if not resume:
        print_fn("WARNING: no --resume checkpoint; exporting random "
                 "weights (smoke/bench export)")
    return serving_module(cfg, device, resume=resume,
                          calib_batches=calib_batches, print_fn=print_fn)


def export_with_config(cfg, resume: str, out_dir: str, batch_size: int,
                       platforms: Sequence[str] = ("cuda",),
                       calib_batches=None, print_fn=print
                       ) -> Tuple[torch.nn.Module,
                                  torch.export.ExportedProgram, Dict]:
    """Build the serving model of ``cfg`` (with ``quantize_int8``
    calibrated on ``calib_batches``, (batch, targets) pairs of numpy
    arrays), export it and save it. Returns (model, ExportedProgram,
    manifest): the live model, so that a caller can hold the artefact to
    it (JAX's returns the model and its params)."""
    device = export_device(platforms)
    model = _build_serving_model(cfg, resume, device, calib_batches,
                                 print_fn=print_fn)
    exported = export_serving(model, serving_batch_spec(cfg, batch_size),
                              device)
    manifest = save_exported(exported, out_dir, model_manifest(
        cfg, model, batch_size, resume))
    return model, exported, manifest


def model_manifest(cfg, model: torch.nn.Module, batch_size: int,
                   resume: str) -> Dict:
    """The manifest's keys of the model (JAX's,
    reftr_tpu/tools/export_model.py:205-217): its flags, the folds and
    int8 among them, the batch size, the parameter count (an int8 model's
    weights are buffers: counted too, as JAX's params hold them), the
    weights' source, and the modules whose ops the program calls."""
    mc = cfg.model
    return {
        "model": {
            "backbone": mc.backbone, "hidden_dim": mc.hidden_dim,
            "enc_layers": mc.enc_layers, "dec_layers": mc.dec_layers,
            "masks": mc.masks, "dtype": mc.dtype,
            "fold_bn": mc.fold_bn, "fold_normalize": mc.fold_normalize,
            "quantize_int8": mc.quantize_int8,
        },
        "batch_size": batch_size,
        "n_parameters": sum(p.numel() for p in model.parameters()) + sum(
            b.numel() for m in model.modules() if isinstance(m, QUANT_MODULES)
            for b in m.buffers()),
        "resume": resume or "",
        "requires": list(REQUIRES + (
            INT8_REQUIRES if mc.quantize_int8 or mc.quantize_train_prefix
            else ())),
    }


def random_batch(spec: Dict[str, TensorSpec], seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """--selfcheck's batch (JAX's main): random pixels, every pixel valid,
    token ids in [1, 100)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.integers(0, 255, size=v.shape).astype(np.uint8)
                if v.dtype == np.uint8 else
                np.ones(v.shape, v.dtype) if v.dtype == np.bool_ else
                rng.integers(1, 100, size=v.shape).astype(v.dtype))
            for k, v in spec.items()}


def selfcheck(call, model: torch.nn.Module, spec: Dict[str, TensorSpec],
              device: torch.device) -> float:
    """Max |exported - live| of pred_boxes on ``random_batch(spec)``."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in random_batch(spec).items()}
    with torch.no_grad():
        got = call(batch)["pred_boxes"].float()
        want = model(batch)["pred_boxes"].float()
    return float((got - want).abs().max())


def get_args_parser():
    from reftr_torch.cli.main import get_args_parser as base_parser

    p = base_parser()
    # the device is --export_platforms'; --device may only repeat it
    p.set_defaults(device=None)
    p.add_argument("--out", required=True,
                   help="output artefact directory")
    p.add_argument("--export_batch", type=int, default=64,
                   help="static batch size baked into the artefact")
    p.add_argument("--export_platforms", default="cuda",
                   help="the one device the program is traced on and "
                        "serves on: cuda or cpu")
    p.add_argument("--selfcheck", action="store_true",
                   help=f"after export, load the artefact and compare its "
                        f"pred_boxes with the live model's on one random "
                        f"batch (at most {SELFCHECK_TOL})")
    return p


def main(argv=None) -> int:
    from reftr_torch.cli.main import args_to_config
    from reftr_torch.cli.presets import apply_preset

    args = get_args_parser().parse_args(argv)
    if args.preset:
        apply_preset(args, args.preset, argv)
    device = export_device(args.export_platforms)
    if args.device is not None and torch.device(args.device).type \
            != device.type:
        raise ValueError(f"--device {args.device} and --export_platforms "
                         f"{args.export_platforms} disagree: the program is "
                         f"exported on the device it serves on")
    args.device = device.type
    cfg = args_to_config(args)
    model, _, manifest = export_with_config(
        cfg, cfg.train.resume, args.out, args.export_batch, (device.type,))
    print(json.dumps({k: manifest[k] for k in
                      ("platforms", "artifact_bytes", "batch_size",
                       "n_parameters")}))
    if args.selfcheck:
        call, _ = load_exported(args.out)
        err = selfcheck(call, model,
                        serving_batch_spec(cfg, args.export_batch), device)
        print(f"selfcheck: max |exported - live| = {err:.3e}")
        if not np.isfinite(err) or err > SELFCHECK_TOL:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
