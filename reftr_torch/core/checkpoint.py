"""Checkpoints by torch.save (port of reftr_tpu/core/checkpoint.py:1-123,
which is Orbax).

The reference's protocol (main_vg.py:298-349, 372-412): every epoch
``checkpoint``, ``checkpoint{epoch:04d}`` on lr_drop / ckpt_cycle
boundaries and ``checkpoint_best`` on the first test split's
accuracy_iou0.5, the config embedded as a dict. A checkpoint is one file
under ``output_dir`` holding ``model`` (the state dict, buffers
included), ``step``, ``epoch``, ``best_val_acc`` and ``config``, and for a
full checkpoint ``optimizer``, ``optimizer_params`` (the names of its
parameters in its order, so a resume can match them by name),
``scheduler`` and ``generator`` (the state's dropout generator). It is
written to a temporary name and renamed, so a run cut while saving leaves
the last whole checkpoint. Under tensor parallelism it holds one
process's full tensors, gathered from the ranks' slices, so it resumes
at any ``--mesh_model`` (``TrainState.load_model_state``, ``restore``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Union

import torch

from reftr_torch.core.config import RefTRConfig


def checkpoint_path(output_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(output_dir), name)


def checkpoint_payload(state, full: bool = True, epoch: int = 0,
                       best_val_acc: float = 0.0,
                       config: Optional[RefTRConfig] = None
                       ) -> Dict[str, Any]:
    """What a checkpoint of ``state`` (a ``TrainState``) holds: its model,
    step and, with ``full``, its optimizer, scheduler and generator, at
    one process's shapes (under tensor parallelism gathered over the
    model group, so every rank of it must call)."""
    payload: Dict[str, Any] = {
        "model": state.full_model_state(), "step": int(state.step),
        "epoch": int(epoch), "best_val_acc": float(best_val_acc),
        "config": dataclasses.asdict(config) if config is not None else None}
    if full:
        payload.update(optimizer=state.full_optimizer_state(),
                       optimizer_params=state.param_names(),
                       scheduler=state.scheduler.state_dict(),
                       generator=state.generator.get_state())
    return payload


def write_checkpoint(output_dir: str, name: str,
                     payload: Mapping[str, Any]) -> str:
    """Write ``payload`` under ``output_dir``/``name``; returns the path."""
    path = checkpoint_path(output_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(payload), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(output_dir: str, name: str, state,
                    full: bool = True, epoch: int = 0,
                    best_val_acc: float = 0.0,
                    config: Optional[RefTRConfig] = None) -> str:
    """Save ``state`` (a ``TrainState``) as ``checkpoint_payload`` gives
    it. Returns the path."""
    return write_checkpoint(output_dir, name, checkpoint_payload(
        state, full, epoch, best_val_acc, config))


def load_checkpoint(path: str,
                    map_location: Union[str, torch.device] = "cpu"
                    ) -> Dict[str, Any]:
    """The payload of a checkpoint file, its tensors on ``map_location``
    (the host unless the caller names a device)."""
    return torch.load(path, map_location=map_location, weights_only=False)


def checkpoint_exists(output_dir: str, name: str = "checkpoint") -> bool:
    return os.path.isfile(checkpoint_path(output_dir, name))


def load_pretrained_nonstrict(model: torch.nn.Module,
                              pretrained: Mapping[str, torch.Tensor],
                              log=print) -> Dict[str, list]:
    """Load the entries of ``pretrained`` whose name and shape ``model``
    has, and report the missing, unexpected and shape-mismatched names
    (main_vg.py:312-318)."""
    current = model.state_dict()
    report = {
        "missing": [k for k in current if k not in pretrained],
        "unexpected": [k for k in pretrained if k not in current],
        "shape_skipped": [k for k, v in pretrained.items()
                          if k in current and v.shape != current[k].shape]}
    skip = set(report["unexpected"]) | set(report["shape_skipped"])
    model.load_state_dict({k: v for k, v in pretrained.items()
                           if k not in skip}, strict=False)
    for what, label in (("missing", "Missing keys"),
                        ("unexpected", "Unexpected keys"),
                        ("shape_skipped", "Shape-mismatched keys skipped")):
        if report[what]:
            log(f"{label}: {report[what]}")
    return report
