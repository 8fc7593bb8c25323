"""One rank of tests/test_torch_tensor_parallel.py's runs on the CPU.

    python -m reftr_torch.tools.launch --nproc_per_node 4 -- \\
        python tests/torch_tp_worker.py SPEC.json

Four ranks start gloo from the launcher's variables and run SPEC's
``mesh22`` jobs on a (data 2, model 2) mesh; then they leave that group,
and ranks 0-1 and 2-3 start a group of two each (ports ``port_a`` and
``port_b``), a (data 1, model 2) mesh, and run ``mesh12_a`` and
``mesh12_b`` (model-major, ``model_spans_processes``); the int8 jobs
(j)-(l) run on these meshes too. Each job writes
``<out>/<job>_<rank>.pt``. It imports no JAX: the test module holds the
results to JAX's and to one process.
"""

import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from reftr_torch.cli.presets import preset_config  # noqa: E402
from reftr_torch.core import checkpoint as ckpt_lib  # noqa: E402
from reftr_torch.core import distributed  # noqa: E402
from reftr_torch.convert import model_class  # noqa: E402
from reftr_torch.core.config import (LossConfig, MeshConfig,  # noqa: E402
                                     RefTRConfig, TrainConfig)
from reftr_torch.kernels.attention import flash_attention  # noqa: E402
from reftr_torch.models.criterion import weight_dict  # noqa: E402
from reftr_torch.nn import attention as nn_attention  # noqa: E402
from reftr_torch.nn import quant  # noqa: E402
from reftr_torch.parallel.sharding import (create_mesh,  # noqa: E402
                                           gather_state_dict, shard_dim)
from reftr_torch.train.loop import (build_loaders,  # noqa: E402
                                    build_tokenizer, run_training)
from reftr_torch.train.state import TrainState  # noqa: E402
from reftr_torch.train.steps import make_train_step  # noqa: E402
from torch_dist_worker import micro_config, micro_model  # noqa: E402

CPU = torch.device("cpu")


def load_batch(path: str):
    data = np.load(path)
    batch = {k[2:]: data[k] for k in data.files if k.startswith("b_")}
    targets = {k[2:]: data[k] for k in data.files if k.startswith("t_")}
    return batch, targets


def rows(tree: dict, mesh) -> dict:
    """The mesh's data row's block of a batch."""
    n = len(next(iter(tree.values())))
    lo = n * mesh.data_index // mesh.data
    hi = n * (mesh.data_index + 1) // mesh.data
    return {k: v[lo:hi] for k, v in tree.items()}


def coords(mesh) -> dict:
    return {"data_index": mesh.data_index, "model_index": mesh.model_index,
            "shard": mesh.shard, "grid": mesh.grid}


def tp_state(cfg, mesh, train_cfg=None, state_dict=None):
    state = TrainState.create(cfg, train_cfg or TrainConfig(epochs=1), 1,
                              device=CPU, state_dict=state_dict, mesh=mesh)
    wd = weight_dict(LossConfig(), cfg.dec_layers, cfg.aux_loss,
                     with_masks=cfg.masks)
    return state, make_train_step(state.model, wd, LossConfig(), device=CPU,
                                  mesh=mesh)


def gathered_grads(state) -> dict:
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}
    return gather_state_dict(grads, state.mesh)


def job_step(spec: dict, mesh) -> dict:
    """(a): one tensor-parallel step on this data row's block of the batch,
    from the weights the test converted from JAX's; the gradients and the
    parameters gathered to one process's shapes."""
    cfg = micro_model(0.0, **spec["model"])
    batch, targets = load_batch(spec["batch"])
    state, step = tp_state(cfg, mesh,
                           state_dict=torch.load(spec["state_dict"]))
    state, metrics = step(state, rows(batch, mesh), rows(targets, mesh))
    return {"metrics": metrics.get(), "grads": gathered_grads(state),
            "params": state.full_model_state(), **coords(mesh)}


def job_attention(spec: dict, mesh) -> dict:
    """(b): the kernels' entry point on this rank's block: its data row's
    batch rows and its model index's heads of q, k and v."""
    data = np.load(spec["inputs"])
    q, k, v, valid = (torch.from_numpy(data[n]) for n in ("q", "k", "v",
                                                           "valid"))
    h = q.shape[2] // mesh.model
    heads = slice(mesh.model_index * h, (mesh.model_index + 1) * h)
    b = q.shape[0] // mesh.data
    batch = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    out = flash_attention(q[batch, :, heads], k[batch, :, heads],
                          v[batch, :, heads], valid[batch])
    return {"out": out, "batch": (batch.start, batch.stop),
            "heads": (heads.start, heads.stop), **coords(mesh)}


def replicated_digest(state) -> dict:
    """sha256 of every replicated parameter of this rank."""
    return {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
            for n, p in state.model.named_parameters()
            if shard_dim(n) is None}


def job_dropout(spec: dict, mesh) -> dict:
    """(g): steps at dropout 0.1 from a seeded init: every seed folded by
    ``shard_seed`` (the raw draw, the shard, the local batch, the fold),
    and each replicated parameter's digest after the steps."""
    cfg = micro_config(0.1, epochs=1)
    batch, targets = load_batch(spec["batch"])
    state, step = tp_state(cfg.model, mesh)
    folds, fold = [], nn_attention.shard_seed

    def recorded(seed, shard, b):
        folds.append((seed, shard, b, fold(seed, shard, b)))
        return folds[-1][-1]

    nn_attention.shard_seed = recorded
    try:
        losses = [step(state, rows(batch, mesh), rows(targets, mesh))[1]
                  .get()["loss"] for _ in range(spec["steps"])]
    finally:
        nn_attention.shard_seed = fold
    return {"folds": folds, "losses": losses,
            "digests": replicated_digest(state), **coords(mesh)}


def job_presets(spec: dict, mesh) -> dict:
    """(h): two tensor-parallel steps of each preset at tiny width on its
    data row's shard of the fixture."""
    got = {}
    for name, overrides in spec["presets"].items():
        cfg = preset_config(name, **overrides)
        loader, _ = build_loaders(cfg, build_tokenizer(cfg), mesh.data,
                                  mesh.data_index)
        state, step = tp_state(cfg.model, mesh, cfg.train)
        losses = []
        for _, (batch, targets) in zip(range(2), loader):
            targets = {k: v for k, v in targets.items()
                       if k not in ("orig_size", "size", "image_id")}
            losses.append(step(state, batch, targets)[1].get()["loss"])
        got[name] = {"losses": losses, "digests": replicated_digest(state),
                     "sharded": sum(hasattr(p, "model_parallel_dim")
                                    for p in state.model.parameters())}
    return {"presets": got, **coords(mesh)}


def job_checkpoint(spec: dict, mesh) -> dict:
    """(e): a step, a checkpoint of it (gathered; rank 0 writes), the next
    step's loss; and from one process's checkpoint of its first step, the
    next step on this mesh."""
    cfg = micro_model(0.0)
    (b1, t1), (b2, t2) = (load_batch(spec[k]) for k in ("batch1", "batch2"))
    state, step = tp_state(cfg, mesh)
    step(state, b1, t1)
    payload = ckpt_lib.checkpoint_payload(state, epoch=0)
    if distributed.is_main_process():
        ckpt_lib.write_checkpoint(spec["out"], "tp_checkpoint", payload)
    straight = step(state, b2, t2)[1].get()["loss"]
    dist.barrier()
    state, step = tp_state(cfg, mesh)
    one = ckpt_lib.load_checkpoint(spec["one_checkpoint"])
    state.load_model_state(one["model"])
    state.restore(one)
    resumed = step(state, b2, t2)[1].get()["loss"]
    return {"straight": straight, "resumed_from_one": resumed,
            "local_shapes": {n: tuple(t.shape)
                             for n, t in state.model.state_dict().items()},
            **coords(mesh)}


def job_run_training(spec: dict, mesh) -> dict:
    """(f): run_training on a model axis of 2 (the mesh of the config)."""
    cfg = micro_config(0.0, epochs=spec["epochs"],
                       output_dir=spec["output_dir"])
    cfg.data.batch_size = spec["batch_size"]
    cfg.mesh = MeshConfig(model=2, model_spans_processes=spec["spans"])
    return run_training(cfg, device="cpu")


def calib_leaves(tree: dict, prefix: str = "") -> dict:
    """A calibration tree's leaves by their "/"-joined path."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(calib_leaves(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = float(value)
    return out


def quiet(*_args) -> None:
    pass


def job_int8_calib(spec: dict, mesh) -> dict:
    """(j): int8 eval's calibration on the tensor-parallel fp model, each
    data row on its block of the batch: the absmax tree (max-reduced over
    every rank) and ``calibrate_and_quantize``'s int8 weights of the fp
    weights gathered to one process's shapes."""
    cfg = micro_model(0.0, **spec["model"])
    batch, targets = load_batch(spec["batch"])
    loader = [(rows(batch, mesh), rows(targets, mesh))]
    state, _ = tp_state(cfg, mesh, state_dict=torch.load(spec["state_dict"]))
    mc = dataclasses.replace(cfg, quantize_int8=True)
    absmax, _, _ = quant._calibrate(
        state.model, quant.quant_targets(model_class(mc), mc), loader, 1,
        CPU, autocast=False)
    qweights = quant.calibrate_and_quantize(
        RefTRConfig(model=cfg), state.model, loader, n_batches=1,
        print_fn=quiet, state_dict=state.full_model_state())
    return {"absmax": calib_leaves(absmax), "qweights": qweights,
            **coords(mesh)}


def job_int8_prefix(spec: dict, mesh) -> dict:
    """(k): ``--quantize_train_prefix`` as the loop runs it on a model
    axis: layer1 calibrated on the tensor-parallel fp model, the state
    dict gathered to one process's shapes and sharded again, then steps;
    the metrics, the first step's gathered gradients (AdamW's first update
    can move a parameter by up to its LR where its gradient is at rounding
    level, so later steps' gradients part further) and the digest of each
    of layer1's int8 leaves."""
    cfg = micro_model(0.0, **spec["model"])
    pcfg = dataclasses.replace(cfg, quantize_train_prefix=True)
    batch, targets = load_batch(spec["batch"])
    state, _ = tp_state(cfg, mesh, state_dict=torch.load(spec["state_dict"]))
    prefix = quant.calibrate_train_prefix(
        RefTRConfig(model=pcfg), state.model, [(batch, targets)],
        n_batches=1, print_fn=quiet)
    state, step = tp_state(pcfg, mesh,
                           state_dict=gather_state_dict(prefix, state.mesh))
    metrics = [step(state, batch, targets)[1].get()]
    grads = {n: g.clone() for n, g in gathered_grads(state).items()}
    metrics += [step(state, batch, targets)[1].get()
                for _ in range(spec["steps"] - 1)]
    layer1 = {n: hashlib.sha256(t.numpy().tobytes()).hexdigest()
              for n, t in state.model.img_backbone.layer1.state_dict().items()}
    return {"metrics": metrics, "grads": grads, "layer1": layer1,
            **coords(mesh)}


def job_int8_runs(spec: dict, mesh) -> dict:
    """(l): the entry point's int8 routes on a model axis of 2:
    ``--eval --quantize_int8 --fold_bn`` of the seeded init, and a
    ``--quantize_train_prefix --fold_bn`` run."""
    out = {}
    for name, (model, train) in spec["runs"].items():
        cfg = micro_config(0.0, **train)
        cfg.model = dataclasses.replace(cfg.model, **model)
        cfg.mesh = MeshConfig(model=2, model_spans_processes=spec["spans"])
        out[name] = run_training(cfg, device="cpu")
    return {**out, **coords(mesh)}


JOBS = {"step": job_step, "attention": job_attention,
        "dropout": job_dropout, "presets": job_presets,
        "checkpoint": job_checkpoint, "run_training": job_run_training,
        "int8_calib": job_int8_calib, "int8_prefix": job_int8_prefix,
        "int8_runs": job_int8_runs}


def run_jobs(spec: dict, phase: str, mesh_cfg: MeshConfig) -> None:
    mesh = create_mesh(mesh_cfg)
    for job, job_spec in spec[phase].items():
        t0 = time.perf_counter()
        result = JOBS[job](dict(job_spec, out=spec["out"]), mesh)
        torch.save(result, os.path.join(
            spec["out"], f"{phase}.{job}_{distributed.rank()}.pt"))
        print(f"rank {distributed.rank()} {phase}.{job}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(path: str) -> int:
    torch.set_num_threads(1)
    with open(path) as f:
        spec = json.load(f)
    assert distributed.initialize(CPU)
    rank = distributed.rank()
    assert distributed.world_size() == 4
    run_jobs(spec, "mesh22", MeshConfig(data=2, model=2))
    dist.destroy_process_group()
    pair, port = ("a", spec["port_a"]) if rank < 2 else ("b", spec["port_b"])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank % 2)
    run_jobs(spec, f"mesh12_{pair}",
             MeshConfig(model=2, model_spans_processes=pair == "b"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
