"""One rank of tests/test_torch_distributed.py's DDP runs on the CPU.

    python -m reftr_torch.tools.launch --nproc_per_node 2 -- \\
        python tests/torch_dist_worker.py SPEC.json

Each rank starts gloo from the launcher's variables
(``core/distributed.py::initialize``), runs the jobs SPEC names in order
and writes ``<out>/<job>_<rank>.pt`` for each. It imports no JAX: the test
module holds the results to JAX's.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from reftr_torch.cli.presets import preset_config  # noqa: E402
from reftr_torch.core import checkpoint as ckpt_lib  # noqa: E402
from reftr_torch.core import distributed  # noqa: E402
from reftr_torch.core.config import (BertConfig, DataConfig,  # noqa: E402
                                     LossConfig, ModelConfig, RefTRConfig,
                                     TrainConfig)
from reftr_torch.models.criterion import (compute_num_boxes,  # noqa: E402
                                          weight_dict)
from reftr_torch.nn import attention as nn_attention  # noqa: E402
from reftr_torch.nn.resnet import FrozenBatchNorm  # noqa: E402
from reftr_torch.train import steps as steps_mod  # noqa: E402
from reftr_torch.train.loop import (build_loaders,  # noqa: E402
                                    build_tokenizer, run_training)
from reftr_torch.train.state import TrainState  # noqa: E402
from reftr_torch.train.steps import make_train_step  # noqa: E402

CPU = torch.device("cpu")
# the micro RefTR of tests/test_torch_loop.py
MICRO = dict(enc_layers=1, dec_layers=1, dim_feedforward=32, hidden_dim=32,
             nheads=4, aux_loss=False, dtype="float32")
MICRO_DATA = dict(dataset="synthetic", train_split="train",
                  test_splits=("val",), img_size=32, max_img_size=32,
                  max_query_len=12, batch_size=8, num_workers=1,
                  synthetic_n=16)


def micro_model(dropout: float, **kw) -> ModelConfig:
    """The micro RefTR, or with ``kw`` another width, bert tiny; every
    dropout at ``dropout``."""
    bert = BertConfig.tiny()
    bert.hidden_dropout = bert.attention_dropout = dropout
    return ModelConfig(bert=bert, dropout=dropout, **dict(MICRO, **kw))


def micro_config(dropout: float, **train) -> RefTRConfig:
    return RefTRConfig(model=micro_model(dropout),
                       data=DataConfig(**MICRO_DATA),
                       train=TrainConfig(**dict(
                           lr=1e-3, warm_up_epoch=1,
                           lr_schedule="CosineWarmupLR", seed=0, **train)))


def half(tree: dict, rank: int, world: int) -> dict:
    n = len(next(iter(tree.values())))
    lo, hi = n * rank // world, n * (rank + 1) // world
    return {k: v[lo:hi] for k, v in tree.items()}


def job_step(spec: dict, rank: int, world: int) -> dict:
    """(a): one DDP train step on this rank's half of the batch, from the
    weights the test converted from JAX's."""
    cfg = micro_model(0.0, **spec["model"])
    data = np.load(spec["batch"])
    batch = {k[2:]: data[k] for k in data.files if k.startswith("b_")}
    targets = {k[2:]: data[k] for k in data.files if k.startswith("t_")}
    state = TrainState.create(cfg, TrainConfig(epochs=1), 1, device=CPU,
                              state_dict=torch.load(spec["state_dict"]))
    wd = weight_dict(LossConfig(), cfg.dec_layers, cfg.aux_loss)
    step = make_train_step(state.model, wd, LossConfig(), device=CPU)
    state, metrics = step(state, half(batch, rank, world),
                          half(targets, rank, world))
    return {"metrics": metrics.get(),
            "params": state.model.state_dict(),
            "grads": {n: p.grad for n, p in state.model.named_parameters()
                      if p.grad is not None}}


def job_num_boxes(spec: dict, rank: int, world: int) -> dict:
    """(b): compute_num_boxes of each case's rank block."""
    return {"num_boxes": [
        float(compute_num_boxes(torch.tensor(case[rank])))
        for case in spec["box_valid"]]}


def record_seeds(state, step, batch, targets, n_steps: int) -> list:
    """The seeds each of ``n_steps`` steps draws: the elementwise
    dropouts' and every attention's, in order."""
    drawn: list = []
    draw, fold = nn_attention._draw_seed, steps_mod.shard_seed

    def draw_recorded(b):
        drawn[-1].append(draw(b))
        return drawn[-1][-1]

    def fold_recorded(seed, shard, b):
        drawn[-1].append(fold(seed, shard, b))
        return drawn[-1][-1]

    nn_attention._draw_seed = draw_recorded
    steps_mod.shard_seed = fold_recorded
    try:
        for _ in range(n_steps):
            drawn.append([])
            state, _ = step(state, batch, targets)
    finally:
        nn_attention._draw_seed, steps_mod.shard_seed = draw, fold
    return drawn


def seed_run(out: str, rank: int, world: int) -> dict:
    """Two steps at dropout 0.1, then the second again from rank 0's
    checkpoint of the first: every seed each step drew."""
    cfg = micro_config(0.1, epochs=1)
    loader, _ = build_loaders(cfg, build_tokenizer(cfg), world, rank)
    batch, targets = next(iter(loader))
    targets = {k: v for k, v in targets.items() if k in ("boxes",
                                                          "box_valid")}
    wd = weight_dict(cfg.loss, cfg.model.dec_layers, cfg.model.aux_loss)

    def fresh():
        state = TrainState.create(cfg.model, cfg.train, 2, device=CPU)
        return state, make_train_step(state.model, wd, cfg.loss, device=CPU)

    state, step = fresh()
    straight = record_seeds(state, step, batch, targets, 1)
    if rank == 0:
        ckpt_lib.save_checkpoint(out, "seeds_checkpoint", state)
    straight += record_seeds(state, step, batch, targets, 1)
    distributed.barrier()
    state, step = fresh()
    payload = ckpt_lib.load_checkpoint(os.path.join(out, "seeds_checkpoint"))
    state.model.load_state_dict(payload["model"])
    state.restore(payload)
    resumed = record_seeds(state, step, batch, targets, 1)
    return {"straight": straight, "resumed": resumed}


def job_seeds(spec: dict, rank: int, world: int) -> dict:
    """(d)."""
    return seed_run(spec["out"], rank, world)


def job_presets(spec: dict, rank: int, world: int) -> dict:
    """(e): two DDP steps of each preset at tiny width; the losses, and
    whether every buffer is FrozenBatchNorm's and unchanged."""
    got = {}
    for name, overrides in spec["presets"].items():
        cfg = preset_config(name, **overrides)
        loader, _ = build_loaders(cfg, build_tokenizer(cfg), world, rank)
        state = TrainState.create(cfg.model, cfg.train, len(loader),
                                  device=CPU)
        wd = weight_dict(cfg.loss, cfg.model.dec_layers, cfg.model.aux_loss,
                         with_masks=cfg.model.masks)
        step = make_train_step(state.model, wd, cfg.loss, device=CPU)
        frozen = {id(b) for m in state.model.modules()
                  if isinstance(m, FrozenBatchNorm) for b in m.buffers()}
        buffers = {n: b.clone() for n, b in state.model.named_buffers()}
        losses = []
        for i, (batch, targets) in zip(range(2), loader):
            targets = {k: v for k, v in targets.items()
                       if k not in ("orig_size", "size", "image_id")}
            state, metrics = step(state, batch, targets)
            losses.append(metrics.get()["loss"])
        got[name] = {
            "losses": losses,
            "trainable": sum(p.requires_grad
                             for p in state.model.parameters()),
            "buffers_frozen_bn": all(id(b) in frozen
                                     for b in state.model.buffers()),
            "buffers_kept": all(torch.equal(b, buffers[n]) for n, b in
                                state.model.named_buffers())}
    return got


def job_run_training(spec: dict, rank: int, world: int) -> dict:
    """(c): run_training at dropout 0, ``batch_size`` a rank."""
    cfg = micro_config(0.0, epochs=spec["epochs"],
                       output_dir=spec["output_dir"])
    cfg.data.batch_size = spec["batch_size"]
    return run_training(cfg, device="cpu")


JOBS = {"step": job_step, "num_boxes": job_num_boxes, "seeds": job_seeds,
        "presets": job_presets, "run_training": job_run_training}


def main(path: str) -> int:
    torch.set_num_threads(1)
    with open(path) as f:
        spec = json.load(f)
    assert distributed.initialize(CPU)
    rank, world = distributed.rank(), distributed.world_size()
    assert torch.distributed.get_backend() == "gloo"
    for name, job_spec in spec["jobs"].items():
        result = JOBS[name](dict(job_spec, out=spec["out"]), rank, world)
        torch.save(result, os.path.join(spec["out"], f"{name}_{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
