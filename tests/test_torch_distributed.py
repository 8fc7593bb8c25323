"""reftr_torch's DDP path on the CPU: two gloo processes through
``reftr_torch.tools.launch`` (tests/torch_dist_worker.py), held to JAX's
data-parallel step and to one process.

The micro RefTR of tests/test_torch_loop.py (bert tiny, ResNet-50 at 32 px,
1+1 VL layers, d=32). One launch of two ranks runs every job:

- (a) the slice against JAX: each rank takes one train step on its half of
  a batch of 4 at 64 px (one row without a valid box, so the ranks' box
  counts differ) from the weights of ``convert.from_flax`` of JAX's, at
  dropout 0; JAX's ``make_train_step(..., world_size=2)`` takes the whole
  batch. The mean of the ranks' losses, the clip norm, every gradient and
  updated parameter agree at tests/test_torch_train.py's tolerances, on
  that test's model (2+2 VL layers, d=64, aux losses): at the micro width
  one process's step on this batch is already off JAX's by up to 4.7e-3
  of a layer2 gradient's largest magnitude (ROADMAP.md queue 3), so the
  micro width could not tell DDP's error from that;
- (b) ``compute_num_boxes`` times the world size is JAX's
  ``compute_num_boxes(global box_valid, 2)`` (DDP averages the ranks'
  gradients), the clamp cases included;
- (c) ``run_training`` with a global batch of the whole synthetic train
  split (8 a rank, 16 in one process: both layouts see the same global
  batches; tests/test_multiprocess.py's trick) logs the one-process run's
  train_loss within 1e-4 relative, its accuracy_iou0.5 and its miou within
  1e-4 (only the order of float sums differs); rank 0 alone writes the
  log, the checkpoint and the result file;
- (d) rank 0's attention and dropout seeds are one process's, rank 1's
  differ, all in [0, 2^63), and a resume from rank 0's checkpoint draws
  on each rank what it would have drawn without the stop;
- (e) two DDP steps of refcoco_det, refcoco_seg (--freeze_reftr) and
  flickr at tiny width run without DDP's unused-parameter error, and the
  only buffers, FrozenBatchNorm's, stay as they were.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_dist_worker as worker
from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import LossConfig as JaxLossConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_tpu.models import criterion as jax_criterion
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_tpu.train import schedules as jax_schedules
from reftr_tpu.train.optimizer import build_optimizer, label_fn
from reftr_tpu.train.state import TrainState as JaxTrainState
from reftr_tpu.train.steps import make_train_step as jax_train_step
from reftr_torch.convert import flax_leaf_to_torch, from_flax
from reftr_torch.core.config import TrainConfig
from reftr_torch.kernels.attention import SEED_BITS
from reftr_torch.train.loop import run_training
from torch_parity_utils import random_flax_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LAUNCH_TIMEOUT = 240  # s, from the start of both ranks to their end
CLIP = 0.1
ADAM_EPS = 1e-8
# (a): tests/test_torch_train.py's model
STEP_MODEL = dict(enc_layers=2, dec_layers=2, dim_feedforward=64,
                  hidden_dim=64, nheads=4, aux_loss=True)
# (e): each preset at tiny width on its synthetic fixture, 2 steps a rank
TINY = dict(enc_layers=1, dec_layers=1, dim_feedforward=32, hidden_dim=32,
            nheads=4, bert_size="tiny", img_size=32, max_img_size=32,
            batch_size=2, num_workers=1, synthetic_n=8, dataset="synthetic",
            train_split="train", test_split=["val"], dtype="float32")
PRESETS = {
    "refcoco_det": TINY,
    # GroupNorm(8) of the mask head needs d=128 and 8 heads
    "refcoco_seg": dict(TINY, hidden_dim=128, nheads=8, freeze_reftr=True),
    "flickr": dict(TINY, dataset="synthetic_multi"),
}
# (b): each case's box_valid, one block a rank
NUM_BOXES = [
    [[[True], [True]], [[True], [False]]],
    [[[True], [False]], [[False], [False]]],  # global 1 < world: clamp
    [[[False], [False]], [[False], [False]]],
    [[[False], [False]], [[True], [True]]],  # rank 0 has none
    [[[True, True, False]], [[True, False, False]]],  # multi-phrase rows
]


def micro_batch():
    """4 rows at 64 px: padded images and sentences, row 3 without a
    valid box. At 32 px ResNet-50's output is one pixel, where the input
    projection's GroupNorm normalises groups of one element: JAX's
    gradient of the projection and the backbone is then exactly zero,
    the port's rounding noise amplified by GroupNorm's 1/sqrt(eps), and
    the comparison would hold neither to anything."""
    rng = np.random.default_rng(0)
    b, hw, s = 4, 64, 12
    sentence_valid = np.zeros((b, s), np.int32)
    for i, n in enumerate((7, 12, 5, 9)):
        sentence_valid[i, :n] = 1
    image_valid = np.zeros((b, hw, hw), bool)
    image_valid[0, :48, :] = True
    image_valid[1, :, :40] = True
    image_valid[2] = True
    image_valid[3, :32, :32] = True
    batch = {
        "image": rng.integers(0, 256, (b, hw, hw, 3)).astype(np.uint8),
        "image_valid": image_valid,
        "sentence": rng.integers(1, 512, (b, s)).astype(np.int32),
        "sentence_valid": sentence_valid,
    }
    centre = rng.uniform(0.3, 0.7, (b, 1, 2))
    size = rng.uniform(0.2, 0.4, (b, 1, 2))
    targets = {"boxes": np.concatenate([centre, size], -1).astype(
                   np.float32),
               "box_valid": np.array([[True], [True], [True], [False]])}
    return batch, targets


def jax_config() -> JaxModelConfig:
    bert = JaxBertConfig.tiny()
    bert.hidden_dropout = bert.attention_dropout = 0.0
    return JaxModelConfig(bert=bert, dropout=0.0,
                          **dict(worker.MICRO, **STEP_MODEL))


@pytest.fixture(scope="module")
def jax_params():
    return random_flax_params(JaxRefTR(jax_config()), micro_batch()[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(jax_params, tmp_path_factory):
    """The two ranks, started on every job (their weights are JAX's
    params converted), while JAX's step compiles: (process, out dir,
    jobs)."""
    out = tmp_path_factory.mktemp("ddp")
    jcfg = jax_config()
    pcfg = worker.micro_model(0.0, **STEP_MODEL)
    assert dataclasses.asdict(pcfg.bert) == {
        k: v for k, v in dataclasses.asdict(jcfg.bert).items()
        if k in dataclasses.asdict(pcfg.bert)}
    torch.save(from_flax(jax_params, pcfg), out / "weights.pt")
    batch, targets = micro_batch()
    np.savez(out / "batch.npz", **{f"b_{k}": v for k, v in batch.items()},
             **{f"t_{k}": v for k, v in targets.items()})
    jobs = {
        "step": {"state_dict": str(out / "weights.pt"),
                 "batch": str(out / "batch.npz"), "model": STEP_MODEL},
        "num_boxes": {"box_valid": NUM_BOXES},
        "seeds": {},
        "presets": {"presets": PRESETS},
        "run_training": {"epochs": 2, "batch_size": 8,
                         "output_dir": str(out / "train")},
    }
    path = out / "spec.json"
    path.write_text(json.dumps({"jobs": jobs, "out": str(out)}))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS"):
        env.pop(k, None)
    with open(out / "stdout.txt", "w") as so, open(out / "stderr.txt",
                                                   "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", "reftr_torch.tools.launch",
             "--nproc_per_node", str(WORLD), "--coordinator_port",
             str(_free_port()), "--", sys.executable,
             os.path.join(REPO, "tests", "torch_dist_worker.py"), str(path)],
            cwd=REPO, env=env, stdout=so, stderr=se)
    yield proc, out, jobs
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_step(jax_params, launched):
    """JAX's step at world_size=2 on the whole batch: (params, new params,
    metrics, clip norm, masked gradients)."""
    jcfg = jax_config()
    model = JaxRefTR(jcfg)
    batch, targets = micro_batch()
    params = jax_params
    tc = JaxTrainConfig(epochs=1)
    tx = build_optimizer(jcfg, tc, jax_schedules.build_schedule(tc, 1))
    wd = jax_criterion.weight_dict(JaxLossConfig(), jcfg.dec_layers,
                                   jcfg.aux_loss)
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(1))
    step = jax_train_step(model, wd, JaxLossConfig(), world_size=WORLD,
                          donate=False)
    new_state, metrics = step(state, batch, targets)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        out = model.apply({"params": p}, jbatch, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_criterion.total_loss(jax_criterion.criterion(
            out, targets, JaxLossConfig(), WORLD), wd)

    grads = jax.jit(jax.grad(loss_fn))(params)
    labels = label_fn(jcfg, tc)(params)
    masked = jax.tree_util.tree_map(lambda g, lab: g * (lab != "frozen"),
                                    grads, labels)
    return {"new_params": jax.device_get(new_state.params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "clip_norm": float(optax.global_norm(masked)),
            "grads": flatten_dict(jax.device_get(masked))}


@pytest.fixture(scope="module")
def ranks(launched):
    """Every job's result on each rank: {job: [rank 0's, rank 1's]}."""
    proc, out, jobs = launched
    rc = proc.wait(timeout=LAUNCH_TIMEOUT)
    assert rc == 0, (out / "stderr.txt").read_text()[-6000:]
    got = {name: [torch.load(out / f"{name}_{r}.pt", weights_only=False)
                  for r in range(WORLD)] for name in jobs}
    got["out"] = out
    got["stdout"] = (out / "stdout.txt").read_text()
    return got


def test_two_ranks_step_matches_jax_world_size_2(jax_step, ranks):
    r0, r1 = ranks["step"]
    want = jax_step["metrics"]
    for key in ("loss", "loss_bbox", "loss_giou", "loss_bbox_0",
                "loss_giou_0"):
        got = (r0["metrics"][key] + r1["metrics"][key]) / WORLD
        np.testing.assert_allclose(got, want[key], rtol=1e-5, err_msg=key)
    # the ranks' own losses differ: they are not the global one
    assert r0["metrics"]["loss"] != r1["metrics"]["loss"]
    assert r0["metrics"]["grad_norm"] == r1["metrics"]["grad_norm"]
    np.testing.assert_allclose(r0["metrics"]["grad_norm"],
                               jax_step["clip_norm"], rtol=1e-4)


def test_two_ranks_gradients_and_params_match_jax(jax_step, ranks):
    r0, r1 = ranks["step"]
    pcfg = worker.micro_model(0.0, **STEP_MODEL)
    coef = CLIP / max(jax_step["clip_norm"], CLIP)
    gmax = coef * max(np.abs(g).max() for g in jax_step["grads"].values())
    compared = 0
    for path, g in jax_step["grads"].items():
        name, want = flax_leaf_to_torch(path, np.asarray(g) * coef)
        if name not in r0["grads"]:  # frozen, or FrozenBN's buffers
            assert not want.any(), name
            continue
        # DDP's average is the same on both ranks, clipped in place
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
        err = np.abs(r0["grads"][name].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-6 * gmax, name
        compared += 1
    assert compared == len(r0["grads"]) > 100
    want = from_flax(jax_step["new_params"], pcfg)
    grads = dict(flax_leaf_to_torch(p, np.abs(np.asarray(g)) * coef)
                 for p, g in jax_step["grads"].items())
    lr = TrainConfig().lr
    for name, got in r0["params"].items():
        assert torch.equal(got, r1["params"][name]), name
        err = np.abs(got.numpy() - want[name].numpy())
        if name in grads:
            big = grads[name] > 100 * ADAM_EPS
            assert (err[big] <= 1e-6).all(), name
            assert err.max() <= 2 * lr, name
        else:
            assert err.max() == 0.0, name


@pytest.mark.parametrize("case", range(len(NUM_BOXES)))
def test_num_boxes_matches_jax(ranks, case):
    blocks = NUM_BOXES[case]
    want = float(jax_criterion.compute_num_boxes(
        jnp.asarray(np.concatenate(blocks)), WORLD))
    for r in range(WORLD):
        assert ranks["num_boxes"][r]["num_boxes"][case] * WORLD == want


def single_process_run(out):
    cfg = worker.micro_config(0.0, epochs=2, output_dir=str(out))
    cfg.data.batch_size = 8 * WORLD
    return run_training(cfg, device="cpu")


def test_run_training_two_processes_match_one(ranks, tmp_path):
    one = single_process_run(tmp_path)["history"]
    two = [ranks["run_training"][r]["history"] for r in range(WORLD)]
    assert "backend gloo, world size 2" in ranks["stdout"]
    with open(ranks["out"] / "train" / "log.txt") as f:
        logged = [json.loads(x) for x in f]
    assert len(logged) == len(one) == 2
    for got, r0, r1, want in zip(logged, two[0], two[1], one):
        assert got == r0
        # the stats are the global ones on every rank
        assert {k: v for k, v in r1.items() if k != "epoch_time"} == {
            k: v for k, v in got.items() if k != "epoch_time"}
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-4)
        assert got["test_val_accuracy_iou0.5"] == want[
            "test_val_accuracy_iou0.5"]
        assert got["test_val_miou"] == pytest.approx(want["test_val_miou"],
                                                     rel=1e-4)
    assert sorted(os.listdir(ranks["out"] / "train")) == sorted(
        os.listdir(tmp_path))
    with open(ranks["out"] / "train" / "synthetic_val_result.json") as f:
        boxes = json.load(f)
    with open(tmp_path / "synthetic_val_result.json") as f:
        want_boxes = json.load(f)
    assert sorted(boxes) == sorted(want_boxes)


def test_rank_seeds(ranks, tmp_path):
    one = worker.seed_run(str(tmp_path), 0, 1)
    r0, r1 = ranks["seeds"]
    assert r0["straight"] == one["straight"]
    # the elementwise dropouts' seed, then 5 attentions: BERT's 2 layers,
    # the encoder's, the decoder's self- and cross-attention
    assert [len(step) for step in one["straight"]] == [6, 6]
    for a, b in zip(r0["straight"], r1["straight"]):
        assert len(a) == len(b)
        assert all(x != y for x, y in zip(a, b))
    for r in (r0, r1):
        seeds = [s for step in r["straight"] + r["resumed"] for s in step]
        assert all(0 <= s < 2 ** SEED_BITS for s in seeds)
        assert r["resumed"][0] == r["straight"][1]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_ddp_steps_of_each_preset(ranks, name):
    got = [ranks["presets"][r][name] for r in range(WORLD)]
    for g in got:
        assert len(g["losses"]) == 2
        assert all(np.isfinite(g["losses"]))
        assert g["buffers_frozen_bn"] and g["buffers_kept"]
    assert got[0]["trainable"] == got[1]["trainable"] > 0
