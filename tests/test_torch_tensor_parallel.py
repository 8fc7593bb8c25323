"""reftr_torch's tensor parallelism (``--mesh_model``) on the CPU: four gloo
processes through ``reftr_torch.tools.launch`` (tests/torch_tp_worker.py),
held to JAX's (data, model) mesh and to one process.

One launch runs every job. On a (data 2, model 2) mesh of the four ranks,
then on two (data 1, model 2) meshes of two ranks each (the second laid
out model-major):

- (a) a step at 2 x 2 and at 1 x 2 from the weights of
  ``convert.from_flax`` of JAX's, at dropout 0, on
  tests/test_torch_distributed.py's batch and model (the model of
  tests/test_torch_train.py), against JAX's ``make_train_step`` on
  ``MeshConfig(data=2, model=2)`` over 4 of the 8 CPU devices: the losses
  at 1e-5, every gathered gradient and updated parameter at
  tests/test_torch_train.py's tolerances, ``grad_norm`` within 1e-5 of
  one process's (the batch's 3 boxes make JAX's count the same at world
  size 1 and 2, so one JAX step holds both meshes);
- (b) the kernels' entry point on each rank's block of the batch rows and
  heads, put together, against JAX's ``fused_attention_sharded`` (interpret
  mode) at 1e-5;
- (c) ``mesh_grid`` against ``create_mesh``'s device-id grid, both
  layouts, and ``loader_shards`` against JAX's on it;
- (d) ``param_spec`` against JAX's on every parameter of refcoco_det,
  refcoco_seg and flickr, but the query encoder's replicated pair;
- (e) checkpoints: a 1 x 2 checkpoint (gathered, rank 0 writes) resumes in
  one process, and one process's on the 1 x 2 mesh, each giving the
  uninterrupted run's next loss within 1e-5;
- (f) ``run_training`` at 1 x 2 (model-major) logs one process's
  train_loss, accuracy_iou0.5 and miou within 1e-4;
- (g) at dropout 0.1 the replicated parameters stay bit-identical across
  each model group, and every seed is ``shard_seed(draw, mesh.shard, b)``;
- (h) two 2 x 2 steps each of refcoco_seg and flickr at tiny width;
- (i) widths the model axis does not divide, a mesh off the world, and a
  model axis over an int8 layer raise;
- (j) int8 eval's calibration on the tensor-parallel fp model (a (a)
  model folded, fold_bn) at 2 x 2, each data row on its half of the batch,
  and at 1 x 2: the absmax tree on every rank equal to one process's on
  the whole batch at tests/test_torch_quant.py's CALIB_RTOL (2e-6; the
  float32 forwards sum in other orders, a row-parallel layer's input is
  its rank's slice, and the max over every rank puts the tree together),
  and at 1 x 2 ``calibrate_and_quantize``'s int8 weights, of the fp
  weights gathered to one process's shapes, against JAX's
  ``calibrate_and_quantize`` on ``MeshConfig(data=1, model=2)`` over 2
  CPU devices carried through ``convert.from_flax``: every weight leaf
  bit-equal (they depend on the weights alone), each ``in_scale`` (the
  absmax over 127) within CALIB_RTOL;
- (k) ``--quantize_train_prefix``'s calibration, gather and two steps at
  1 x 2 against one process's: the losses at 1e-5 and ``grad_norm`` at
  1e-4 (tests/test_torch_train.py's), the first step's gradients at (a)'s
  rule, layer1's int8 leaves bit-identical across the ranks and equal to
  one process's;
- (l) ``run_training`` at 1 x 2 (model-major): ``--eval --quantize_int8
  --fold_bn`` gives one process's accuracy_iou0.5 and its miou within
  1e-5, and a ``--quantize_train_prefix --fold_bn`` epoch one process's
  train_loss within 1e-5 and a checkpoint of one process's keys and
  shapes with its int8 layer1.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_tp_worker as worker
from reftr_tpu.cli import main as jax_main
from reftr_tpu.core.config import LossConfig as JaxLossConfig
from reftr_tpu.core.config import MeshConfig as JaxMeshConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_tpu.kernels.attention import fused_attention_sharded
from reftr_tpu.models import build as jax_build
from reftr_tpu.models import criterion as jax_criterion
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.models.reftr import RefTR as JaxRefTR
from reftr_tpu.nn import quant as jax_quant
from reftr_tpu.parallel.sharding import _loader_shards_from as jax_shards
from reftr_tpu.parallel.sharding import create_mesh as jax_create_mesh
from reftr_tpu.parallel.sharding import param_shardings
from reftr_tpu.parallel.sharding import param_spec as jax_param_spec
from reftr_tpu.train import schedules as jax_schedules
from reftr_tpu.train.optimizer import build_optimizer
from reftr_tpu.train.state import TrainState as JaxTrainState
from reftr_tpu.train.steps import make_train_step as jax_train_step
from reftr_tpu.train.steps import shard_batch, shard_state
from reftr_torch.cli import main as cli
from reftr_torch.convert import flax_leaf_to_torch, from_flax, model_class
from reftr_torch.core import checkpoint as ckpt_lib
from reftr_torch.core.config import (LossConfig, MeshConfig, ModelConfig,
                                     RefTRConfig, TrainConfig)
from reftr_torch.kernels.attention import shard_seed
from reftr_torch.models.criterion import weight_dict
from reftr_torch.nn import quant
from reftr_torch.parallel.context import Mesh
from reftr_torch.parallel.sharding import (MODEL_AXIS,
                                           REPLICATED_COINCIDENCES,
                                           check_data_axis, create_mesh,
                                           loader_shards, mesh_grid,
                                           param_spec, shard_dim)
from reftr_torch.parallel.tensor_parallel import shard_model
from reftr_torch.train.loop import run_training
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_train_step
from test_model_forward import multi_phrase_batch, single_phrase_batch
from test_torch_cli import parse
from test_torch_distributed import (ADAM_EPS, CLIP, PRESETS, STEP_MODEL,
                                    _free_port, jax_config, micro_batch)
from test_torch_quant import CALIB_RTOL
from torch_parity_utils import random_flax_params

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LAUNCH_TIMEOUT = 300  # s, from the start of the four ranks to their end
DROPOUT_STEPS = 3
RUN_EPOCHS = 2
RUN_BATCH = 8
MESHES = {"2x2": "mesh22.step", "1x2": "mesh12_a.step"}
# (c): (data, model) shapes of create_mesh over CPU devices
GRIDS = [(4, 2), (2, 2), (1, 2), (2, 4)]
# (j)-(k): (a)'s model folded, and the prefix's steps
INT8_MODEL = dict(STEP_MODEL, fold_bn=True)
PREFIX_STEPS = 2
# (l): the runs' model flags and train config (the micro trainer's batch
# of 8 over 16 items: 2 steps, and 2 eval batches of the 16 val items)
INT8_RUNS = {
    "eval": ({"fold_bn": True, "quantize_int8": True},
             {"epochs": 1, "eval_only": True, "quant_calib_batches": 1}),
    "prefix": ({"fold_bn": True, "quantize_train_prefix": True},
               {"epochs": 1, "quant_calib_batches": 1}),
}
# (d): each preset at tiny width
SPEC_ARGV = ["--bert_size", "tiny", "--enc_layers", "1", "--dec_layers",
             "1", "--dim_feedforward", "64"]


def second_batch():
    """micro_batch's shapes, other values and all four boxes valid."""
    batch, targets = micro_batch()
    rng = np.random.default_rng(1)
    batch = dict(batch, image=rng.integers(0, 256, batch["image"].shape)
                 .astype(np.uint8))
    return batch, dict(targets, box_valid=np.ones_like(targets["box_valid"]))


def save_batch(path, batch, targets) -> str:
    np.savez(path, **{f"b_{k}": v for k, v in batch.items()},
             **{f"t_{k}": v for k, v in targets.items()})
    return str(path)


def attention_inputs():
    rng = np.random.default_rng(3)
    b, s, h, d = 4, 24, 4, 8
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    valid = np.ones((b, s), bool)
    valid[1, 17:] = valid[3, 5:] = False
    return q, k, v, valid


def int8_runs(root) -> dict:
    """(l)'s runs, each writing under ``root``/its name."""
    return {name: (model, dict(train, output_dir=str(root / name)))
            for name, (model, train) in INT8_RUNS.items()}


def one_process(cfg, state_dict=None):
    state = TrainState.create(cfg, TrainConfig(epochs=1), 1, device="cpu",
                              state_dict=state_dict)
    wd = weight_dict(LossConfig(), cfg.dec_layers, cfg.aux_loss)
    return state, make_train_step(state.model, wd, LossConfig(),
                                  device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    return random_flax_params(JaxRefTR(jax_config()), micro_batch()[0])


def jax_int8_config():
    return dataclasses.replace(jax_config(), fold_bn=True)


@pytest.fixture(scope="module")
def jax_params8():
    """(j)-(k)'s folded model's weights."""
    return random_flax_params(JaxRefTR(jax_int8_config()), micro_batch()[0],
                              seed=1)


@pytest.fixture(scope="module", autouse=True)
def launched(jax_params, jax_params8, tmp_path_factory):
    """The four ranks, started on every job before the module's first
    test, so that JAX's step compiles and the tests that need no rank run
    meanwhile: (process, out dir, one process's resume results)."""
    out = tmp_path_factory.mktemp("tp")
    pcfg = worker.micro_model(0.0, **STEP_MODEL)
    torch.save(from_flax(jax_params, pcfg), out / "weights.pt")
    torch.save(from_flax(jax_params8, worker.micro_model(0.0, **INT8_MODEL)),
               out / "weights8.pt")
    batch = save_batch(out / "batch.npz", *micro_batch())
    batch2 = save_batch(out / "batch2.npz", *second_batch())
    q, k, v, valid = attention_inputs()
    np.savez(out / "attention.npz", q=q, k=k, v=v, valid=valid)
    # (e)'s one-process side: a checkpoint after the first step, and the
    # next step's loss without the stop
    state, step = one_process(worker.micro_model(0.0))
    step(state, *micro_batch())
    ckpt_lib.save_checkpoint(str(out), "one_checkpoint", state)
    one = {"straight": step(state, *second_batch())[1].get()["loss"],
           "keys": {n: tuple(t.shape)
                    for n, t in state.model.state_dict().items()}}
    step_job = {"state_dict": str(out / "weights.pt"), "batch": batch,
                "model": STEP_MODEL}
    int8_job = {"state_dict": str(out / "weights8.pt"), "batch": batch,
                "model": INT8_MODEL}
    spec = {
        "out": str(out), "port_a": _free_port(), "port_b": _free_port(),
        "mesh22": {
            "step": step_job,
            "attention": {"inputs": str(out / "attention.npz")},
            "dropout": {"batch": batch, "steps": DROPOUT_STEPS},
            "presets": {"presets": {k: v for k, v in PRESETS.items()
                                    if k != "refcoco_det"}},
            "int8_calib": int8_job,
        },
        "mesh12_a": {
            "step": step_job,
            "checkpoint": {"batch1": batch, "batch2": batch2,
                           "one_checkpoint": str(out / "one_checkpoint")},
            "int8_calib": int8_job,
            "int8_prefix": dict(int8_job, steps=PREFIX_STEPS),
        },
        "mesh12_b": {
            "run_training": {"epochs": RUN_EPOCHS, "batch_size": RUN_BATCH,
                             "output_dir": str(out / "train"),
                             "spans": True},
            "int8_runs": {"runs": int8_runs(out / "int8"), "spans": True},
        },
    }
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS"):
        env.pop(key, None)
    with open(out / "stdout.txt", "w") as so, open(out / "stderr.txt",
                                                   "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", "reftr_torch.tools.launch",
             "--nproc_per_node", str(WORLD), "--coordinator_port",
             str(_free_port()), "--", sys.executable,
             os.path.join(REPO, "tests", "torch_tp_worker.py"), str(path)],
            cwd=REPO, env=env, stdout=so, stderr=se)
    yield proc, out, one
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_step(jax_params, launched):
    """JAX's step on a (data 2, model 2) mesh of 4 CPU devices, world size
    2: (new params, metrics, clip norm, masked gradients)."""
    jcfg = jax_config()
    model = JaxRefTR(jcfg)
    batch, targets = micro_batch()
    tc = JaxTrainConfig(epochs=1)
    tx = build_optimizer(jcfg, tc, jax_schedules.build_schedule(tc, 1))
    wd = jax_criterion.weight_dict(JaxLossConfig(), jcfg.dec_layers,
                                   jcfg.aux_loss)
    mesh = jax_create_mesh(JaxMeshConfig(data=2, model=2),
                           devices=jax.devices()[:4])
    step = jax_train_step(model, wd, JaxLossConfig(), world_size=2,
                          donate=False, mesh=mesh)
    with mesh:
        state = shard_state(JaxTrainState.create(
            jax_params, tx, jax.random.PRNGKey(1)), mesh)
        new_state, metrics = step(state, shard_batch(batch, mesh),
                                  shard_batch(targets, mesh))
        new_params = jax.device_get(new_state.params)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        out = model.apply({"params": p}, jbatch, deterministic=True)
        return jax_criterion.total_loss(jax_criterion.criterion(
            out, targets, JaxLossConfig(), 2), wd)

    grads = jax.jit(jax.grad(loss_fn))(jax_params)
    from reftr_tpu.train.optimizer import label_fn
    import optax
    labels = label_fn(jcfg, tc)(jax_params)
    masked = jax.tree_util.tree_map(lambda g, lab: g * (lab != "frozen"),
                                    grads, labels)
    return {"new_params": new_params,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "clip_norm": float(optax.global_norm(masked)),
            "grads": flatten_dict(jax.device_get(masked))}


@pytest.fixture(scope="module")
def one_step(jax_params):
    """One process's step on the whole batch from the same weights."""
    pcfg = worker.micro_model(0.0, **STEP_MODEL)
    state, step = one_process(pcfg, from_flax(jax_params, pcfg))
    return step(state, *micro_batch())[1].get()


@pytest.fixture(scope="module")
def ranks(launched):
    """Every job's result on each rank: {"<mesh>.<job>": [rank 0's, ...]}
    (the 1 x 2 meshes' ranks 0 and 1 of their own group)."""
    proc, out, _ = launched
    rc = proc.wait(timeout=LAUNCH_TIMEOUT)
    assert rc == 0, (out / "stderr.txt").read_text()[-6000:]
    got = {}
    for name in sorted(os.listdir(out)):
        if name.startswith("mesh") and name.endswith(".pt"):
            key, rank = name[:-3].rsplit("_", 1)
            got.setdefault(key, {})[int(rank)] = torch.load(
                out / name, weights_only=False)
    return {k: [v[r] for r in sorted(v)] for k, v in got.items()}


# the tests that need no rank run first, while the ranks do (``launched``
# starts them before the module's first test)
@pytest.mark.parametrize("spans", [False, True], ids=["classic", "spans"])
@pytest.mark.parametrize("data,model", GRIDS)
def test_rank_grid_is_create_mesh_device_grid(data, model, spans):
    n = data * model
    jmesh = jax_create_mesh(JaxMeshConfig(data=data, model=model,
                                          model_spans_processes=spans),
                            devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    grid = mesh_grid(data, model, spans)
    np.testing.assert_array_equal(grid, ids)
    for rank in range(n):
        # one device a process: JAX's process index of a slot is its id
        d, m = np.argwhere(grid == rank)[0]
        mesh = Mesh(data, model, int(d), int(m), tuple(map(tuple, grid)))
        assert loader_shards(mesh) == jax_shards(ids, rank) == (data, d)
        assert mesh.shard == d * model + m


def spec_configs(name):
    argv = ["--preset", name] + SPEC_ARGV
    if name == "refcoco_seg":  # GroupNorm(8) of the mask head
        argv += ["--hidden_dim", "128", "--nheads", "8"]
    return (jax_main.args_to_config(parse(jax_main, argv)),
            cli.args_to_config(parse(cli, argv)).model)


@pytest.mark.parametrize("name", ["refcoco_det", "refcoco_seg", "flickr"])
def test_param_spec_matches_jax(name):
    jcfg, pcfg = spec_configs(name)
    rng = np.random.default_rng(0)
    batch = (multi_phrase_batch(rng) if "multi" in pcfg.reftr_type
             else single_phrase_batch(rng))
    shapes = jax.eval_shape(lambda: jax_build.build_model(jcfg)[0].init(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, batch)))
    with torch.device("meta"):
        names = set(model_class(pcfg)(pcfg).state_dict())
    sharded = coincidences = 0
    for path, leaf in flatten_dict(shapes["params"]).items():
        spec = tuple(jax_param_spec("/".join(path)))
        name_t, _ = flax_leaf_to_torch(path, np.zeros(leaf.shape, np.int8))
        assert name_t in names, name_t
        if len(spec) == 2:  # a Flax kernel is the transpose of a weight
            spec = spec[::-1]
        if REPLICATED_COINCIDENCES.search(name_t):
            assert param_spec(name_t) == (), name_t
            coincidences += MODEL_AXIS in spec
            continue
        assert param_spec(name_t) == spec, name_t
        sharded += MODEL_AXIS in spec
    assert coincidences == 3  # linear1's kernel and bias, linear2's kernel
    assert sharded > 20


def tp_model(**model):
    cfg = dataclasses.replace(worker.micro_model(0.0), **model)
    with torch.device("meta"):
        return model_class(cfg)(cfg)


MESH12 = Mesh(1, 2, 0, 0, ((0, 1),))


@pytest.mark.parametrize("case", ["heads", "ffn", "bert", "world",
                                  "quant_dense"])
def test_what_the_model_axis_does_not_divide_raises(case):
    if case == "heads":
        with pytest.raises(ValueError, match=r"vl_transformer\.encoder\."
                           r"layers\.0\.self_attn \(3 heads\)"):
            shard_model(tp_model(hidden_dim=96, nheads=3), MESH12)
    elif case == "ffn":
        with pytest.raises(ValueError, match=r"encoder\.layers\.0\.ffn "
                           r"\(33 hidden\)"):
            shard_model(tp_model(dim_feedforward=33), MESH12)
    elif case == "bert":
        model = tp_model()
        model.lang_backbone.layer[0].intermediate = torch.nn.Linear(
            64, 129, device="meta")
        with pytest.raises(ValueError, match=r"lang_backbone\.layer\.0 "
                           r"\(129 intermediate\)"):
            shard_model(model, MESH12)
    elif case == "world":
        with pytest.raises(ValueError, match="--mesh_model 3 does not "
                                             "divide the 4 processes"):
            check_data_axis(-1, 4, 3)
        with pytest.raises(ValueError, match="mesh 2x2 does not match "
                                             "the 2 processes"):
            create_mesh(MeshConfig(data=2, model=2), world=2, rank=0)
        with pytest.raises(ValueError, match="empty local batch"):
            shard_seed(1, 3, 0)
    else:
        # nothing shards an int8 model: int8 eval on a model axis runs it
        # unsharded on every rank, as JAX replicates its int8 tree
        with pytest.raises(ValueError, match=r"lang_backbone\.layer\.0 "
                           r"\(\d+ intermediate\): QuantDense has no "
                           r"tensor-parallel form: int8 eval under "
                           r"--mesh_model runs unsharded"):
            shard_model(tp_model(fold_bn=True, quantize_int8=True), MESH12)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_step_losses_and_norm(jax_step, one_step, ranks, mesh):
    got = ranks[MESHES[mesh]]
    want = jax_step["metrics"]
    leaders = [r["metrics"] for r in got if r["model_index"] == 0]
    for key in ("loss", "loss_bbox", "loss_giou", "loss_bbox_0",
                "loss_giou_0"):
        mean = sum(m[key] for m in leaders) / len(leaders)
        np.testing.assert_allclose(mean, want[key], rtol=1e-5, err_msg=key)
    for r in got:
        # the model group's ranks hold one batch: one loss
        assert r["metrics"]["loss"] == leaders[r["data_index"]]["loss"]
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   one_step["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   jax_step["clip_norm"], rtol=1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_step_gradients_and_params_match_jax(jax_step, ranks, mesh):
    got = ranks[MESHES[mesh]]
    r0 = got[0]
    pcfg = worker.micro_model(0.0, **STEP_MODEL)
    coef = CLIP / max(jax_step["clip_norm"], CLIP)
    gmax = coef * max(np.abs(g).max() for g in jax_step["grads"].values())
    compared = 0
    for path, g in jax_step["grads"].items():
        name, want = flax_leaf_to_torch(path, np.asarray(g) * coef)
        if name not in r0["grads"]:  # frozen, or FrozenBN's buffers
            assert not want.any(), name
            continue
        for r in got[1:]:
            assert torch.equal(r0["grads"][name], r["grads"][name]), name
        err = np.abs(r0["grads"][name].numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-6 * gmax, name
        compared += 1
    assert compared == len(r0["grads"]) > 100
    assert sum(shard_dim(n) is not None for n in r0["grads"]) > 20
    want = from_flax(jax_step["new_params"], pcfg)
    grads = dict(flax_leaf_to_torch(p, np.abs(np.asarray(g)) * coef)
                 for p, g in jax_step["grads"].items())
    lr = TrainConfig().lr
    for name, value in r0["params"].items():
        assert value.shape == want[name].shape, name
        for r in got[1:]:
            assert torch.equal(value, r["params"][name]), name
        err = np.abs(value.numpy() - want[name].numpy())
        if name in grads:
            big = grads[name] > 100 * ADAM_EPS
            assert (err[big] <= 1e-6).all(), name
            assert err.max() <= 2 * lr, name
        else:
            assert err.max() == 0.0, name


def test_tp_attention_matches_fused_attention_sharded(ranks):
    q, k, v, valid = attention_inputs()
    mesh = jax_create_mesh(JaxMeshConfig(data=2, model=2),
                           devices=jax.devices()[:4])
    want = np.asarray(fused_attention_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        mesh, interpret=True))
    got = np.full_like(want, np.nan)
    blocks = set()
    for r in ranks["mesh22.attention"]:
        (b0, b1), (h0, h1) = r["batch"], r["heads"]
        assert (b0, h0) == (2 * r["data_index"], 2 * r["model_index"])
        got[b0:b1, :, h0:h1] = r["out"].numpy()
        blocks.add((b0, h0))
    assert len(blocks) == WORLD
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_worker_meshes_sit_on_their_grids(ranks):
    meshes = {"mesh22.attention": (2, 2, False), "mesh12_a.step":
              (1, 2, False)}
    for key, (data, model, spans) in meshes.items():
        grid = mesh_grid(data, model, spans)
        for rank, r in enumerate(ranks[key]):
            assert r["grid"] == tuple(map(tuple, grid.tolist()))
            assert grid[r["data_index"], r["model_index"]] == rank


@pytest.mark.parametrize("direction", ["tp_to_one", "one_to_tp"])
def test_checkpoint_resumes_across_model_axes(ranks, launched, direction):
    _, out, one = launched
    got = ranks["mesh12_a.checkpoint"]
    if direction == "one_to_tp":
        for r in got:
            assert r["resumed_from_one"] == pytest.approx(one["straight"],
                                                          rel=1e-5)
        return
    assert got[0]["straight"] == got[1]["straight"]
    payload = ckpt_lib.load_checkpoint(str(out / "tp_checkpoint"))
    # one process's keys and full shapes, and the ranks' slices of them
    assert {n: tuple(t.shape) for n, t in payload["model"].items()} == one[
        "keys"]
    for name, shape in got[0]["local_shapes"].items():
        dim = shard_dim(name)
        if dim is not None:
            full = list(one["keys"][name])
            full[dim] //= 2
            assert shape == tuple(full), name
    assert [n for n in os.listdir(out) if n.endswith(".tmp")] == []
    state, step = one_process(worker.micro_model(0.0))
    state.load_model_state(payload["model"])
    state.restore(payload)
    resumed = step(state, *second_batch())[1].get()["loss"]
    assert resumed == pytest.approx(got[0]["straight"], rel=1e-5)


def test_run_training_model_axis_matches_one_process(ranks, launched,
                                                     tmp_path):
    _, out, _ = launched
    cfg = worker.micro_config(0.0, epochs=RUN_EPOCHS,
                              output_dir=str(tmp_path))
    cfg.data.batch_size = RUN_BATCH
    one = run_training(cfg, device="cpu")["history"]
    two = [r["history"] for r in ranks["mesh12_b.run_training"]]
    with open(out / "train" / "log.txt") as f:
        logged = [json.loads(x) for x in f]
    assert len(logged) == len(one) == RUN_EPOCHS
    for got, r1, want in zip(logged, two[1], one):
        assert {k: v for k, v in r1.items() if k != "epoch_time"} == {
            k: v for k, v in got.items() if k != "epoch_time"}
        assert got["n_parameters"] == want["n_parameters"]
        for key in ("train_loss", "test_val_accuracy_iou0.5",
                    "test_val_miou"):
            assert got[key] == pytest.approx(want[key], rel=1e-4), key
    assert sorted(os.listdir(out / "train")) == sorted(os.listdir(tmp_path))


def test_dropout_keeps_replicas_identical(ranks):
    got = ranks["mesh22.dropout"]
    for d in range(2):
        pair = [r for r in got if r["data_index"] == d]
        assert len(pair) == 2
        assert pair[0]["losses"] == pair[1]["losses"]
        assert all(np.isfinite(pair[0]["losses"]))
    # the data rows train on different halves, and DDP's average keeps
    # every replicated parameter the same on all four ranks
    assert got[0]["losses"] != got[2]["losses"]
    assert all(r["digests"] == got[0]["digests"] for r in got)


def test_dropout_seeds_fold_the_mesh_shard(ranks):
    got = ranks["mesh22.dropout"]
    draws = [[f[0] for f in r["folds"]] for r in got]
    assert all(d == draws[0] for d in draws) and draws[0]
    for r in got:
        assert r["shard"] == 2 * r["data_index"] + r["model_index"]
        for draw, shard, b, seed in r["folds"]:
            assert (shard, b) == (r["shard"], 2)
            assert seed == shard_seed(draw, r["shard"], 2)
    # 5 attentions and 2 sharded FFN hidden blocks a step, each its seed
    assert len(draws[0]) == DROPOUT_STEPS * 7
    seeds = {f[3] for r in got for f in r["folds"]}
    assert len(seeds) == WORLD * len(draws[0])


@pytest.mark.parametrize("name", ["refcoco_seg", "flickr"])
def test_tp_steps_of_each_preset(ranks, name):
    got = [r["presets"][name] for r in ranks["mesh22.presets"]]
    for r in got:
        assert len(r["losses"]) == 2 and all(np.isfinite(r["losses"]))
        assert r["sharded"] > 0
    assert got[0]["losses"] == got[1]["losses"]
    assert got[2]["losses"] == got[3]["losses"]
    assert all(r["digests"] == got[0]["digests"] for r in got)


def port_int8_model():
    return worker.micro_model(0.0, **INT8_MODEL)


@pytest.fixture(scope="module")
def one_int8(jax_params8):
    """One process's side of (j) and (k) on the whole batch: the
    calibration tree of the fp model, and the prefix's calibration and
    steps."""
    cfg = port_int8_model()
    weights = from_flax(jax_params8, cfg)
    batch, targets = micro_batch()
    state, _ = one_process(cfg, weights)
    mc = dataclasses.replace(cfg, quantize_int8=True)
    absmax, _, _ = quant._calibrate(
        state.model, quant.quant_targets(model_class(mc), mc),
        [(batch, targets)], 1, torch.device("cpu"), autocast=False)
    pcfg = dataclasses.replace(cfg, quantize_train_prefix=True)
    prefix = quant.calibrate_train_prefix(
        RefTRConfig(model=pcfg), state.model, [(batch, targets)],
        n_batches=1, print_fn=worker.quiet)
    state, step = one_process(pcfg, prefix)
    metrics = [step(state, batch, targets)[1].get()]
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()
             if p.grad is not None}
    metrics += [step(state, batch, targets)[1].get()
                for _ in range(PREFIX_STEPS - 1)]
    layer1 = {n: hashlib.sha256(v.numpy().tobytes()).hexdigest()
              for n, v in state.model.img_backbone.layer1.state_dict().items()}
    return {"absmax": worker.calib_leaves(absmax), "metrics": metrics,
            "layer1": layer1, "grads": grads}


@pytest.fixture(scope="module")
def jax_int8_weights(jax_params8, launched):
    """JAX's calibrate_and_quantize on a (data 1, model 2) mesh of 2 CPU
    devices, its params sharded by its rules, carried through
    from_flax."""
    mesh = jax_create_mesh(JaxMeshConfig(data=1, model=2),
                           devices=jax.devices()[:2])
    params = jax.device_put(jax_params8,
                            param_shardings(jax_params8, mesh))
    qparams = jax_quant.calibrate_and_quantize(
        JaxRefTRConfig(model=jax_int8_config()), params, [micro_batch()],
        mesh=mesh, n_batches=1, print_fn=worker.quiet)
    return from_flax(jax.device_get(qparams),
                     dataclasses.replace(port_int8_model(),
                                         quantize_int8=True))


@pytest.mark.parametrize("mesh", ["mesh22", "mesh12_a"])
def test_int8_calibration_on_the_model_axis_is_one_process(ranks, one_int8,
                                                           mesh):
    got = ranks[f"{mesh}.int8_calib"]
    want = one_int8["absmax"]
    assert all(r["absmax"] == got[0]["absmax"] for r in got)
    assert set(got[0]["absmax"]) == set(want)
    # every product of every scope: 52 convs, BERT-tiny's 2 layers of 6
    # denses, the encoder's 2 layers of 6, the decoder's 2 of 10
    assert len(want) == 52 + 2 * 6 + 2 * 6 + 2 * 10
    for k, v in want.items():
        assert got[0]["absmax"][k] == pytest.approx(v, rel=CALIB_RTOL), k


def test_int8_weights_on_the_model_axis_match_jax(ranks, jax_int8_weights):
    got = [r["qweights"] for r in ranks["mesh12_a.int8_calib"]]
    want = jax_int8_weights
    assert set(got[0]) == set(want)
    scales = 0
    for name, w in want.items():
        assert got[0][name].dtype == w.dtype, name
        assert torch.equal(got[0][name], got[1][name]), name
        if name.endswith(".in_scale"):
            assert got[0][name].item() == pytest.approx(w.item(),
                                                        rel=CALIB_RTOL), name
            scales += 1
        else:
            assert torch.equal(got[0][name], w), name
    assert scales == 52 + 2 * 6 + 2 * 6 + 2 * 10
    assert got[0]["img_backbone.layer3.0.conv2.kernel_q"].dtype == torch.int8


def test_int8_prefix_steps_on_the_model_axis_are_one_process(ranks,
                                                             one_int8):
    got = ranks["mesh12_a.int8_prefix"]
    want = one_int8
    assert len(want["layer1"]) > 20
    for r in got:
        assert r["layer1"] == want["layer1"]
        assert len(r["metrics"]) == PREFIX_STEPS
        for m, w in zip(r["metrics"], want["metrics"]):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"],
                                       rtol=1e-4)
    r0 = got[0]
    assert set(r0["grads"]) == set(want["grads"])
    gmax = max(g.abs().max().item() for g in want["grads"].values())
    for name, w in want["grads"].items():
        assert torch.equal(r0["grads"][name], got[1]["grads"][name]), name
        err = (r0["grads"][name] - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item() + 1e-6 * gmax, name


def test_int8_runs_on_the_model_axis_are_one_process(ranks, launched,
                                                     tmp_path):
    _, out, _ = launched
    one = {}
    for name, (model, train) in int8_runs(tmp_path).items():
        cfg = worker.micro_config(0.0, **train)
        cfg.model = dataclasses.replace(cfg.model, **model)
        one[name] = run_training(cfg, device="cpu")
    want_eval = one["eval"]["test"]["val"]
    for r in ranks["mesh12_b.int8_runs"]:
        got = r["eval"]["test"]["val"]
        assert np.isfinite(got["loss"])
        assert got["accuracy_iou0.5"] == want_eval["accuracy_iou0.5"]
        assert got["miou"] == pytest.approx(want_eval["miou"], abs=1e-5)
        assert r["prefix"]["history"][0]["train_loss"] == pytest.approx(
            one["prefix"]["history"][0]["train_loss"], rel=1e-5)
    tp = ckpt_lib.load_checkpoint(str(out / "int8" / "prefix" /
                                      "checkpoint"))["model"]
    mine = ckpt_lib.load_checkpoint(str(tmp_path / "prefix" /
                                        "checkpoint"))["model"]
    assert {n: v.shape for n, v in tp.items()} == {
        n: v.shape for n, v in mine.items()}
    layer1 = [n for n in tp if n.startswith("img_backbone.layer1.")]
    assert tp["img_backbone.layer1.0.conv2.kernel_q"].dtype == torch.int8
    for name in layer1:
        assert torch.equal(tp[name], mine[name]), name
