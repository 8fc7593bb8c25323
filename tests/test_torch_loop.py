"""reftr_torch's training driver and eval loop, on the CPU, against
reftr_tpu's.

JAX's ``run_training`` trains one epoch of a micro RefTR (bert tiny,
ResNet-50 at 32 px, 1+1 VL layers, d=32) on the synthetic fixture, then
evaluates the 64-item val split and writes its log line, checkpoint and
result file. From those:

- the port's ``evaluate`` on JAX's final weights (``convert.from_flax``)
  over the port's val loader gives the same accuracy_iou0.5, miou within
  1e-5 (sums of 64 IoUs in another order), each logged loss within 1e-5
  relative (the forward agrees to 1e-7), and the boxes of JAX's result
  file within 1e-3 px (box coordinates up to 32 px in float32);
- the port's ``run_training`` on the same config writes a log line with
  the same keys.

The port's driver alone: two straight epochs end with the same parameters,
optimizer state and logged numbers, bit for bit, as one epoch, a stop and
an auto-resumed second epoch (the checkpoint carries the dropout
generator, and the sampler's epoch comes from the restored epoch); an LR
overridden on resume takes effect, as in tests/test_loop.py; eval-only on
the saved checkpoint gives the last epoch's test stats; and without a card
``run_training`` refuses the default device.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from reftr_tpu.core.config import BertConfig as JaxBertConfig
from reftr_tpu.core.config import DataConfig as JaxDataConfig
from reftr_tpu.core.config import MeshConfig as JaxMeshConfig
from reftr_tpu.core.config import ModelConfig as JaxModelConfig
from reftr_tpu.core.config import RefTRConfig as JaxRefTRConfig
from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
from reftr_torch.convert import build_model, from_flax
from reftr_torch.core import checkpoint as ckpt_lib
from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                     RefTRConfig, TrainConfig)
from reftr_torch.models.criterion import weight_dict
from reftr_torch.train.engine import evaluate
from reftr_torch.train.loop import build_loaders, build_tokenizer, run_training
from reftr_torch.train.steps import make_eval_step

torch.set_num_threads(1)
MODEL = dict(enc_layers=1, dec_layers=1, dim_feedforward=32, hidden_dim=32,
             nheads=4, aux_loss=False, dtype="float32")
DATA = dict(dataset="synthetic", train_split="train", test_splits=("val",),
            img_size=32, max_img_size=32, max_query_len=12, batch_size=8,
            num_workers=2, synthetic_n=16)
TRAIN = dict(lr=1e-3, warm_up_epoch=1, lr_schedule="CosineWarmupLR", seed=0)


def port_config(out_dir, epochs=1, **train) -> RefTRConfig:
    return RefTRConfig(
        model=ModelConfig(bert=BertConfig.tiny(), **MODEL),
        data=DataConfig(**DATA),
        train=TrainConfig(**dict(TRAIN, epochs=epochs, output_dir=str(out_dir),
                                 **train)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One epoch of JAX's run_training: (output dir, its log line)."""
    from reftr_tpu.train.loop import run_training as jax_run_training

    out = tmp_path_factory.mktemp("jax")
    cfg = JaxRefTRConfig(
        model=JaxModelConfig(bert=JaxBertConfig.tiny(), **MODEL),
        data=JaxDataConfig(**DATA), mesh=JaxMeshConfig(data=-1, model=1),
        train=JaxTrainConfig(**dict(TRAIN, epochs=1, output_dir=str(out),
                                    donate_state=False)))
    jax_run_training(cfg)
    with open(out / "log.txt") as f:
        (entry,) = [json.loads(line) for line in f]
    return out, entry


def test_evaluate_matches_jax_on_its_weights(jax_run, tmp_path):
    import orbax.checkpoint as ocp

    out, entry = jax_run
    with ocp.PyTreeCheckpointer() as ckptr:
        params = ckptr.restore(os.path.join(out, "checkpoint"))["params"]
    cfg = port_config(tmp_path)
    model = build_model(cfg.model, "cpu", from_flax(params, cfg.model))
    _, test_loaders = build_loaders(cfg, build_tokenizer(cfg))
    wd = weight_dict(cfg.loss, cfg.model.dec_layers, cfg.model.aux_loss)
    stats, results = evaluate(make_eval_step(model, cfg.loss, device="cpu"),
                              test_loaders["val"], weight_dict=wd,
                              collect_results=True)
    want = {k.removeprefix("test_val_"): v for k, v in entry.items()
            if k.startswith("test_val_")}
    assert set(stats) == set(want)
    assert stats["accuracy_iou0.5"] == want["accuracy_iou0.5"]
    assert abs(stats["miou"] - want["miou"]) <= 1e-5
    assert want["miou"] > 0
    for k in stats:
        if k.startswith("loss"):
            assert abs(stats[k] - want[k]) <= 1e-5 * abs(want[k]), k
    with open(out / "synthetic_val_result.json") as f:
        want_boxes = {int(k): np.asarray(v) for k, v in json.load(f).items()}
    assert sorted(results) == sorted(want_boxes) == list(range(64))
    err = max(np.abs(np.asarray(results[i]) - want_boxes[i]).max()
              for i in want_boxes)
    assert err <= 1e-3, err


def test_log_keys_match_jax(jax_run, tmp_path):
    _, entry = jax_run
    result = run_training(port_config(tmp_path), device="cpu")
    with open(tmp_path / "log.txt") as f:
        (line,) = [json.loads(x) for x in f]
    assert set(line) == set(entry)
    assert line == result["history"][0]
    assert all(np.isfinite(v) for v in line.values())
    for name in ("checkpoint", "synthetic_val_result.json"):
        assert (tmp_path / name).is_file(), name


def _payload(path):
    return ckpt_lib.load_checkpoint(str(path))


def test_two_epochs_equal_one_epoch_and_a_resume(tmp_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    r2 = run_training(port_config(straight, epochs=2), device="cpu")
    first = run_training(port_config(split, epochs=2, run_epoch=1),
                         device="cpu")
    assert [h["epoch"] for h in first["history"]] == [0]
    second = run_training(port_config(split, epochs=2, auto_resume=True),
                          device="cpu")
    assert [h["epoch"] for h in second["history"]] == [1]
    for a, b in zip(r2["history"], first["history"] + second["history"]):
        a, b = dict(a), dict(b)
        a.pop("epoch_time"), b.pop("epoch_time")
        assert a == b
    want, got = _payload(straight / "checkpoint"), _payload(
        split / "checkpoint")
    assert got["step"] == want["step"] == 4 and got["epoch"] == 1
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer_params"] == want["optimizer_params"]
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    assert torch.equal(got["generator"], want["generator"])


def test_resume_applies_overridden_lr(tmp_path):
    """As tests/test_loop.py::test_resume_applies_overridden_lr: StepLR
    with a drop every epoch, the LR overridden at each resume."""
    def run(lr, epochs):
        return run_training(port_config(
            tmp_path, epochs=epochs, lr=lr, lr_backbone=lr, lr_bert=lr,
            lr_schedule="StepLR", lr_drop=1, auto_resume=True),
            device="cpu")

    r0 = run(1e-3, 1)
    assert np.isclose(r0["history"][0]["train_lr"], 1e-3)
    # epoch 1 is past the first drop: every step at 4e-4 * 0.1
    r1 = run(4e-4, 2)
    assert r1["history"][0]["epoch"] == 1
    assert np.isclose(r1["history"][0]["train_lr"], 4e-4 * 0.1)
    # lr 0: the optimizer, not only the log, takes the new rate
    run(0.0, 3)
    p1 = _payload(tmp_path / "checkpoint0001")["model"]
    p2 = _payload(tmp_path / "checkpoint0002")["model"]
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of the port's driver: (output dir, its log lines)."""
    out = tmp_path_factory.mktemp("port")
    run_training(port_config(out, epochs=2), device="cpu")
    with open(out / "log.txt") as f:
        return out, [json.loads(x) for x in f]


@pytest.mark.parametrize("how", ["resume", "resume_model_only",
                                 "pretrained_model"])
def test_eval_only_reproduces_the_last_epoch(trained, tmp_path, how):
    out, log = trained
    assert [h["epoch"] for h in log] == [0, 1]
    ckpt = str(out / "checkpoint")
    train = {"eval_only": True}
    if how == "pretrained_model":
        train["pretrained_model"] = ckpt
    else:
        train["resume"] = ckpt
        train["resume_model_only"] = how == "resume_model_only"
    stats = run_training(port_config(tmp_path, **train), device="cpu")
    got = stats["test"]["val"]
    want = {k.removeprefix("test_val_"): v for k, v in log[-1].items()
            if k.startswith("test_val_")}
    assert set(got) == set(want)
    assert got["accuracy_iou0.5"] == want["accuracy_iou0.5"]
    assert abs(got["miou"] - want["miou"]) <= 1e-5
    assert not (tmp_path / "log.txt").exists()
    assert (tmp_path / "synthetic_val_result.json").is_file()


def test_resume_refuses_a_weights_only_checkpoint(trained, tmp_path):
    out, _ = trained
    state_only = dict(_payload(out / "checkpoint"))
    for k in ("optimizer", "optimizer_params", "scheduler", "generator"):
        state_only.pop(k)
    torch.save(state_only, tmp_path / "weights")
    cfg = port_config(tmp_path, epochs=3, resume=str(tmp_path / "weights"))
    with pytest.raises(ValueError, match="resume_model_only"):
        run_training(cfg, device="cpu")


@pytest.mark.parametrize("path", ["model.pth", "https://host/ckpt.pth"])
def test_foreign_checkpoints_are_refused(tmp_path, path):
    cfg = port_config(tmp_path, pretrained_model=path)
    with pytest.raises(NotImplementedError, match="item 11"):
        run_training(cfg, device="cpu")


def test_load_pretrained_nonstrict_reports_and_merges():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pre = {"0.weight": torch.ones(4, 3), "1.weight": torch.ones(5, 5),
           "2.bias": torch.ones(2)}
    logged = []
    report = ckpt_lib.load_pretrained_nonstrict(model, pre, log=logged.append)
    assert report == {"missing": ["0.bias", "1.bias"],
                      "unexpected": ["2.bias"],
                      "shape_skipped": ["1.weight"]}
    assert len(logged) == 3
    sd = model.state_dict()
    assert torch.equal(sd["0.weight"], torch.ones(4, 3))
    for k in ("0.bias", "1.weight", "1.bias"):
        assert torch.equal(sd[k], before[k]), k


def test_the_checkpoint_holds_the_config(trained):
    out, _ = trained
    assert _payload(out / "checkpoint")["config"] == dataclasses.asdict(
        port_config(out, epochs=2))


def test_run_training_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(port_config(tmp_path))
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("steps_per_epoch", [1, 2, 8])
def test_cosine_schedule_after_an_all_warm_up_run(steps_per_epoch):
    """epochs == warm_up_epoch (synthetic_smoke at --epochs 1): JAX's
    schedule gives 0/0 = NaN at the step after the last, which no step
    reads; LambdaLR reads it after the last step, where the port's gives
    the floor instead of raising. Every step that runs agrees."""
    from reftr_tpu.core.config import TrainConfig as JaxTrainConfig
    from reftr_tpu.train import schedules as jax_schedules
    from reftr_torch.train import schedules

    kw = dict(lr_schedule="CosineWarmupLR", epochs=1, warm_up_epoch=1)
    n = steps_per_epoch
    got = schedules.build_schedule(TrainConfig(**kw), n)
    want = jax_schedules.build_schedule(JaxTrainConfig(**kw), n)
    import jax.numpy as jnp

    # the JAX step passes the step count as an array
    for step in range(n):
        assert np.isclose(got(step), float(want(jnp.asarray(step))),
                          rtol=1e-6)
    assert np.isnan(float(want(jnp.asarray(n))))
    assert got(n) == 0.01
