"""reftr_torch serving runtime, device selection and import isolation.

The serving path runs on the CPU here at a tiny size (bert tiny, 64 px,
1+1 VL layers). Entry points default to CUDA and must raise where there
is none rather than fall back to the CPU; the package must import and run
without JAX, Flax, Optax or any module of reftr_tpu.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from reftr_torch.core.config import (BertConfig, DataConfig, ModelConfig,
                                     RefTRConfig)
from reftr_torch.serve import (MicroBatcher, Request, ServingModel, pad_batch,
                               resolve_device)
from torch_parity_utils import t

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(bert=BertConfig.tiny(), enc_layers=1, dec_layers=1,
            dim_feedforward=32, hidden_dim=32, nheads=2)


def tiny_config():
    return RefTRConfig(model=ModelConfig(**TINY),
                       data=DataConfig(img_size=64, max_query_len=10))


def make_request(rng, k, img=64, s=10):
    vh, vw = int(rng.integers(20, img + 1)), int(rng.integers(20, img + 1))
    valid = np.zeros((k, img, img), bool)
    valid[:, :vh, :vw] = True
    sent_valid = np.zeros((k, s), np.int32)
    for j in range(k):
        sent_valid[j, :int(rng.integers(3, s + 1))] = 1
    rows = {"image": rng.integers(0, 256, (k, img, img, 3), dtype=np.uint8),
            "image_valid": valid,
            "sentence": rng.integers(1, 512, (k, s)).astype(np.int32),
            "sentence_valid": sent_valid}
    return Request(rows=rows, k=k, orig_hw=(2 * vh, 2 * vw), valid_hw=(vh, vw),
                   phrases=[f"phrase {j}" for j in range(k)])


@pytest.fixture(scope="module")
def serving():
    return ServingModel(tiny_config(), batch_size=4, device="cpu", seed=0)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingModel(tiny_config(), batch_size=2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_model_matches_the_model_forward(serving):
    rng = np.random.default_rng(0)
    batch = pad_batch([make_request(rng, 2), make_request(rng, 1)], 4)
    out = serving(batch)
    with torch.no_grad():
        want = serving.model({k: t(v) for k, v in batch.items()})
    np.testing.assert_array_equal(out["pred_boxes"],
                                  want["pred_boxes"].numpy())
    assert out["pred_boxes"].shape == (4, 1, 1, 4)


def test_pad_batch_keeps_padding_rows_well_formed():
    rng = np.random.default_rng(1)
    batch = pad_batch([make_request(rng, 1), make_request(rng, 2)], 5)
    assert batch["image"].shape == (5, 64, 64, 3)
    assert batch["sentence_valid"][3:].tolist() == [[1, 1] + [0] * 8] * 2
    assert batch["image_valid"][3:].all()
    assert not batch["sentence"][3:].any()


def test_micro_batcher_serves_requests(serving):
    rng = np.random.default_rng(2)
    reqs = [make_request(rng, k) for k in (1, 3, 2, 1, 2)]
    too_big = make_request(rng, 5)
    batcher = MicroBatcher(serving, timeout_ms=5.0)
    try:
        for r in reqs + [too_big]:
            batcher.submit(r)
        for r in reqs + [too_big]:
            assert r.done.wait(timeout=60)
    finally:
        batcher.stop()
    assert not batcher.thread.is_alive()
    assert too_big.error and "5 phrases > serve batch 4" in too_big.error
    for r in reqs:
        assert r.error is None
        assert [x["phrase"] for x in r.result] == r.phrases
        h0, w0 = r.orig_hw
        for x in r.result:
            x0, y0, x1, y1 = x["box_xyxy"]
            assert 0 <= x0 <= x1 <= w0 and 0 <= y0 <= y1 <= h0
    stats = batcher.stats
    assert stats["requests"] == len(reqs)
    assert stats["rows"] == sum(r.k for r in reqs)
    assert stats["batches"] >= 3  # 9 rows, at most 4 in a batch


def test_micro_batcher_reports_a_failed_batch(serving, monkeypatch):
    def broken(batch):
        raise RuntimeError("device lost")

    monkeypatch.setattr(serving, "dispatch", broken)
    req = make_request(np.random.default_rng(3), 2)
    batcher = MicroBatcher(serving, timeout_ms=1.0)
    try:
        batcher.submit(req)
        assert req.done.wait(timeout=30)
    finally:
        batcher.stop()
    assert req.result is None
    assert req.error == "RuntimeError: device lost"


ISOLATED = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "reftr_tpu"):
        sys.modules[name] = None  # any import of them now fails
    import numpy as np
    import reftr_torch
    names = [m.name for m in pkgutil.walk_packages(reftr_torch.__path__,
                                                   "reftr_torch.")]
    for name in names:
        importlib.import_module(name)
    from reftr_torch.core.config import *
    from reftr_torch.serve import MicroBatcher, Request, ServingModel
    cfg = RefTRConfig(model=ModelConfig(
        bert=BertConfig.tiny(), enc_layers=1, dec_layers=1,
        dim_feedforward=32, hidden_dim=32, nheads=2))
    model = ServingModel(cfg, batch_size=2, device="cpu")
    rng = np.random.default_rng(0)
    sv = np.zeros((1, 6), np.int32); sv[0, :4] = 1
    req = Request(rows={
        "image": rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8),
        "image_valid": np.ones((1, 64, 64), bool),
        "sentence": rng.integers(1, 512, (1, 6)).astype(np.int32),
        "sentence_valid": sv}, k=1, orig_hw=(64, 64), valid_hw=(64, 64))
    batcher = MicroBatcher(model)
    batcher.submit(req)
    assert req.done.wait(timeout=60)
    batcher.stop()
    assert req.error is None, req.error
    assert all(np.isfinite(req.result[0]["box_xyxy"]))
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "flax", "optax", "reftr_tpu") and sys.modules[m]]
    assert not bad, bad
    print("isolated", len(names))
""")


def test_package_runs_without_jax_or_reftr_tpu():
    proc = subprocess.run([sys.executable, "-c", ISOLATED], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("isolated")
    assert int(proc.stdout.split()[1]) >= 20  # every module was imported
