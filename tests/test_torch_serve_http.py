"""The port's HTTP front end (reftr_torch/tools/serve.py), ``predict``
(cli/predict.py) and the visual dumps (tools/visualize.py, evaluate's
``--visualize``) against reftr_tpu's, on the CPU.

Both packages serve the same reference ``.pth`` (seeded random weights,
written by ``nn/convert.save_reference_checkpoint``) at
tests/test_serve.py::tiny_cfg's widths (d=32, 2+2 VL layers, BERT-tiny,
64 px; RES at d=128, 8 heads), the port with ``device="cpu"``, and get the
same requests: a JPEG and a PNG made by PIL with 1-3 phrases. Tolerances:
the JSON boxes 1e-3 px (both round to 0.01 px; the forwards agree to
1e-4 of the unit box, tests/test_torch_model.py, here some 1e-5 px);
the RES mask's area and shape exact; status codes, drawn pixels and file
names exact.
"""

import base64
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from reftr_tpu.cli import predict as jax_predict
from reftr_tpu.cli import presets as jax_presets
from reftr_tpu.cli.main import args_to_config as jax_args_to_config
from reftr_tpu.models.build import build_model as jax_build_model
from reftr_tpu.tools import serve as jax_serve
from reftr_tpu.tools import visualize as jax_visualize
from reftr_tpu.train import engine as jax_engine
from reftr_torch.cli import main as cli
from reftr_torch.cli import predict
from reftr_torch.cli.presets import apply_preset
from reftr_torch.convert import from_flax
from reftr_torch.nn.convert import save_reference_checkpoint
from reftr_torch.tools import serve, visualize
from reftr_torch.train import engine
from reftr_torch.train.loop import build_tokenizer
from test_torch_model import tiny_batch
from torch_parity_utils import random_flax_params

torch.set_num_threads(1)
BOX_TOL = 1e-3  # px
MODELS = {
    "rec": ["--preset", "synthetic_smoke", "--hidden_dim", "32",
            "--dim_feedforward", "64"],
    "res": ["--preset", "synthetic_smoke", "--masks", "--hidden_dim", "128",
            "--nheads", "8", "--dim_feedforward", "64"],
}


def parse_both(argv, port_parser, jax_parser):
    """(JAX config, port config) of one command line."""
    pa = port_parser().parse_args(argv + ["--device", "cpu"])
    apply_preset(pa, "synthetic_smoke", argv)
    ja = jax_parser().parse_args(argv)
    jax_presets.apply_preset(ja, "synthetic_smoke", argv)
    return jax_args_to_config(ja), cli.args_to_config(pa)


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    """name -> the .pth of seeded random weights of MODELS[name]."""
    root = tmp_path_factory.mktemp("pth")
    out = {}
    for name, argv in MODELS.items():
        jcfg, pcfg = parse_both(argv, serve.get_args_parser,
                                jax_serve.get_args_parser)
        jax_model, _ = jax_build_model(jcfg)
        params = random_flax_params(jax_model, tiny_batch(), seed=11)
        out[name] = save_reference_checkpoint(
            str(root / f"{name}.pth"), from_flax(params, pcfg.model),
            pcfg.model)
    return out


def encode(img: np.ndarray, fmt: str) -> str:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def requests():
    rng = np.random.default_rng(0)
    return [
        {"image_b64": encode(rng.integers(0, 256, (48, 64, 3), np.uint8),
                             "JPEG"),
         "phrases": ["the red box", "a thing"]},
        {"image_b64": encode(rng.integers(0, 256, (80, 56, 3), np.uint8),
                             "PNG"),
         "phrases": ["the left person"]},
        {"image_b64": encode(rng.integers(0, 256, (40, 64, 3), np.uint8),
                             "JPEG"),
         "phrases": ["one", "Two Words", "the third phrase here"]},
    ]


def call(url, payload=None, method="POST"):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class Running:
    """A build_server pair (server, batcher) served from a thread."""

    def __init__(self, pair):
        self.server, self.batcher = pair
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.batcher.stop()
        self.server.server_close()


@pytest.fixture(scope="module", params=sorted(MODELS))
def servers(request, pths):
    name = request.param
    argv = MODELS[name] + ["--resume", pths[name]]
    jcfg, pcfg = parse_both(argv, serve.get_args_parser,
                            jax_serve.get_args_parser)
    kw = dict(host="127.0.0.1", port=0, serve_batch=4, batch_timeout_ms=20.0)
    pair = (Running(jax_serve.build_server(jcfg, **kw)),
            Running(serve.build_server(pcfg, device="cpu", **kw)))
    yield name, pair
    for s in pair:
        s.close()


def test_http_answers_as_jax(servers):
    name, (jax_srv, port_srv) = servers
    for payload in requests():
        (jcode, jbody), (pcode, pbody) = (call(s.url + "/predict", payload)
                                          for s in (jax_srv, port_srv))
        assert jcode == pcode == 200, (jbody, pbody)
        assert len(jbody["results"]) == len(pbody["results"])
        for j, p in zip(jbody["results"], pbody["results"]):
            assert p["phrase"] == j["phrase"]
            np.testing.assert_allclose(p["box_xyxy"], j["box_xyxy"],
                                       atol=BOX_TOL, rtol=0)
            if name == "res":
                assert p["mask_area_px"] == j["mask_area_px"]
                assert p["mask_shape"] == j["mask_shape"]
            else:
                assert "mask_area_px" not in p
    (_, jh), (_, ph) = (call(s.url + "/healthz", method="GET")
                        for s in (jax_srv, port_srv))
    assert ph == jh == {"ok": True, "batch_size": 4, "masks": name == "res"}
    (_, js), (_, ps) = (call(s.url + "/stats", method="GET")
                        for s in (jax_srv, port_srv))
    assert set(ps) == set(js)
    assert ps["requests"] == js["requests"] == 3
    assert ps["rows"] == js["rows"] == 6


def test_http_errors_as_jax(servers):
    _, (jax_srv, port_srv) = servers
    img = requests()[0]["image_b64"]
    cases = [("/predict", {"image_b64": img}, "POST"),
             ("/predict", {"phrases": ["x"]}, "POST"),
             ("/predict", {"image_b64": "zzz", "phrases": ["x"]}, "POST"),
             ("/nowhere", {"phrases": ["x"]}, "POST"),
             ("/nowhere", None, "GET"),
             ("/predict", {"image_b64": img,
                           "phrases": [f"p{i}" for i in range(5)]}, "POST")]
    codes = []
    for path, payload, method in cases:
        (jcode, jbody), (pcode, pbody) = (
            call(s.url + path, payload, method) for s in (jax_srv, port_srv))
        assert pcode == jcode, (path, payload, jbody, pbody)
        codes.append(pcode)
        if pcode == 500:
            assert "5 phrases > serve batch 4" in pbody["error"]
    assert codes == [400, 400, 400, 404, 404, 500]


def test_http_without_pil_answers_400(servers, monkeypatch):
    """No fallback decoder: without PIL (as on the card's machine)
    decode_image raises ModuleNotFoundError and the client gets 400."""
    _, (_, port_srv) = servers
    payload = requests()[1]
    monkeypatch.setitem(sys.modules, "PIL", None)
    code, body = call(port_srv.url + "/predict", payload)
    assert code == 400 and body["error"].startswith("ModuleNotFoundError")


def test_decode_image_reads_what_pil_wrote():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (21, 34, 3), np.uint8)
    got = serve.decode_image(base64.b64decode(encode(img, "PNG")))
    np.testing.assert_array_equal(got, img)
    gray = serve.decode_image(base64.b64decode(encode(img[..., 0], "PNG")))
    assert gray.shape == (21, 34, 3)


def test_predict_prints_what_jax_prints(pths, tmp_path, capsys,
                                        monkeypatch):
    """Both packages' predict.main on one JPEG and the same .pth: the same
    JSON lines; the port's --output equals JAX's draw_boxes of the boxes
    it drew."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (96, 128, 3), np.uint8)
    img_path = str(tmp_path / "in.jpg")
    Image.fromarray(img).save(img_path)
    argv = MODELS["rec"] + ["--resume", pths["rec"], "--image", img_path,
                            "--phrase", "a red box",
                            "--phrase", "the left thing"]
    assert jax_predict.main(argv) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]

    drawn = []
    draw = visualize.draw_boxes
    monkeypatch.setattr(visualize, "draw_boxes",
                        lambda im, b: drawn.append((im, b)) or draw(im, b))
    out_path = str(tmp_path / "out.jpg")
    assert predict.main(argv + ["--device", "cpu", "--output",
                                out_path]) == 0
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert [g["phrase"] for g in got] == [w["phrase"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"],
                                   atol=BOX_TOL, rtol=0)
    ((image, boxes),) = drawn
    # the decoded input (JPEG, so not ``img``) and the boxes it printed
    np.testing.assert_allclose(boxes, [g["box_xyxy"] for g in got],
                               atol=5e-3, rtol=0)
    jax_path = str(tmp_path / "jax.jpg")
    jax_visualize.draw_boxes(image, boxes).save(jax_path, quality=92)
    np.testing.assert_array_equal(np.asarray(Image.open(out_path)),
                                  np.asarray(Image.open(jax_path)))


def test_draw_and_heatmap_equal_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 60, 3), np.uint8)
    boxes = np.array([[3.3, 4.7, 30.2, 20.5], [10, 12, 58, 39]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(visualize.draw_boxes(img, boxes)),
        np.asarray(jax_visualize.draw_boxes(img, boxes)))
    att = rng.normal(size=(7, 9))
    np.testing.assert_array_equal(np.asarray(visualize.heatmap_image(att)),
                                  np.asarray(jax_visualize.heatmap_image(att)))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_evaluate_visualize_writes_jax_file_names(tmp_path, monkeypatch):
    """--eval --visualize on the RES smoke model: the port's dumps under
    <output_dir>/vis/ carry the names JAX's _dump_visuals gives the same
    batches and outputs (boxes, mask, gt_mask and one attention map a
    head, for the first 64 samples)."""
    jax_dir = tmp_path / "jax"
    dump = engine._dump_visuals

    def both(out_dir, idx, samples, targets, out):
        dump(out_dir, idx, samples, targets, out)
        jax_engine._dump_visuals(
            str(jax_dir), idx, samples, targets,
            {k: v.float().numpy() for k, v in out.items()
             if isinstance(v, torch.Tensor)})

    monkeypatch.setattr(engine, "_dump_visuals", both)
    out = tmp_path / "port"
    assert cli.main(MODELS["res"] + [
        "--device", "cpu", "--eval", "--visualize", "--output_dir", str(out),
        "--enc_layers", "1", "--dec_layers", "1", "--num_workers", "0"]) == 0
    got = _files(out / "vis")
    assert got == _files(jax_dir / "vis")
    assert len([f for f in got if f.startswith("boxes")]) == 64
    assert len([f for f in got if f.startswith("att")]) == 64 * 8


def test_micro_batcher_without_pipelining_answers_the_same(pths):
    """MicroBatcher(pipeline=False), JAX's fetch-before-the-next-dispatch
    mode: no batch overlaps another, and every request gets the boxes the
    pipelined batcher gives it (the same rows in the same batches)."""
    from reftr_torch.serve import MicroBatcher, ServingModel

    _, pcfg = parse_both(MODELS["rec"] + ["--resume", pths["rec"]],
                         serve.get_args_parser, jax_serve.get_args_parser)
    model = ServingModel(pcfg, 4, device="cpu", resume=pcfg.train.resume)
    fe = serve.Frontend(pcfg, build_tokenizer(pcfg))
    results = {}
    for pipeline in (True, False):
        reqs = [fe.preprocess(p) for p in requests()]
        batcher = MicroBatcher(model, timeout_ms=20.0, pipeline=pipeline)
        try:
            for r in reqs:
                batcher.submit(r)
            for r in reqs:
                assert r.done.wait(timeout=120) and r.error is None
        finally:
            batcher.stop()
        if not pipeline:
            assert batcher.stats["dispatch_overlaps"] == 0
        assert batcher.stats["requests"] == len(reqs)
        results[pipeline] = [r.result for r in reqs]
    assert results[True] == results[False]
