"""The HTTP front end of the server (port of reftr_tpu/tools/serve.py:
264-422), stdlib only.

``Frontend`` turns a JSON request into model rows: the image decoded
(``decode_image``, PIL), the eval transform (aspect-preserving resize,
canvas, validity mask; ``data/transforms.py``) and one tokenised row per
phrase. ``serve.MicroBatcher`` batches the rows to the static serve batch
and runs the model on the card in its own thread; the handler's threads
only parse requests and wait.

API (JSON over HTTP):
  POST /predict {"image_b64": <base64 JPEG/PNG>, "phrases": ["...", ...]}
             -> {"results": [{"phrase", "box_xyxy"[, "mask_area_px",
                 "mask_shape"]}, ...]}  (boxes in the image's pixels)
  GET  /healthz -> {"ok": true, "batch_size", "masks"}
  GET  /stats   -> {"requests", "rows", "batches", "rows_in_batches",
                    "dispatch_overlaps", "mean_batch_fill"}
Errors: 400 for a request that cannot be parsed or decoded, 404 for an
unknown path, 500 for a batch that failed (more phrases than the serve
batch, for one), 503 when the answer took longer than the handler waits.

Usage::

    python -m reftr_torch.tools.serve --preset refcoco_det \\
        --resume <checkpoint, reference .pth, or URL> --port 8080 \\
        --serve_batch 16 --batch_timeout_ms 5      # on "cuda"
    python -m reftr_torch.tools.serve --preset synthetic_smoke \\
        --device cpu --port 8080

The weights come from ``--resume`` through ``train.loop.load_pretrained``;
without it the server warns and serves a seeded init. ``--exported DIR``
serves the program ``tools/export_model.py`` saved in DIR instead, at the
batch size of its manifest (``--serve_batch`` is not read), on the device
it was exported for::

    python -m reftr_torch.tools.serve --preset refcoco_det \
        --exported exported/ --port 8080

With ``--fold_bn --fold_normalize`` (the JAX package's serving command,
reftr_tpu/tools/serve.py:28) the live model loads the checkpoint folded
(``nn/fold.py``) and takes the uint8 canvases as they are.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from reftr_torch.serve import MicroBatcher, Request, ServingModel


def decode_image(data: bytes) -> np.ndarray:
    """An encoded image (JPEG, PNG, ...) -> [H, W, 3] uint8 RGB, by PIL."""
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


class Frontend:
    """Request parsing and preprocessing: the eval transform and the
    tokenizer of the eval path, so a served box is the ``--eval`` box."""

    def __init__(self, cfg, tokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer

    def preprocess(self, payload: dict) -> Request:
        phrases = payload.get("phrases") or []
        if not phrases or not isinstance(phrases, list):
            raise ValueError("payload needs a non-empty 'phrases' list")
        if "image_b64" not in payload:
            raise ValueError("payload needs 'image_b64'")
        return self.rows(decode_image(base64.b64decode(payload["image_b64"])),
                         phrases)

    def rows(self, img: np.ndarray, phrases) -> Request:
        """An [H, W, 3] uint8 image and its phrases -> a Request of one
        row per phrase: the image's uint8 canvas and validity mask, each
        phrase's token ids. Any other image raises (a 400): the model
        normalises uint8 canvases on the device, or under
        ``fold_normalize`` takes them as they are, and would read a float
        image as normalised already (or, folded, refuse it)."""
        from reftr_torch.data.transforms import transform_sample

        img = np.asarray(img)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"an image must be [H, W, 3] uint8 RGB, not "
                             f"{img.dtype} of shape {img.shape}")

        d = self.cfg.data
        ts = transform_sample(img, np.zeros((0, 4), np.float32),
                              d.img_size, d.max_img_size, train=False)
        oh, ow = ts.valid_hw
        valid = np.zeros((d.max_img_size, d.max_img_size), bool)
        valid[:oh, :ow] = True
        k = len(phrases)
        ids = np.zeros((k, d.max_query_len), np.int32)
        svalid = np.zeros((k, d.max_query_len), np.int32)
        for i, ph in enumerate(phrases):
            ii, mm, _ = self.tokenizer.encode(str(ph).lower(),
                                              d.max_query_len)
            ids[i], svalid[i] = ii, mm
        rows = {
            "image": np.broadcast_to(ts.canvas, (k,) + ts.canvas.shape
                                     ).copy(),
            "image_valid": np.broadcast_to(valid, (k,) + valid.shape).copy(),
            "sentence": ids,
            "sentence_valid": svalid,
        }
        return Request(rows=rows, k=k, orig_hw=ts.orig_hw,
                       valid_hw=ts.valid_hw,
                       phrases=[str(p) for p in phrases])


def make_handler(frontend: Frontend, batcher: MicroBatcher,
                 request_timeout_s: float = 60.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True,
                                 "batch_size": batcher.model.batch_size,
                                 "masks": batcher.model.masks})
            elif self.path == "/stats":
                s = dict(batcher.stats)
                s["mean_batch_fill"] = round(
                    s["rows"] / max(1, s["rows_in_batches"]), 4)
                self._send(200, s)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = frontend.preprocess(json.loads(self.rfile.read(n)))
            except Exception as e:  # noqa: BLE001 — the client's error
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            batcher.submit(req)
            if not req.done.wait(request_timeout_s):
                self._send(503, {"error": "timed out waiting for batch"})
                return
            if req.error:
                self._send(500, {"error": req.error})
                return
            self._send(200, {"results": req.result})

    return Handler


def build_server(cfg, host: str = "127.0.0.1", port: int = 8080,
                 serve_batch: int = 16, batch_timeout_ms: float = 5.0,
                 exported_dir: str = "", device: str = "cuda"):
    """(server, batcher) serving ``cfg`` with the weights of
    ``cfg.train.resume`` on ``device``, or the exported program in
    ``exported_dir`` at its manifest's batch size; the caller runs
    ``server.serve_forever()`` and stops the batcher after. The front end
    (the eval transform and the tokenizer) follows ``cfg`` either way."""
    from reftr_torch.train.loop import build_tokenizer

    if not cfg.train.resume and not exported_dir:
        print("WARNING: no --resume checkpoint; serving random weights "
              "(a smoke run)", file=sys.stderr)
    model = ServingModel(cfg, serve_batch, device=device,
                         resume=cfg.train.resume, exported_dir=exported_dir)
    batcher = MicroBatcher(model, batch_timeout_ms)
    frontend = Frontend(cfg, build_tokenizer(cfg))
    server = ThreadingHTTPServer((host, port), make_handler(frontend,
                                                            batcher))
    return server, batcher


def get_args_parser() -> argparse.ArgumentParser:
    from reftr_torch.cli.main import get_args_parser as base_parser

    p = argparse.ArgumentParser("RefTR HTTP server on PyTorch",
                                parents=[base_parser()])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--serve_batch", type=int, default=16,
                   help="static micro-batch size")
    p.add_argument("--batch_timeout_ms", type=float, default=5.0,
                   help="flush a partial batch this long after its first "
                        "row arrives")
    p.add_argument("--exported", default="",
                   help="serve the program tools/export_model.py saved in "
                        "this directory (its batch size and device) instead "
                        "of the --resume weights")
    return p


def main(argv=None) -> int:
    from reftr_torch.cli.main import args_to_config
    from reftr_torch.cli.presets import apply_preset

    args = get_args_parser().parse_args(argv)
    if args.preset:
        apply_preset(args, args.preset, argv)
    cfg = args_to_config(args)
    server, batcher = build_server(
        cfg, args.host, args.port, args.serve_batch, args.batch_timeout_ms,
        exported_dir=args.exported, device=args.device)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}",
                      "batch_size": batcher.model.batch_size,
                      "device": str(batcher.model.device),
                      "backend": "exported" if args.exported else "live"}),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
