"""Micro-batching serving runtime on the card (port of the model side of
reftr_tpu/tools/serve.py:51-262).

``ServingModel`` holds a RefTR (RefTRSeg with ``masks``) on its device at
a static batch size; ``dispatch`` starts the batched forward and returns
without waiting, ``fetch`` waits for it and brings the boxes (and the
masks) to the host. A RES model answers each phrase with a box and a
mask: the mask logits upsampled to the canvas and thresholded on the
device (``segm_masks``), then on the host cropped to the image's extent
and nearest-resampled to its original size with floor indices, reported
as ``mask_area_px`` and ``mask_shape`` (reftr_tpu/tools/serve.py:
246-255). ``MicroBatcher``
collects request rows into such batches: a batch runs when it is full or
``timeout_ms`` after its first row arrived, and while batch N computes the
host collects and dispatches batch N+1 before it fetches N. An exception
in a batch is reported on each of its requests (``Request.error``), never
raised in the batcher's thread.

A request arrives as model rows: canvases and token ids. The HTTP
frontend, image decoding and the tokenizer (reftr_tpu's ``Frontend``) come
with a later slice.

Usage::

    cfg = preset_config("refcoco_det", dtype="bfloat16")
    model = ServingModel(cfg, batch_size=8)            # on "cuda"
    batcher = MicroBatcher(model)
    req = Request(rows=..., k=1, orig_hw=(480, 640), valid_hw=(480, 640))
    batcher.submit(req); req.done.wait(); batcher.stop()
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from reftr_torch.convert import build_model
from reftr_torch.core.config import RefTRConfig
from reftr_torch.core.device import resolve_device
from reftr_torch.models.postprocess import decode_boxes, segm_masks


@dataclass
class Request:
    """One client request = ``k`` model rows (one per phrase), atomic in a
    batch so a response never spans two dispatches.

    rows: image [k,H,W,3] uint8, image_valid [k,H,W] bool, sentence [k,S]
    int token ids, sentence_valid [k,S]. orig_hw is the image's size before
    resizing and valid_hw its resized extent on the canvas."""

    rows: Dict[str, np.ndarray]
    k: int
    orig_hw: tuple
    valid_hw: tuple
    phrases: List[str] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[dict]] = None
    error: Optional[str] = None


def pad_batch(group: List[Request], batch_size: int
              ) -> Dict[str, np.ndarray]:
    """Concatenate the rows of ``group`` and pad them to ``batch_size``.

    Padding rows stay well-formed: [CLS] and one more token valid (the
    model's [CLS]/[SEP] context rule) and the whole image valid. Their
    outputs are discarded."""
    batch = {}
    for k in group[0].rows:
        rows = np.concatenate([g.rows[k] for g in group], axis=0)
        pad = np.zeros((batch_size - rows.shape[0],) + rows.shape[1:],
                       rows.dtype)
        batch[k] = np.concatenate([rows, pad], axis=0)
    n = sum(g.k for g in group)
    batch["sentence_valid"][n:, :2] = 1
    batch["image_valid"][n:] = True
    return batch


def mask_to_original(mask: np.ndarray, valid_hw, orig_hw) -> np.ndarray:
    """A canvas mask [S, S] cropped to the resized image's extent
    ``valid_hw`` and nearest-resampled to ``orig_hw``, src = floor(dst *
    in/out)."""
    oh, ow = valid_hw
    h0, w0 = orig_hw
    m = mask[:oh, :ow]
    ys = np.floor(np.arange(h0) * (oh / h0)).astype(np.int64)
    xs = np.floor(np.arange(w0) * (ow / w0)).astype(np.int64)
    return m[ys][:, xs]


class ServingModel:
    """RefTR (RefTRSeg with ``masks``) on its device at a static batch
    size.

    Weights come from ``state_dict`` (for example ``convert.from_flax`` of
    a reftr_tpu checkpoint) or, without one, from ``init_params`` with a
    generator seeded by ``seed``."""

    def __init__(self, cfg: RefTRConfig, batch_size: int,
                 device: Union[str, torch.device] = "cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.model = build_model(cfg.model, self.device, state_dict,
                                 seed).eval().cast_to_compute_dtype()

    def to_device(self, batch: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in batch.items()}

    @torch.inference_mode()
    def dispatch(self, batch: Mapping[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """Start the forward on the device; returns device tensors
        without waiting for them: the boxes and, for RES, the masks on the
        canvas ([B, S, S] bool, query 0)."""
        out = self.model(self.to_device(batch))
        kept = {"pred_boxes": out["pred_boxes"]}
        if self.cfg.model.masks:
            # the canvas the batch came on (max_img_size in a server)
            canvas = tuple(batch["image"].shape[1:3])
            kept["masks"] = segm_masks(out["pred_masks"][:, :1], canvas)[:, 0]
        return kept

    @staticmethod
    def fetch(out: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in out.items()}

    def __call__(self, batch: Mapping[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        return self.fetch(self.dispatch(batch))


class MicroBatcher:
    """Collects request rows into static-shape batches and runs the model.

    Flush policy: the batch runs when it is full or ``timeout_ms`` after
    its first row arrived."""

    def __init__(self, model: ServingModel, timeout_ms: float = 5.0):
        self.model = model
        self.timeout_s = timeout_ms / 1e3
        self.q: "queue.Queue[Request]" = queue.Queue()
        self.stats = {"requests": 0, "rows": 0, "batches": 0,
                      "rows_in_batches": 0, "dispatch_overlaps": 0}
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="reftr-microbatcher")
        self.thread.start()

    def submit(self, req: Request) -> None:
        if req.k > self.model.batch_size:
            req.error = (f"request has {req.k} phrases > serve batch "
                         f"{self.model.batch_size}")
            req.done.set()
            return
        self.q.put(req)

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=5)

    def _run(self) -> None:
        inflight = None  # (group, device_out)
        while not self._stop.is_set():
            if inflight is not None:
                try:
                    first = self.q.get_nowait()
                except queue.Empty:
                    self._finish(*inflight)
                    inflight = None
                    continue
            else:
                try:
                    first = self.q.get(timeout=0.05)
                except queue.Empty:
                    continue
            group = [first]
            used = first.k
            deadline = time.perf_counter() + self.timeout_s
            while used < self.model.batch_size:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if used + nxt.k > self.model.batch_size:
                    self.q.put(nxt)  # atomic requests: next batch
                    break
                group.append(nxt)
                used += nxt.k
            try:
                out = self.model.dispatch(pad_batch(group,
                                                     self.model.batch_size))
            except Exception as e:  # noqa: BLE001 — report to the client
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()
                continue
            if inflight is not None:
                self.stats["dispatch_overlaps"] += 1
                self._finish(*inflight)  # overlaps `group` on the device
            inflight = (group, out)
        if inflight is not None:
            self._finish(*inflight)

    def _finish(self, group: List[Request], device_out) -> None:
        """Fetch a dispatched batch's results and complete its requests."""
        try:
            self._postprocess(group, self.model.fetch(device_out))
        except Exception as e:  # noqa: BLE001 — report to the client
            for r in group:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()

    def _postprocess(self, group: List[Request], out) -> None:
        self.stats["batches"] += 1
        self.stats["rows_in_batches"] += self.model.batch_size
        boxes = decode_boxes(torch.from_numpy(
            out["pred_boxes"].astype(np.float32)))[:, 0].numpy()  # [B, 4]
        row = 0
        for g in group:
            h0, w0 = g.orig_hw
            scale = np.array([w0, h0, w0, h0], np.float32)
            phrases = g.phrases or [""] * g.k
            g.result = []
            for i, ph in enumerate(phrases):
                r = {"phrase": ph,
                     "box_xyxy": [round(float(v), 2)
                                  for v in boxes[row + i] * scale]}
                if "masks" in out:
                    m = mask_to_original(out["masks"][row + i], g.valid_hw,
                                         g.orig_hw)
                    r["mask_area_px"] = int(m.sum())
                    r["mask_shape"] = list(m.shape)
                g.result.append(r)
            self.stats["requests"] += 1
            self.stats["rows"] += g.k
            row += g.k
            g.done.set()
