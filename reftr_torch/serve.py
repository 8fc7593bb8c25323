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
host collects and dispatches batch N+1 before it fetches N (with
``pipeline=False`` each batch is fetched before the next is dispatched).
The model runs in the batcher's thread only. An exception in a batch is
reported on each of its requests (``Request.error``), never raised in the
batcher's thread.

A request arrives here as model rows: canvases and token ids.
``tools/serve.py`` is the HTTP front end that makes them from an encoded
image and phrases (``Frontend``), and ``cli/predict.py`` the one-image
command line.

Usage::

    cfg = preset_config("refcoco_det", dtype="bfloat16")
    model = ServingModel(cfg, batch_size=8)            # on "cuda"
    batcher = MicroBatcher(model)
    req = Request(rows=..., k=1, orig_hw=(480, 640), valid_hw=(480, 640))
    batcher.submit(req); req.done.wait(); batcher.stop()
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Union

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


def box_pixels(pred_boxes: np.ndarray, orig_hw) -> np.ndarray:
    """Rows' boxes [k, Q, 4], normalised cxcywh on the image's extent ->
    query 0's xyxy in the original image's pixels [k, 4]: the extent is
    the original resized (data/transforms.py)."""
    boxes = decode_boxes(torch.from_numpy(
        pred_boxes.astype(np.float32)))[:, 0].numpy()
    h0, w0 = orig_hw
    return boxes * np.array([w0, h0, w0, h0], np.float32)


def answer(req: Request, out: Mapping[str, np.ndarray],
           row: int = 0) -> List[dict]:
    """The answer to ``req`` from a fetched batch ``out`` whose rows
    ``row`` to ``row + req.k`` are its own: per phrase the box in the
    original image's pixels to 2 decimals and, for RES, the mask's area
    and shape (``mask_to_original``)."""
    boxes = box_pixels(out["pred_boxes"][row:row + req.k], req.orig_hw)
    results = []
    for i, ph in enumerate(req.phrases or [""] * req.k):
        r = {"phrase": ph, "box_xyxy": [round(float(v), 2)
                                        for v in boxes[i]]}
        if "masks" in out:
            m = mask_to_original(out["masks"][row + i], req.valid_hw,
                                 req.orig_hw)
            r["mask_area_px"] = int(m.sum())
            r["mask_shape"] = list(m.shape)
        results.append(r)
    return results


def serving_module(cfg: RefTRConfig,
                   device: Union[str, torch.device] = "cuda",
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                   seed: int = 0, resume: str = "",
                   calib_batches: Optional[Sequence] = None,
                   print_fn=print) -> torch.nn.Module:
    """The serving model of ``cfg`` on ``device``, in eval mode and cast to
    its compute dtype (``cast_to_compute_dtype``). Weights come from
    ``state_dict`` (for example ``convert.from_flax`` of a reftr_tpu
    checkpoint) or, without one, from ``init_params`` with a generator
    seeded by ``seed``; then ``resume`` (a URL, a reference ``.pth`` or a
    checkpoint of the port) is merged in non-strictly by
    ``train.loop.load_pretrained``, as the JAX server loads its weights
    (reftr_tpu/tools/export_model.py:147-176). With the config's backbone
    folds (``--fold_bn``, ``--fold_normalize``, ...) the model is the
    folded one and a standard checkpoint is folded as it loads.

    With ``quantize_int8`` the weights above are the fp twin's: it is cast
    to the compute dtype, ``calib_batches`` ((batch, targets) pairs of
    numpy arrays; by default JAX's one synthetic batch,
    ``synthetic_calibration``) run through it, and the int8 model is built
    from its float32 weights and the calibrated scales
    (``nn/quant.py::calibrate_and_quantize``, as
    reftr_tpu/tools/export_model.py:177-198).

    With ``quantize_train_prefix`` and no ``state_dict`` the model is built
    from the ``resume`` checkpoint of a prefix-trained run, which holds
    its int8 layer1 (JAX builds the prefix model and loads the checkpoint
    into it, reftr_tpu/tools/export_model.py:155-173); its names must be
    the model's."""
    mc = cfg.model
    fp_mc = dataclasses.replace(mc, quantize_int8=False)
    if mc.quantize_train_prefix and state_dict is None:
        if not resume:
            raise ValueError("a quantize_train_prefix model is served from "
                             "the checkpoint of its training run: pass "
                             "--resume")
        from reftr_torch.core.checkpoint import load_checkpoint

        state_dict, resume = load_checkpoint(resume)["model"], ""
    model = build_model(fp_mc, resolve_device(device), state_dict, seed)
    if resume:
        from reftr_torch.train.loop import load_pretrained

        load_pretrained(model, resume, cfg)
    if not mc.quantize_int8:
        return model.eval().cast_to_compute_dtype()
    from reftr_torch.nn.quant import calibrate_and_quantize

    weights = model.state_dict()  # float32: the cast below replaces them
    model.eval().cast_to_compute_dtype()
    if calib_batches is None:
        calib_batches = [(synthetic_calibration(cfg), None)]
        print_fn("int8 PTQ: no calibration batches supplied; calibrating "
                 "on one synthetic batch")
    qweights = calibrate_and_quantize(cfg, model, iter(calib_batches),
                                      n_batches=len(calib_batches),
                                      print_fn=print_fn, state_dict=weights)
    del model, weights
    return build_model(mc, resolve_device(device), qweights).eval(
    ).cast_to_compute_dtype()


def synthetic_calibration(cfg: RefTRConfig, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """JAX's calibration batch when none is given (reftr_tpu/tools/
    export_model.py:177-193): one row of random uint8 pixels, the whole
    image valid, random token ids in [1, vocab) of which the first 8 are
    valid; multi-phrase inputs all zero, as JAX leaves them."""
    d = cfg.data
    hw, s = d.max_img_size, (d.max_sentence_len if d.multi_phrase
                             else d.max_query_len)
    rng = np.random.default_rng(seed)
    batch = {
        "image": rng.integers(0, 255, size=(1, hw, hw, 3)).astype(np.uint8),
        "image_valid": np.ones((1, hw, hw), bool),
        "sentence": rng.integers(1, cfg.model.bert.vocab_size,
                                 size=(1, s)).astype(np.int32),
        "sentence_valid": np.zeros((1, s), np.int32)}
    batch["sentence_valid"][:, :8] = 1
    if d.multi_phrase:
        p, sp = d.max_num_phrases, d.phrase_seq_len
        batch.update({k: np.zeros(shape, np.int32) for k, shape in (
            ("phrases", (1, p, sp)), ("phrase_valid", (1, p, sp)),
            ("phrase_pos_l", (1, p)), ("phrase_pos_r", (1, p)))})
    return batch


class ServingModel:
    """RefTR (RefTRSeg with ``masks``) on its device at a static batch
    size: the live model of ``serving_module`` or, with ``exported_dir``,
    the program ``tools/export_model.py`` saved there, whose manifest
    gives the batch size and ``masks`` (as in
    reftr_tpu/tools/serve.py:68-95) and whose device must be ``device``
    (an exported program runs on the device it was traced on). With
    ``quantize_int8`` in the config the live model is the int8 one that
    ``calib_batches`` calibrate (``serving_module``); an int8 artefact
    serves as any other."""

    def __init__(self, cfg: RefTRConfig, batch_size: int,
                 device: Union[str, torch.device] = "cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, resume: str = "", exported_dir: str = "",
                 calib_batches: Optional[Sequence] = None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.masks = bool(cfg.model.masks)
        self.device = resolve_device(device)
        if exported_dir:
            from reftr_torch.tools.export_model import (load_exported,
                                                        read_manifest)

            platforms = read_manifest(exported_dir)["platforms"]
            if platforms != [self.device.type]:
                raise ValueError(
                    f"{exported_dir} was exported for {platforms}, not "
                    f"{self.device.type}: an exported program runs on the "
                    f"device it was traced on")
            self.model, manifest = load_exported(exported_dir)
            self.batch_size = int(manifest["batch_size"])
            self.masks = bool(manifest["model"]["masks"])
        else:
            self.model = serving_module(cfg, self.device, state_dict, seed,
                                        resume, calib_batches)

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
        if self.masks:
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
    its first row arrived. ``pipeline=False`` fetches each batch before
    the next dispatch."""

    def __init__(self, model: ServingModel, timeout_ms: float = 5.0,
                 pipeline: bool = True):
        self.model = model
        self.timeout_s = timeout_ms / 1e3
        self.pipeline = pipeline
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
            if self.pipeline:
                inflight = (group, out)
            else:
                self._finish(group, out)
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
        row = 0
        for g in group:
            g.result = answer(g, out, row)
            self.stats["requests"] += 1
            self.stats["rows"] += g.k
            row += g.k
            g.done.set()
