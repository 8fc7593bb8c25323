"""The training driver (port of reftr_tpu/train/loop.py:48-395), on one
card or on many under DDP, one process each.

``run_training`` is main_vg.py:167-431 of the reference RefTR:

  * the process group of ``core/distributed.py::initialize`` when the
    launcher (``reftr_torch.tools.launch``) or Slurm announced one, on
    ``cuda:LOCAL_RANK`` (an explicit ``cuda:N`` stays as given) or, with
    ``device="cpu"``, over gloo on the host;
  * the host seed np.random.seed(seed + rank) (:174-177), and loaders
    that give each rank its own shard (``parallel/sharding.py``);
  * the tokenizer, the loaders, the model and optimizer (``TrainState``);
  * a pretrained init (``load_pretrained``: a URL, a reference ``.pth``
    by ``nn/convert.py``, or a checkpoint of the port), merged
    non-strictly with a report of missing and unexpected keys (:298-349);
  * resume, or auto-resume from <output_dir>/checkpoint (:299-303), or
    the weights alone (resume_model_only), read by every rank onto its own
    card; a URL resume (:307-309) restores the model's weights only;
  * epochs of training with an eval of every test split after each, the
    best checkpoint on the first split's accuracy_iou0.5 (:399-412), the
    periodic checkpoint{epoch:04d} on lr_drop and ckpt_cycle boundaries
    (:373-376), one JSON line per epoch in log.txt (:419-421), and
    <dataset>_<split>_result.json with each split's boxes; every file is
    written by rank 0, with the stats of all ranks;
  * eval only (:351-361), and run_epoch chunks for time-limited queues.

It runs on "cuda" unless the caller passes ``device="cpu"``; without a
card it raises.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Union

import numpy as np
import torch

from reftr_torch.core import checkpoint as ckpt_lib
from reftr_torch.core import distributed, hub
from reftr_torch.core.config import RefTRConfig
from reftr_torch.core.device import resolve_device
from reftr_torch.core.logging import log_stats, master_print
from reftr_torch.data.build import build_refer_dataset
from reftr_torch.data.datasets import write_synthetic_vocab
from reftr_torch.data.loader import DataLoader
from reftr_torch.data.native import ByteLevelBPETokenizer, WordPieceTokenizer
from reftr_torch.data.samplers import NodeShardedSampler, ShardedSampler
from reftr_torch.models.criterion import weight_dict as build_weight_dict
from reftr_torch.nn.convert import convert_for, load_torch_checkpoint
from reftr_torch.nn.fold import optimize_backbone_in_tree
from reftr_torch.parallel.sharding import check_data_axis, loader_shards
from reftr_torch.train.engine import evaluate, train_one_epoch
from reftr_torch.train.state import TrainState
from reftr_torch.train.steps import make_eval_step, make_train_step

_TORCH_CHECKPOINTS = (".pth", ".pt", ".bin")


def build_tokenizer(cfg: RefTRConfig):
    """roberta-*: the byte-level BPE of vocab.json and merges.txt under
    <data_root>/<bert_model>, or <bert_model>, or <data_root>. Else the
    WordPiece vocabulary of ``bert_model``: the file it names, or
    <data_root>/<bert_model>/vocab.txt, or <data_root>/vocab.txt; for the
    synthetic fixtures without one, their own vocabulary."""
    if cfg.model.bert_model.split("-")[0] == "roberta":
        root = os.path.join(cfg.data.data_root, cfg.model.bert_model)
        for base in (root, cfg.model.bert_model, cfg.data.data_root):
            vocab = os.path.join(base, "vocab.json")
            merges = os.path.join(base, "merges.txt")
            if os.path.isfile(vocab) and os.path.isfile(merges):
                return ByteLevelBPETokenizer(vocab, merges)
        raise FileNotFoundError(
            f"no vocab.json/merges.txt for {cfg.model.bert_model} under "
            f"{cfg.data.data_root}")
    candidates = [
        cfg.model.bert_model,
        os.path.join(cfg.data.data_root, cfg.model.bert_model, "vocab.txt"),
        os.path.join(cfg.data.data_root, "vocab.txt"),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return WordPieceTokenizer(c)
    if cfg.data.dataset in ("synthetic", "synthetic_multi"):
        # the tokenizer reads the file when it is made
        with tempfile.TemporaryDirectory() as d:
            return WordPieceTokenizer(
                write_synthetic_vocab(os.path.join(d, "vocab.txt")))
    raise FileNotFoundError(
        f"no vocab.txt found (searched {candidates}); place the bert vocab "
        f"under the data root or pass an explicit file path as bert_model")


def build_loaders(cfg: RefTRConfig, tokenizer, num_shards: int = 1,
                  shard_rank: int = 0):
    """The train loader (shuffled, drop_last) and one loader per test
    split (in order, padded to a multiple of the shards), for shard
    ``shard_rank`` of ``num_shards`` (run_training: the rank of the world,
    ``sharding.loader_shards``); ``batch_size`` items a shard."""
    d, seed, masks = cfg.data, cfg.train.seed, cfg.model.masks
    train_ds = build_refer_dataset(d.train_split, d, tokenizer, train=True,
                                   masks=masks, seed=seed)
    shards = dict(num_replicas=num_shards, rank=shard_rank)
    if d.cache_mode:
        sampler = NodeShardedSampler(len(train_ds), local_rank=0,
                                     local_size=1, shuffle=True, seed=seed,
                                     **shards)
    else:
        sampler = ShardedSampler(len(train_ds), shuffle=True, seed=seed,
                                 **shards)
    train_loader = DataLoader(train_ds, d.batch_size, sampler=sampler,
                              num_workers=d.num_workers, drop_last=True)
    test_loaders = {}
    for split in d.test_splits:
        ds = build_refer_dataset(split, d, tokenizer, train=False,
                                 masks=masks, seed=seed)
        test_loaders[split] = DataLoader(
            ds, d.batch_size,
            sampler=ShardedSampler(len(ds), shuffle=False, **shards),
            num_workers=d.num_workers, drop_last=False)
    return train_loader, test_loaders


def load_pretrained(model: torch.nn.Module, path: str, cfg: RefTRConfig,
                    log=master_print) -> Dict[str, list]:
    """Merge the weights of ``path`` into ``model`` non-strictly and
    return the report of missing, unexpected and shape-skipped keys
    (reftr_tpu/train/loop.py:120-154). ``path`` is a URL (fetched into the
    cache by ``core/hub.py``), a reference ``.pth``/``.pt``/``.bin``
    (converted by ``nn/convert.py``; a DETR checkpoint gives the backbone
    and the encoder), or a checkpoint of the port. A converted checkpoint
    is standard, and its backbone is folded for the config's
    reparameterisations (``nn/fold.py::optimize_backbone_in_tree``, as
    reftr_tpu/train/loop.py:144-146); a checkpoint of the port holds the
    weights of the model that wrote it, folded already."""
    if hub.is_url(path):
        path = hub.download_checkpoint(path, progress_fn=log)
    if path.endswith(_TORCH_CHECKPOINTS):
        pretrained = optimize_backbone_in_tree(
            convert_for(load_torch_checkpoint(path), cfg.model), cfg.model)
    else:
        pretrained = ckpt_lib.load_checkpoint(path)["model"]
    return ckpt_lib.load_pretrained_nonstrict(model, pretrained, log=log)


def _save(out_dir: str, name: str, state: TrainState, full: bool,
          epoch: int, best: float, cfg: RefTRConfig) -> None:
    if not distributed.is_main_process():
        return
    t0 = time.perf_counter()
    path = ckpt_lib.save_checkpoint(out_dir, name, state, full=full,
                                    epoch=epoch, best_val_acc=best,
                                    config=cfg)
    master_print(f"checkpoint {name}: {os.path.getsize(path)} bytes saved "
                 f"in {time.perf_counter() - t0:.3f} s")


def train_device(device: Union[str, torch.device]) -> torch.device:
    """The device of this process: a bare "cuda" under the launcher is
    ``cuda:LOCAL_RANK``, an explicit ``cuda:N`` stays; a CUDA device is
    made current before anything touches the card (the kernels' build and
    their tensor maps, and DDP's reducer in autograd's thread, use the
    current device)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None
            and distributed.launch_env() is not None):
        dev = torch.device("cuda", distributed.local_rank())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def run_training(cfg: RefTRConfig,
                 device: Union[str, torch.device] = "cuda") -> Dict:
    """Train (or with ``eval_only`` evaluate) as ``cfg`` says on ``device``.
    Returns {"history": the log entries, "best_val_acc"} or, eval only,
    {"test": {split: stats}}; under DDP every rank returns the global
    stats."""
    dev = train_device(device)
    distributed.initialize(dev)
    check_data_axis(cfg.mesh.data, distributed.world_size())
    n_shards, shard_rank = loader_shards()
    if distributed.is_initialized():
        master_print(f"torch.distributed: backend "
                     f"{torch.distributed.get_backend()}, world size "
                     f"{n_shards}, rank {shard_rank} on {dev}")
    np.random.seed(cfg.train.seed + shard_rank)
    tokenizer = build_tokenizer(cfg)
    train_loader, test_loaders = build_loaders(cfg, tokenizer, n_shards,
                                               shard_rank)
    steps_per_epoch = len(train_loader)
    master_print(f"Steps per training epoch: {steps_per_epoch}")

    if cfg.model.fold_normalize and not cfg.train.eval_only:
        # the JAX package's warning (reftr_tpu/train/loop.py:206-214)
        master_print(
            "WARNING: --fold_normalize degrades TRAINING convergence "
            "(measured); use it for --eval/serving only and train with "
            "--space_to_depth_stem --fold_bn instead")
    t0 = time.perf_counter()
    # with backbone folds, the standard backbone's seeded init folded
    # (convert.build_model), and n_parameters that model's; a pretrained
    # load below replaces its weights
    state = TrainState.create(cfg.model, cfg.train, steps_per_epoch,
                              device=dev, seed=cfg.train.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in state.model.parameters())
    master_print(f"n_parameters: {n_params}; model built in "
                 f"{time.perf_counter() - t0:.3f} s")

    if cfg.train.pretrained_model:
        load_pretrained(state.model, cfg.train.pretrained_model, cfg)

    out_dir = cfg.train.output_dir
    start_epoch = cfg.train.start_epoch
    best_val_acc = 0.0
    resume = cfg.train.resume
    # rank 0 writes the checkpoints: no rank reads one before all arrive
    distributed.barrier()
    if (not resume and cfg.train.auto_resume and out_dir
            and ckpt_lib.checkpoint_exists(out_dir, "checkpoint")):
        resume = os.path.join(out_dir, "checkpoint")
    if resume and hub.is_url(resume):
        # the reference's URL checkpoints hold a torch optimizer of their
        # own module order: the weights alone are restored, as in JAX
        load_pretrained(state.model, resume, cfg)
        master_print(f"Resumed model weights from URL {resume}")
        resume = ""
    if resume and resume.endswith(_TORCH_CHECKPOINTS):
        raise ValueError(
            f"--resume {resume}: a reference .pth holds no state of this "
            f"port to resume; load its weights with --pretrained_model, or "
            f"give it to --resume as a URL")
    if resume:
        # every rank onto its own device; the checkpoint holds rank 0's
        # generator, which is every rank's (the rank is folded in at each
        # draw, train/steps.py)
        payload = ckpt_lib.load_checkpoint(resume, map_location=dev)
        state.model.load_state_dict(payload["model"])
        if not cfg.train.resume_model_only:
            if "optimizer" not in payload:
                raise ValueError(f"{resume} holds the weights only; resume "
                                 f"it with resume_model_only")
            state.restore(payload)
            start_epoch = int(payload["epoch"]) + 1
            best_val_acc = float(payload["best_val_acc"])
        master_print(f"Resumed from {resume} at epoch {start_epoch}, step "
                     f"{state.step}")

    m = cfg.model
    wdict = build_weight_dict(cfg.loss, m.dec_layers, m.aux_loss,
                              with_masks=m.masks, vision_aux=m.vision_aux,
                              heatmap_box=m.heatmap_box)
    train_step = make_train_step(state.model, wdict, cfg.loss, device=dev)
    eval_step = make_eval_step(state.model, cfg.loss, device=dev)

    def run_eval() -> Dict[str, Dict]:
        all_stats = {}
        for split, loader in test_loaders.items():
            vis_dir = (out_dir if cfg.train.eval_only and cfg.train.visualize
                       else "")
            stats, results = evaluate(eval_step, loader, weight_dict=wdict,
                                      collect_results=bool(out_dir),
                                      print_fn=master_print,
                                      visualize_dir=vis_dir)
            # unrounded, so a log can be checked against it
            master_print(f"[{split}] " + json.dumps(stats))
            if out_dir and distributed.is_main_process():
                os.makedirs(out_dir, exist_ok=True)
                name = f"{cfg.data.dataset}_{split}_result.json"
                with open(os.path.join(out_dir, name), "w") as f:
                    json.dump(results, f)
            all_stats[split] = stats
        return all_stats

    if cfg.train.eval_only:
        return {"test": run_eval()}

    end_epoch = min(cfg.train.epochs, start_epoch + cfg.train.run_epoch)
    history = []
    for epoch in range(start_epoch, end_epoch):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        state, train_stats = train_one_epoch(
            train_step, state, train_loader, epoch, weight_dict=wdict,
            print_fn=master_print, profile_dir=cfg.train.profile_dir)
        test_stats = run_eval()

        # the best first, so the epoch's checkpoint carries it (else an
        # auto-resume could later overwrite checkpoint_best with a worse
        # model)
        if test_stats:
            acc = next(iter(test_stats.values())).get("accuracy_iou0.5", 0.0)
            if acc > best_val_acc:
                best_val_acc = acc
                master_print(f"new best accuracy_iou0.5 {best_val_acc:.4f}")
                if out_dir:
                    _save(out_dir, "checkpoint_best", state, False, epoch,
                          best_val_acc, cfg)
        if out_dir:
            _save(out_dir, "checkpoint", state, True, epoch, best_val_acc,
                  cfg)
            if ((epoch + 1) % cfg.train.lr_drop == 0
                    or (epoch + 1) % cfg.train.ckpt_cycle == 0):
                _save(out_dir, f"checkpoint{epoch:04d}", state, False, epoch,
                      best_val_acc, cfg)

        log_entry = {
            **{f"train_{k}": v for k, v in train_stats.items()},
            **{f"test_{s}_{k}": v for s, st in test_stats.items()
               for k, v in st.items()},
            "epoch": epoch,
            "n_parameters": n_params,
            "epoch_time": round(time.time() - t0, 1),
        }
        log_stats(out_dir, log_entry)
        history.append(log_entry)
    return {"history": history, "best_val_acc": best_val_acc}
