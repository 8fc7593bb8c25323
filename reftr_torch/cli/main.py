"""The command line of the trainer (port of reftr_tpu/cli/main.py:1-347).

The flags, their names and defaults are the JAX package's (the reference's
main_vg.py:26-164), plus ``--device``, "cuda" unless "cpu" is asked for:

  python -m reftr_torch.cli.main --preset refcoco_det --dataset synthetic \\
      --test_split val --dtype float32 --output_dir exps/smoke
  python -m reftr_torch.cli.main --preset synthetic_smoke --device cpu
  python -m reftr_torch.cli.main --preset flickr --dataset synthetic_multi \
      --test_split val --output_dir exps/multi

From scratch (the repo holds no pretrained weights), the flags of
exps/run_gn_flagship3.sh (add ``--space_to_depth_stem`` for its stem):

  python -m reftr_torch.cli.main --num_feature_levels 1 \
      --dataset synthetic --train_split train --test_split val \
      --synthetic_box_frac 0.25 0.5 --bert_size tiny \
      --backbone_norm group --train_stem --pre_norm \
      --aux_loss --bbox_loss_coef 5 --vision_aux_loss \
      --vision_aux_loss_coef 2 --lr 3e-3 --lr_backbone 3e-3 \
      --lr_schedule CosineWarmupLR --warm_up_epoch 5 --clip_max_norm 1.0 \
      --epochs 120 --batch_size 16 --seed 0 --output_dir exps/scratch

``--img_pos_in_stream``, ``--decoder_pos_in_value`` and ``--heatmap_box``
(which needs ``--vision_aux_loss``) join it as in run_gn_flagship4.sh and
run_gn_flagship5.sh.

On several cards, one process each (DDP over NCCL; ``--device cpu``: gloo
processes on the host), through the launcher:

  python -m reftr_torch.tools.launch --nproc_per_node 4 -- \
      python -m reftr_torch.cli.main --preset refcoco_det ...

``--mesh_data`` is -1 or the launcher's world size; ``--batch_size`` is
per process, as in the reference.

The JAX step's knobs run as in the JAX package: the backbone's
reparameterisations (``--space_to_depth_stem``, ``--fold_bn``,
``--fold_normalize``, ``--backbone_pad_width``, ``--block_layer1``;
``nn/fold.py`` folds a standard checkpoint or init at load), recompute in
the backward (``--remat``, ``--backbone_remat``,
``--backbone_remat_stages``), ``--use_pallas_attention`` (auto: the
port's rule; on: the kernels, a head dim they lack raises; off: the plain
version everywhere), ``--debug_nans`` (``train/steps.py``) and
``--no_donate_state`` (accepted; the port's step updates in place either
way, and the bits are the same).

Every flag parses as in the JAX package; ``--dataset synthetic_multi`` is
the port's own (``data/build.py``). A flag of a feature the port does
not have yet raises NotImplementedError, naming its ROADMAP.md item, when
it is given anything but its default (``NOT_PORTED``); none is ignored.
"""

from __future__ import annotations

import argparse
import sys

from reftr_torch.cli.presets import PRESETS, apply_preset
from reftr_torch.core.config import BertConfig, RefTRConfig
from reftr_torch.core.distributed import env_world_size
from reftr_torch.core.logging import master_print
from reftr_torch.parallel.sharding import TP_ITEM, check_data_axis

_ITEM = "ROADMAP.md queue 1 item"
# dest -> what it needs, for the flags of features not ported yet
NOT_PORTED = {
    "mesh_model": TP_ITEM,
    "mesh_model_spans_processes": TP_ITEM,
    "quantize_int8": f"int8 ({_ITEM} 9)",
    "quantize_train_prefix": f"int8 ({_ITEM} 9)",
    "quant_calib_batches": f"int8 ({_ITEM} 9)",
    "quantize_scope": f"int8 ({_ITEM} 9)",
}
# --use_pallas_attention's values and ModelConfig's
PALLAS_ATTENTION = {None: None, "auto": None, "on": True, "off": False}


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("RefTR visual grounding on PyTorch",
                                add_help=False)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="named config mirroring the reference configs/*.sh")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    # optimization
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_backbone", default=1e-5, type=float)
    p.add_argument("--lr_bert", default=None, type=float,
                   help="defaults to --lr_backbone like the reference")
    p.add_argument("--lr_mask_branch_proj", default=1.0, type=float)
    p.add_argument("--lr_backbone_names", default=["img_backbone"],
                   type=str, nargs="+")
    p.add_argument("--lr_bert_names", default=["lang_backbone"],
                   type=str, nargs="+")
    p.add_argument("--lr_mask_branch_names",
                   default=["bbox_attention", "mask_head"],
                   type=str, nargs="+")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=60, type=int)
    p.add_argument("--lr_drop", default=40, type=int)
    p.add_argument("--lr_drop_epochs", default=None, type=int, nargs="+")
    p.add_argument("--warm_up_epoch", default=2, type=int)
    p.add_argument("--lr_decay", default=0.1, type=float)
    p.add_argument("--lr_schedule", default="StepLR", type=str)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--ckpt_cycle", default=20, type=int)
    p.add_argument("--sgd", action="store_true")
    # model
    p.add_argument("--reftr_type", default="transformer_single_phrase")
    p.add_argument("--pretrained_model", type=str, default=None)
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--train_stem", action="store_true")
    p.add_argument("--backbone_norm", default="frozen",
                   choices=("frozen", "group"))
    p.add_argument("--vision_aux_loss", action="store_true")
    p.add_argument("--vision_aux_loss_coef", default=1.0, type=float)
    p.add_argument("--img_pos_in_stream", action="store_true")
    p.add_argument("--decoder_pos_in_value", action="store_true")
    p.add_argument("--heatmap_box", action="store_true")
    p.add_argument("--ablation", type=str, default="none")
    p.add_argument("--backbone", default="resnet50", type=str)
    p.add_argument("--dilation", action="store_true")
    p.add_argument("--position_embedding", default="sine", type=str,
                   choices=("sine", "learned"))
    # the reference's default (main_vg.py:71); every preset sets 1
    p.add_argument("--num_feature_levels", default=4, type=int)
    p.add_argument("--enc_layers", default=6, type=int)
    p.add_argument("--dec_layers", default=6, type=int)
    p.add_argument("--no_decoder", action="store_true")
    p.add_argument("--dim_feedforward", default=2048, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--nheads", default=8, type=int)
    p.add_argument("--masks", action="store_true")
    p.add_argument("--freeze_reftr", action="store_true")
    p.add_argument("--bert_model", default="bert-base-uncased", type=str)
    p.add_argument("--freeze_bert", action="store_true")
    p.add_argument("--max_lang_seq", default=128, type=int)
    p.add_argument("--num_queries_per_phrase", default=1, type=int)
    p.add_argument("--aux_loss", action="store_true")
    p.add_argument("--pre_norm", action="store_true")
    # losses
    p.add_argument("--mask_loss_coef", default=1.0, type=float)
    p.add_argument("--dice_loss_coef", default=1.0, type=float)
    p.add_argument("--bbox_loss_coef", default=1.0, type=float)
    p.add_argument("--giou_loss_coef", default=1.0, type=float)
    p.add_argument("--focal_alpha", default=0.25, type=float)
    p.add_argument("--set_cost_class", default=1.0, type=float)
    p.add_argument("--set_cost_bbox", default=5.0, type=float)
    p.add_argument("--set_cost_giou", default=2.0, type=float)
    # data
    p.add_argument("--dataset", default="flickr30k")
    p.add_argument("--train_split", default="trainval")
    p.add_argument("--test_split", default=["test"], type=str, nargs="+")
    p.add_argument("--img_size", default=640, type=int)
    p.add_argument("--max_img_size", default=640, type=int)
    p.add_argument("--data_root", default="./data", type=str)
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--cache_mode", action="store_true")
    p.add_argument("--synthetic_n", default=256, type=int,
                   help="synthetic-fixture train-set size (val stays 64)")
    p.add_argument("--synthetic_box_frac", default=[1 / 6, 1 / 3],
                   type=float, nargs=2,
                   help="synthetic-fixture box side range (fraction of"
                        " img_size)")
    # run control
    p.add_argument("--output_dir", default="")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--resume_model_only", action="store_true")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--run_epoch", default=500, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--visualize", action="store_true")
    # the JAX package's own knobs
    p.add_argument("--dtype", default="bfloat16",
                   choices=("float32", "bfloat16"))
    p.add_argument("--mesh_data", default=-1, type=int)
    p.add_argument("--mesh_model", default=1, type=int)
    p.add_argument("--mesh_model_spans_processes", action="store_true")
    p.add_argument("--use_pallas_attention", default=None,
                   choices=("auto", "on", "off"),
                   help="the attention kernels: auto (the default) by the "
                        "port's rule, on at every site (a head dim above "
                        "128 raises), off: the plain version everywhere")
    p.add_argument("--remat", action="store_true",
                   help="recompute each VL encoder layer in the backward "
                        "(torch.utils.checkpoint), with its dropout masks")
    p.add_argument("--space_to_depth_stem", action="store_true",
                   help="stem as 2x2 space-to-depth + 4x4/s1 conv"
                        " (exact fold of the 7x7/s2 stem)")
    p.add_argument("--fold_bn", action="store_true",
                   help="fold FrozenBN scales into conv kernels at load")
    p.add_argument("--fold_normalize", action="store_true",
                   help="fold /255 + ImageNet normalize into the stem conv"
                        " (uint8 input path; requires --fold_bn)")
    p.add_argument("--block_layer1", action="store_true",
                   help="run layer1 on the 2x2 space-to-depth grid (exact"
                        " reparameterization)")
    p.add_argument("--backbone_pad_width", default=0, type=int,
                   help="zero-pad bottleneck inner widths below this to it"
                        " (exact)")
    p.add_argument("--quantize_int8", action="store_true")
    p.add_argument("--quantize_train_prefix", action="store_true")
    p.add_argument("--quant_calib_batches", default=4, type=int)
    p.add_argument("--quantize_scope", default=["backbone", "bert", "vl"],
                   nargs="+", choices=["backbone", "bert", "vl"])
    p.add_argument("--backbone_remat", action="store_true",
                   help="recompute each backbone bottleneck in the backward"
                        " (torch.utils.checkpoint)")
    p.add_argument("--backbone_remat_stages", default=[], type=int,
                   nargs="*", help="remat only these backbone stages (1-4)")
    p.add_argument("--profile_dir", default="", type=str,
                   help="capture a torch.profiler trace of early steps "
                        "(10-14 of epoch 0) into this directory")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise at the first non-finite value of a step, "
                        "forward or backward, naming the module or op")
    p.add_argument("--no_donate_state", action="store_true",
                   help="accepted for the JAX command line's sake: the "
                        "port's step updates the state in place either "
                        "way, with the same bits")
    p.add_argument("--bert_size", default="base", choices=("base", "tiny"),
                   help="tiny: a small random-init language encoder "
                        "(smoke tests)")
    return p


def refuse_not_ported(args: argparse.Namespace) -> None:
    """Raise NotImplementedError for a flag of a feature the port does not
    have yet, set to anything but its default."""
    defaults = get_args_parser().parse_args([])
    for dest, what in NOT_PORTED.items():
        value = getattr(args, dest)
        if value != getattr(defaults, dest):
            raise NotImplementedError(
                f"--{dest} {value}: {what} is not ported yet")
    if args.no_decoder:
        raise NotImplementedError(
            "--no_decoder (the JAX package refuses it too: the reference has "
            "no forward without the decoder) is not ported")


def args_to_config(args: argparse.Namespace) -> RefTRConfig:
    """The RefTRConfig of the parsed flags, as reftr_tpu's args_to_config
    gives it for the flags the port has. ``--backbone_norm group`` with a
    flag that folds or quantizes FrozenBN's statistics raises the JAX
    factory's ValueError before int8's refusal
    (reftr_tpu/models/build.py:25-31)."""
    if args.backbone_norm != "frozen" and (
            args.fold_bn or args.fold_normalize or args.quantize_int8
            or args.quantize_train_prefix):
        raise ValueError(
            "backbone_norm='group' has no frozen statistics to fold or "
            "quantize: drop fold_bn/fold_normalize/quantize_int8/"
            "quantize_train_prefix")
    refuse_not_ported(args)
    cfg = RefTRConfig()
    # the data axis against the world the launcher announced (run_training
    # checks it again against the process group)
    check_data_axis(args.mesh_data, env_world_size())
    cfg.mesh.data = args.mesh_data
    m, t, d, loss = cfg.model, cfg.train, cfg.data, cfg.loss
    # model
    m.reftr_type = args.reftr_type
    m.backbone = args.backbone
    m.dilation = args.dilation
    m.position_embedding = args.position_embedding
    m.num_feature_levels = args.num_feature_levels
    m.enc_layers = args.enc_layers
    m.dec_layers = args.dec_layers
    m.dim_feedforward = args.dim_feedforward
    m.hidden_dim = args.hidden_dim
    m.dropout = args.dropout
    m.nheads = args.nheads
    # lr_backbone <= 0 freezes layer2-4 too (backbone.py:85-89)
    m.freeze_backbone = args.freeze_backbone or args.lr_backbone <= 0
    # the from-scratch flags; a frozen backbone keeps its stem frozen, and
    # RES's mask loss takes the vision probe's place
    m.train_stem = args.train_stem and not m.freeze_backbone
    m.backbone_norm = args.backbone_norm
    m.vision_aux = args.vision_aux_loss and not args.masks
    m.img_pos_in_stream = args.img_pos_in_stream
    m.decoder_pos_in_value = args.decoder_pos_in_value
    m.heatmap_box = args.heatmap_box
    m.masks = args.masks
    m.freeze_reftr = args.freeze_reftr
    m.ablation = args.ablation
    m.freeze_bert = args.freeze_bert
    m.bert_model = args.bert_model
    roberta = args.bert_model.split("-")[0] == "roberta"
    if args.bert_size == "tiny":
        m.bert = BertConfig.tiny()
    elif roberta:
        m.bert = BertConfig.roberta_base()
    m.bert.is_roberta = roberta
    m.max_lang_seq = args.max_lang_seq
    m.num_queries_per_phrase = args.num_queries_per_phrase
    m.aux_loss = args.aux_loss
    m.normalize_before = args.pre_norm
    m.dtype = args.dtype
    # the JAX step's knobs
    m.use_pallas_attention = PALLAS_ATTENTION[args.use_pallas_attention]
    m.remat = args.remat
    m.space_to_depth_stem = args.space_to_depth_stem
    m.fold_bn = args.fold_bn
    m.fold_normalize = args.fold_normalize
    m.backbone_pad_width = args.backbone_pad_width
    m.block_layer1 = args.block_layer1
    m.backbone_remat = args.backbone_remat
    m.backbone_remat_stages = tuple(args.backbone_remat_stages)
    # loss
    loss.vision_aux_coef = args.vision_aux_loss_coef
    loss.bbox_loss_coef = args.bbox_loss_coef
    loss.giou_loss_coef = args.giou_loss_coef
    loss.mask_loss_coef = args.mask_loss_coef
    loss.dice_loss_coef = args.dice_loss_coef
    loss.focal_alpha = args.focal_alpha
    loss.set_cost_class = args.set_cost_class
    loss.set_cost_bbox = args.set_cost_bbox
    loss.set_cost_giou = args.set_cost_giou
    # data
    d.dataset = args.dataset
    d.train_split = args.train_split
    d.test_splits = tuple(args.test_split)
    d.img_size = args.img_size
    d.max_img_size = args.max_img_size
    d.data_root = args.data_root
    d.batch_size = args.batch_size
    d.num_workers = args.num_workers
    d.cache_mode = args.cache_mode
    d.synthetic_box_frac = tuple(args.synthetic_box_frac)
    d.synthetic_n = args.synthetic_n
    # synthetic_multi: the port's name of the JAX package's multi-phrase
    # fixture (data/build.py)
    d.multi_phrase = args.dataset in ("flickr30k", "synthetic_multi")
    # train
    t.lr = args.lr
    t.lr_backbone = args.lr_backbone
    t.lr_bert = args.lr_bert if args.lr_bert is not None else args.lr_backbone
    t.lr_mask_branch_proj = args.lr_mask_branch_proj
    t.lr_backbone_names = tuple(args.lr_backbone_names)
    t.lr_bert_names = tuple(args.lr_bert_names)
    t.lr_mask_branch_names = tuple(args.lr_mask_branch_names)
    t.sgd = args.sgd
    t.weight_decay = args.weight_decay
    t.clip_max_norm = args.clip_max_norm
    t.epochs = args.epochs
    t.lr_drop = args.lr_drop
    t.lr_drop_epochs = (tuple(args.lr_drop_epochs) if args.lr_drop_epochs
                        else None)
    t.warm_up_epoch = args.warm_up_epoch
    t.lr_decay = args.lr_decay
    t.lr_schedule = args.lr_schedule
    t.ckpt_cycle = args.ckpt_cycle
    t.seed = args.seed
    t.output_dir = args.output_dir
    t.resume = args.resume
    t.auto_resume = args.auto_resume
    t.resume_model_only = args.resume_model_only
    t.start_epoch = args.start_epoch
    t.run_epoch = args.run_epoch
    t.eval_only = args.eval
    t.visualize = args.visualize
    t.profile_dir = args.profile_dir
    t.pretrained_model = args.pretrained_model
    t.donate_state = not args.no_donate_state
    return cfg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "RefTR training and evaluation on PyTorch",
        parents=[get_args_parser()])
    args = parser.parse_args(argv)
    if args.preset:
        apply_preset(args, args.preset, argv)
    cfg = args_to_config(args)
    if args.debug_nans:
        from reftr_torch.train.steps import set_debug_nans

        set_debug_nans(True)
    from reftr_torch.train.loop import run_training

    result = run_training(cfg, device=args.device)
    if "best_val_acc" in result:
        master_print(f"best accuracy_iou0.5: {result['best_val_acc']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
