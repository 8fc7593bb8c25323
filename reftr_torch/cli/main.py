"""The command line of the trainer (port of reftr_tpu/cli/main.py:1-347).

The flags, their names and defaults are the JAX package's (the reference's
main_vg.py:26-164), plus ``--device``, "cuda" unless "cpu" is asked for:

  python -m reftr_torch.cli.main --preset refcoco_det --dataset synthetic \\
      --test_split val --dtype float32 --output_dir exps/smoke
  python -m reftr_torch.cli.main --preset synthetic_smoke --device cpu
  python -m reftr_torch.cli.main --preset flickr --dataset synthetic_multi \
      --test_split val --output_dir exps/multi

On several cards, one process each (DDP over NCCL; ``--device cpu``: gloo
processes on the host), through the launcher:

  python -m reftr_torch.tools.launch --nproc_per_node 4 -- \
      python -m reftr_torch.cli.main --preset refcoco_det ...

``--mesh_data`` is -1 or the launcher's world size; ``--batch_size`` is
per process, as in the reference.

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
    "train_stem": f"the from-scratch flags ({_ITEM} 8)",
    "backbone_norm": f"the from-scratch flags ({_ITEM} 8)",
    "vision_aux_loss": f"the from-scratch flags ({_ITEM} 8)",
    "vision_aux_loss_coef": f"the from-scratch flags ({_ITEM} 8)",
    "img_pos_in_stream": f"the from-scratch flags ({_ITEM} 8)",
    "decoder_pos_in_value": f"the from-scratch flags ({_ITEM} 8)",
    "heatmap_box": f"the from-scratch flags ({_ITEM} 8)",
    "fold_bn": f"fold_bn ({_ITEM} 9)",
    "space_to_depth_stem": f"the TPU reparameterisations ({_ITEM} 9)",
    "fold_normalize": f"the TPU reparameterisations ({_ITEM} 9)",
    "block_layer1": f"the TPU reparameterisations ({_ITEM} 9)",
    "backbone_pad_width": f"the TPU reparameterisations ({_ITEM} 9)",
    "quantize_int8": f"int8 ({_ITEM} 9)",
    "quantize_train_prefix": f"int8 ({_ITEM} 9)",
    "quant_calib_batches": f"int8 ({_ITEM} 9)",
    "quantize_scope": f"int8 ({_ITEM} 9)",
    "remat": f"the JAX step's knobs ({_ITEM} 9)",
    "backbone_remat": f"the JAX step's knobs ({_ITEM} 9)",
    "backbone_remat_stages": f"the JAX step's knobs ({_ITEM} 9)",
    "use_pallas_attention": f"the JAX step's knobs ({_ITEM} 9)",
    "no_donate_state": f"the JAX step's knobs ({_ITEM} 9)",
    "debug_nans": f"the JAX step's knobs ({_ITEM} 9)",
    "profile_dir": f"the profiler tools ({_ITEM} 10)",
    "visualize": f"the visual dump ({_ITEM} 10)",
}


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
                   choices=("auto", "on", "off"))
    p.add_argument("--remat", action="store_true")
    p.add_argument("--space_to_depth_stem", action="store_true")
    p.add_argument("--fold_bn", action="store_true")
    p.add_argument("--fold_normalize", action="store_true")
    p.add_argument("--block_layer1", action="store_true")
    p.add_argument("--backbone_pad_width", default=0, type=int)
    p.add_argument("--quantize_int8", action="store_true")
    p.add_argument("--quantize_train_prefix", action="store_true")
    p.add_argument("--quant_calib_batches", default=4, type=int)
    p.add_argument("--quantize_scope", default=["backbone", "bert", "vl"],
                   nargs="+", choices=["backbone", "bert", "vl"])
    p.add_argument("--backbone_remat", action="store_true")
    p.add_argument("--backbone_remat_stages", default=[], type=int,
                   nargs="*")
    p.add_argument("--profile_dir", default="", type=str)
    p.add_argument("--debug_nans", action="store_true")
    p.add_argument("--no_donate_state", action="store_true")
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
        if dest == "use_pallas_attention" and value == "auto":
            continue  # the default's other name
        if value != getattr(defaults, dest):
            raise NotImplementedError(
                f"--{dest} {value}: {what} is not ported yet")
    if args.no_decoder:
        raise NotImplementedError(
            "--no_decoder (the JAX package refuses it too: the reference has "
            "no forward without the decoder) is not ported")


def args_to_config(args: argparse.Namespace) -> RefTRConfig:
    """The RefTRConfig of the parsed flags, as reftr_tpu's args_to_config
    gives it for the flags the port has."""
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
    # loss
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
    t.pretrained_model = args.pretrained_model
    return cfg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "RefTR training and evaluation on PyTorch",
        parents=[get_args_parser()])
    args = parser.parse_args(argv)
    if args.preset:
        apply_preset(args, args.preset, argv)
    cfg = args_to_config(args)
    from reftr_torch.train.loop import run_training

    result = run_training(cfg, device=args.device)
    if "best_val_acc" in result:
        master_print(f"best accuracy_iou0.5: {result['best_val_acc']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
