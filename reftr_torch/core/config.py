"""Configuration of the port: the fields its serving and training paths
read.

A copy of the matching fields of reftr_tpu/core/config.py (``BertConfig``
:24-67, ``ModelConfig`` :70-176, ``LossConfig`` :232-249, ``DataConfig``
:251-287, ``TrainConfig`` :302-343), kept here because the port imports
nothing of reftr_tpu. ``MeshConfig`` holds the mesh's model axis
(tensor parallelism) too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class BertConfig:
    """Architecture of the language backbone (HF bert-base-uncased layout)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # RoBERTa: position ids count the real tokens from pad_token_id + 1
    is_roberta: bool = False

    @classmethod
    def roberta_base(cls) -> "BertConfig":
        """roberta-base: the byte-level BPE vocabulary, pad id 1, the
        offset position table and LayerNorm eps 1e-5."""
        return cls(vocab_size=50265, max_position_embeddings=514,
                   pad_token_id=1, layer_norm_eps=1e-5, is_roberta=True)

    @classmethod
    def tiny(cls) -> "BertConfig":
        """A small config for unit tests (reftr_tpu's ``bert_size`` tiny)."""
        return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=128)


@dataclass
class ModelConfig:
    """RefTR architecture: REC over one or many phrases per sentence, and
    RES with ``masks``."""

    # any value that starts with "transformer" builds RefTR (RefTRSeg with
    # masks); the factory refuses anything else (convert.model_class)
    reftr_type: str = "transformer_single_phrase"
    backbone: str = "resnet50"  # resnet50 | resnet101
    dilation: bool = False  # DC5: dilate the last stage instead of striding
    position_embedding: str = "sine"  # sine | learned
    num_feature_levels: int = 1
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    nheads: int = 8
    normalize_before: bool = False
    activation: str = "relu"
    masks: bool = False  # add the RES segmentation head (RefTRSeg)
    # RES: train the mask branch (and the CEM block) alone over a frozen
    # REC trunk
    freeze_reftr: bool = False
    freeze_bert: bool = False
    freeze_backbone: bool = False
    # From-scratch training (reftr_tpu/core/config.py:103-167): the repo
    # holds no pretrained backbone, and FrozenBN at its initial statistics
    # normalises nothing, so the residual stream overflows float32.
    # train_stem trains the stem and layer1 (at lr_backbone) instead of
    # the reference's freeze of them;
    train_stem: bool = False
    # the backbone's norm: "frozen" (FrozenBatchNorm, the reference's) or
    # "group" (a live GroupNorm(32) with float32 statistics and a trainable
    # affine);
    backbone_norm: str = "frozen"
    # vision_aux: a linear probe on the VL encoder's image tokens predicting
    # "this cell lies inside the target box" (criterion.loss_vision), REC
    # only;
    vision_aux: bool = False
    # img_pos_in_stream: the sine position added into the projected image
    # features at the encoder's input (q/k positions stay as they are);
    img_pos_in_stream: bool = False
    # decoder_pos_in_value: the decoder's cross-attention values are
    # memory + pos (the keys as before);
    decoder_pos_in_value: bool = False
    # heatmap_box: the final box is the soft-argmax of vision_aux's level-0
    # heatmap; the decoder's last layer moves into aux_outputs. Needs
    # vision_aux; single-phrase REC with one query.
    heatmap_box: bool = False
    # the tokenizer's vocabulary: <data_root>/<bert_model>/vocab.txt, or a
    # vocabulary file's path
    bert_model: str = "bert-base-uncased"
    bert: BertConfig = field(default_factory=BertConfig)
    max_lang_seq: int = 128
    num_queries_per_phrase: int = 1
    aux_loss: bool = False
    ablation: str = "none"  # 'cem_loss' adds RES's CEM energy loss
    # compute dtype: float32 | bfloat16. The JAX ModelConfig defaults to
    # float32 while its CLI defaults to bfloat16 (cli/main.py:149). Serving
    # casts the weights to it; training keeps them float32 and computes
    # under torch.autocast in it.
    dtype: str = "float32"
    # The JAX step's knobs (reftr_tpu/core/config.py:177-201).
    # use_pallas_attention: None (auto) = the port's rule, every attention
    # on a kernel (nn/attention.py); True = the kernels, and a head dim
    # they do not cover raises; False = the plain version everywhere
    use_pallas_attention: Optional[bool] = None
    # recompute each VL encoder layer in the backward (torch.utils.checkpoint)
    remat: bool = False
    # the stem as a 4x4/stride-1 conv on the input's 2x2 space-to-depth
    # (nn/fold.py folds a standard stem's kernel)
    space_to_depth_stem: bool = False
    # FrozenBN's scale folded into the conv kernels at load, a bias left
    fold_bn: bool = False
    # /255 and the ImageNet mean/std folded into the stem: the model takes
    # uint8 canvases only; requires fold_bn
    fold_normalize: bool = False
    # zero-pad bottleneck inner widths below this to it (0: off)
    backbone_pad_width: int = 0
    # recompute each backbone bottleneck in the backward; _stages: only
    # those of the listed stages (1-4)
    backbone_remat: bool = False
    backbone_remat_stages: Tuple[int, ...] = ()
    # layer1 on the 2x2 space-to-depth grid (exclusive with
    # backbone_pad_width)
    block_layer1: bool = False
    # Int8 (nn/quant.py; reftr_tpu/core/config.py:202-221). quantize_int8:
    # post-training quantization for eval and serving of the scopes in
    # quantize_scope ("backbone": the bottleneck convs; "bert", "vl": the
    # BERT and VL-transformer projections and FFNs); requires fold_bn.
    # quantize_train_prefix: the frozen layer1's convs in int8 during
    # training, calibrated on the first train batches; requires fold_bn,
    # excludes train_stem and quantize_int8.
    quantize_int8: bool = False
    quantize_train_prefix: bool = False
    quantize_scope: Tuple[str, ...] = ("backbone", "bert", "vl")

    @property
    def cem_loss(self) -> bool:
        return self.ablation == "cem_loss"


@dataclass
class LossConfig:
    """Loss coefficients (main_vg.py:119-134); the focal terms are RES's
    mask loss. The matcher's costs (``models/matcher.py``) are kept for
    capability: with one query per phrase the criterion is matcher-free."""

    bbox_loss_coef: float = 1.0
    giou_loss_coef: float = 1.0
    mask_loss_coef: float = 1.0
    dice_loss_coef: float = 1.0
    cem_loss_coef: float = 1.0
    vision_aux_coef: float = 1.0  # loss_vision's weight
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    set_cost_class: float = 1.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0


@dataclass
class TrainConfig:
    """Optimization and schedule (main_vg.py:28-55, 234-287)."""

    lr: float = 1e-4
    lr_backbone: float = 1e-5
    lr_bert: float = 1e-5
    lr_mask_branch_proj: float = 1.0  # multiplier on base lr
    # parameter-name keywords selecting each LR group (substring match)
    lr_backbone_names: Tuple[str, ...] = ("img_backbone",)
    lr_bert_names: Tuple[str, ...] = ("lang_backbone",)
    lr_mask_branch_names: Tuple[str, ...] = ("bbox_attention", "mask_head")
    sgd: bool = False
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.1
    epochs: int = 60
    lr_drop: int = 40
    lr_drop_epochs: Optional[Tuple[int, ...]] = None
    warm_up_epoch: int = 2
    lr_decay: float = 0.1
    lr_schedule: str = "StepLR"  # StepLR | MultiStepWarmupLR | CosineWarmupLR
    seed: int = 42
    # the driver (train/loop.py): epochs [start_epoch, start_epoch +
    # run_epoch) of epochs, checkpoint{epoch:04d} every ckpt_cycle epochs
    start_epoch: int = 0
    run_epoch: int = 500  # bounded runs for time-limited queues
    ckpt_cycle: int = 20
    output_dir: str = ""
    resume: str = ""
    auto_resume: bool = False
    resume_model_only: bool = False
    # a URL, a reference .pth or a checkpoint of the port
    pretrained_model: Optional[str] = None
    eval_only: bool = False
    # JAX donates the train state's buffers to its step (reftr_tpu/train/
    # steps.py:96); the port's step updates the parameters in place either
    # way, so the flag changes no bit
    donate_state: bool = True
    visualize: bool = False  # visual dumps under output_dir/vis with --eval
    profile_dir: str = ""  # torch.profiler trace of a few early steps
    # batches that calibrate the int8 input scales (quantize_int8: the
    # first test split's; quantize_train_prefix: the train loader's)
    quant_calib_batches: int = 4


@dataclass
class DataConfig:
    """Dataset and batching (main_vg.py:137-147).

    Images land on a fixed ``max_img_size`` canvas with a validity mask
    (their short side resized to ``img_size``, the long side capped at
    ``max_img_size``), sentences pad to ``max_query_len`` (single phrase)
    or ``max_sentence_len`` (multi-phrase), whose phrases pad to
    ``max_num_phrases`` slots of ``phrase_seq_len`` tokens. A server reads
    ``img_size`` as its canvas."""

    dataset: str = "refcoco_unc"
    train_split: str = "train"
    test_splits: Tuple[str, ...] = ("val",)
    data_root: str = "./data"
    img_size: int = 640
    max_img_size: int = 640
    max_query_len: int = 40
    max_sentence_len: int = 90
    max_num_phrases: int = 16
    phrase_seq_len: int = 22
    multi_phrase: bool = False
    batch_size: int = 8
    num_workers: int = 2
    cache_mode: bool = False
    # colour jitter strength of RandomIntensitySaturation
    # (transforms.py:266-285)
    hsv_jitter: float = 0.5
    # the synthetic fixture's box side range as a fraction of img_size,
    # and its train set size (every other split has 64 items)
    synthetic_box_frac: Tuple[float, float] = (1 / 6, 1 / 3)
    synthetic_n: int = 256


@dataclass
class MeshConfig:
    """The (data, model) mesh of ranks (reftr_tpu/core/config.py:289-299),
    one process per card: ``model`` > 1 splits the attention heads and the
    FFN widths over that many ranks (tensor parallelism,
    ``parallel/tensor_parallel.py``); ``data`` is -1 (the world over
    ``model``) or world / model. ``model_spans_processes`` lays the ranks
    out model-major (``parallel/sharding.py::mesh_grid``)."""

    data: int = -1  # -1: all the ranks over the model axis
    model: int = 1
    model_spans_processes: bool = False


@dataclass
class RefTRConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
