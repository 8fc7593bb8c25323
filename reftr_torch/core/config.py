"""Configuration of the port: the fields its serving path reads.

A copy of the matching fields of reftr_tpu/core/config.py (``BertConfig``
:24-67, ``ModelConfig`` :70-176, ``DataConfig`` :251-273), kept here because
the port imports nothing of reftr_tpu. Options of the JAX package that the
port does not run yet (training, RES, multi-phrase, the from-scratch flags,
the TPU reparameterisations and int8) are left out rather than accepted and
ignored; they come back with the slice that runs them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @classmethod
    def tiny(cls) -> "BertConfig":
        """A small config for unit tests (reftr_tpu's ``bert_size`` tiny)."""
        return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=128)


@dataclass
class ModelConfig:
    """RefTR architecture, single-phrase REC path."""

    backbone: str = "resnet50"  # resnet50 | resnet101
    dilation: bool = False  # DC5: dilate the last stage instead of striding
    position_embedding: str = "sine"  # sine | learned
    num_feature_levels: int = 1
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    nheads: int = 8
    normalize_before: bool = False
    activation: str = "relu"
    bert: BertConfig = field(default_factory=BertConfig)
    max_lang_seq: int = 128
    num_queries_per_phrase: int = 1
    aux_loss: bool = False
    # from-scratch heads of the JAX package; RefTR raises on them until the
    # slice that runs them
    vision_aux: bool = False
    heatmap_box: bool = False
    # compute dtype: float32 | bfloat16. The JAX ModelConfig defaults to
    # float32 while its CLI defaults to bfloat16 (cli/main.py:149).
    dtype: str = "float32"


@dataclass
class DataConfig:
    """The input geometry a server needs: canvas size and sentence length."""

    img_size: int = 640
    max_query_len: int = 40


@dataclass
class RefTRConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
