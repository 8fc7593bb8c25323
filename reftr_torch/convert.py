"""Weights for the port: the bridge from a Flax param tree, and a seeded init.

``from_flax`` maps each leaf of a reftr_tpu RefTR or RefTRSeg param tree
(numpy arrays)
onto the port's parameters and buffers. Module paths map one to one, with
a trailing ``_<n>`` index becoming a ``.<n>`` child (``layer1_0`` ->
``layer1.0``, ``layers_2`` -> ``layers.2``), and leaves map as:

  Dense ``kernel`` [in, out]          -> Linear ``weight`` [out, in]
  Conv ``kernel`` [kh, kw, I, O]      -> Conv2d ``weight`` [O, I, kh, kw]
  LayerNorm / GroupNorm ``scale``     -> ``weight``
  Embed ``embedding``                 -> ``weight``
  everything else (biases, FrozenBN statistics, level_embed,
  query_embed)                        -> as it is

It raises on any leaf it leaves unused and on any port tensor it leaves
unfilled.

``init_params`` fills a model from a ``torch.Generator`` the way the JAX
package's initialisers do: xavier-uniform for the transformer, heads and
projections, normal(0.02) for BERT's embeddings and dense layers,
lecun-normal for the backbone convolutions, normal(1.0) for
``level_embed``, a zero final layer of ``bbox_embed``, and torch's
kaiming-uniform (a=1) with zero bias for the mask head's convolutions.

``build_model`` makes the model of a config on its device with either:
RefTRSeg with ``masks``, else RefTR (reftr_tpu/models/build.py:55-64). It
is the one place where serving (``serve.ServingModel``) and training
(``train.TrainState.create``) get their model.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from reftr_torch.core.config import ModelConfig
from reftr_torch.core.device import resolve_device
from reftr_torch.models.reftr import RefTR
from reftr_torch.models.reftr_seg import RefTRSeg
from reftr_torch.models.vl_transformer import VLTransformer
from reftr_torch.nn.bert import BertEmbeddings, BertLayer, BertModel
from reftr_torch.nn.mlp import MLP
from reftr_torch.nn.posembed import ImagePositionEmbedding
from reftr_torch.nn.query_encoder import QueryEncoder
from reftr_torch.nn.resnet import FrozenBatchNorm
from reftr_torch.nn.seg_heads import MaskHeadSmallConv

_INDEXED = re.compile(r"^(.+)_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def flax_leaf_to_torch(path: Tuple[str, ...], leaf: np.ndarray
                       ) -> Tuple[str, np.ndarray]:
    """One Flax leaf -> (port state_dict name, array in the port's layout)."""
    modules = [_INDEXED.sub(r"\1.\2", p) for p in path[:-1]]
    name = path[-1]
    if name == "kernel":
        if leaf.ndim == 2:
            leaf = leaf.T
        elif leaf.ndim == 4:
            leaf = leaf.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {leaf.ndim}")
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return ".".join(modules + [name]), np.ascontiguousarray(leaf)


def model_class(cfg: ModelConfig) -> type:
    """RefTRSeg with ``masks``, else RefTR, after the JAX factory's checks
    of the heads (reftr_tpu/models/build.py:20-64)."""
    if cfg.heatmap_box:
        if not cfg.vision_aux:
            raise ValueError("heatmap_box decodes the vision_aux heatmap; "
                             "enable --vision_aux_loss")
        if cfg.masks:
            raise ValueError("heatmap_box is a REC head; the RES path "
                             "decodes masks instead")
    return RefTRSeg if cfg.masks else RefTR


def from_flax(params: Mapping[str, Any], cfg: ModelConfig
              ) -> Dict[str, torch.Tensor]:
    """A state_dict for the model of ``cfg`` (``model_class``) from a Flax
    param tree (the ``params`` collection, nested dicts of arrays)."""
    with torch.device("meta"):
        expected = model_class(cfg)(cfg).state_dict()
    return flax_state_dict(params, expected)


def flax_state_dict(params: Mapping[str, Any],
                    expected: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Map a Flax param tree onto the names, shapes and dtypes of
    ``expected`` (a module's state_dict); raises on a leaf left unused or a
    tensor left unfilled."""
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for path, leaf in _flatten(params):
        name, value = flax_leaf_to_torch(path, leaf)
        if name not in expected:
            unused.append("/".join(path))
            continue
        if tuple(value.shape) != tuple(expected[name].shape):
            raise ValueError(f"{'/'.join(path)} -> {name}: shape "
                             f"{value.shape} != {tuple(expected[name].shape)}")
        out[name] = torch.from_numpy(value).to(expected[name].dtype)
    missing = sorted(set(expected) - set(out))
    if unused or missing:
        raise ValueError(f"Flax leaves left unused: {unused}; port tensors "
                         f"left unfilled: {missing}")
    return out


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default conv init: truncated normal (at 2 std) with variance
    1 / fan_in."""
    fan_in = w.shape[1] * w[0, 0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation following the JAX package's initialisers."""
    g = generator
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            nn.init.xavier_uniform_(mod.weight, generator=g)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Conv2d):
            if mod.bias is None:  # backbone convs: flax's default init
                _lecun_normal_(mod.weight, g)
            else:  # InputProj
                nn.init.xavier_uniform_(mod.weight, generator=g)
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.xavier_uniform_(mod.weight, generator=g)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, FrozenBatchNorm):
            for name, fill in (("weight", 1.0), ("bias", 0.0),
                               ("running_mean", 0.0), ("running_var", 1.0)):
                getattr(mod, name).fill_(fill)
    # module-specific initialisers
    for mod in model.modules():
        if isinstance(mod, BertEmbeddings):
            for emb in (mod.word_embeddings, mod.position_embeddings,
                        mod.token_type_embeddings):
                nn.init.normal_(emb.weight, 0.0, 0.02, generator=g)
        elif isinstance(mod, BertLayer):
            for lin in (mod.intermediate, mod.output):
                nn.init.normal_(lin.weight, 0.0, 0.02, generator=g)
        elif isinstance(mod, BertModel):
            nn.init.normal_(mod.pooler.weight, 0.0, 0.02, generator=g)
        elif isinstance(mod, VLTransformer):
            nn.init.normal_(mod.level_embed, 0.0, 1.0, generator=g)
        elif isinstance(mod, QueryEncoder):
            nn.init.xavier_uniform_(mod.query_embed, generator=g)
        elif isinstance(mod, MLP) and mod.final_zero_init:
            nn.init.zeros_(mod.layers[-1].weight)
            nn.init.zeros_(mod.layers[-1].bias)
        elif (isinstance(mod, ImagePositionEmbedding)
              and mod.kind == "learned"):
            nn.init.uniform_(mod.row_embed.weight, 0.0, 1.0, generator=g)
            nn.init.uniform_(mod.col_embed.weight, 0.0, 1.0, generator=g)
        elif isinstance(mod, MaskHeadSmallConv):
            for conv in mod.modules():
                if isinstance(conv, nn.Conv2d):
                    nn.init.kaiming_uniform_(conv.weight, a=1, generator=g)
                    nn.init.zeros_(conv.bias)
    return model


def build_model(cfg: ModelConfig, device: Union[str, torch.device] = "cuda",
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0) -> RefTR:
    """The model of ``cfg`` (``model_class``: RefTRSeg with ``masks``,
    else RefTR) built on ``device`` ("cuda" unless the caller passes the
    CPU) with the weights of ``state_dict`` or, without one, from
    ``init_params`` with a generator on the device seeded by ``seed``. On
    a card the convolutions run NHWC (channels_last), the layout the
    images arrive in."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = model_class(cfg)(cfg)
    if state_dict is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_params(model, gen)
    else:
        model.load_state_dict(state_dict)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model
