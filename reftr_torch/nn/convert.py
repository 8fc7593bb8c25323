"""Reference checkpoints -> the port's state dict (port of
reftr_tpu/nn/convert.py:25-307).

The reference RefTR distributes its weights as torch ``.pth`` files
(README.md:86-91 of the reference; ``main_vg.py:377-385`` saves
``{"model": state_dict, "optimizer", "lr_scheduler", "epoch", "args"}``).
Its module names differ from the port's: HF BERT's ``attention.self.query``
is the port's ``attention.q_proj``, torch's ``nn.MultiheadAttention`` packs
q, k and v in one ``in_proj_weight`` [3D, D], the DETR backbone nests under
``img_backbone.0.body.``, and the ``nn.Sequential`` heads count their
children. Both sides are torch, so no value is transposed: each tensor is
copied as it is, cast to float32 (the port's parameter dtype), and
``in_proj_weight`` / ``in_proj_bias`` split into thirds in q, k, v order.

Each converter below gives the entries of one module: (reference name,
port name, third), where ``third`` is None for a whole tensor, else 0, 1
or 2 for the q, k or v rows of a packed projection. ``convert_reftr`` and
``convert_detr`` copy the entries whose reference tensor the file holds
and leave the rest to the non-strict load's report of missing keys; like
the JAX converter, they read only the layers and levels the config has.
``reference_state_dict`` walks the same entries the other way (port ->
reference names, q, k and v packed again): the port's weights under the
reference's names.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from reftr_torch.nn.resnet import RESNET_LAYERS

Entry = Tuple[str, str, Optional[int]]


def _pairs(src: str, dst: str, leaves: Iterable[str]) -> List[Entry]:
    return [(f"{src}.{leaf}", f"{dst}.{leaf}", None) for leaf in leaves]


def linear(src: str, dst: str) -> List[Entry]:
    return _pairs(src, dst, ("weight", "bias"))


def layer_norm(src: str, dst: str) -> List[Entry]:
    return _pairs(src, dst, ("weight", "bias"))


group_norm = layer_norm


def conv(src: str, dst: str) -> List[Entry]:
    """A convolution's weight and, where the file has one, its bias (the
    backbone's convolutions have none)."""
    return _pairs(src, dst, ("weight", "bias"))


def frozen_bn(src: str, dst: str) -> List[Entry]:
    return _pairs(src, dst, ("weight", "bias", "running_mean",
                             "running_var"))


def embedding(src: str, dst: str) -> List[Entry]:
    return _pairs(src, dst, ("weight",))


def mha(src: str, dst: str) -> List[Entry]:
    """torch nn.MultiheadAttention -> the port's MultiHeadAttention: the
    rows of ``in_proj_weight`` [3D, D] and ``in_proj_bias`` [3D] are q, k,
    v in that order (nn/convert.py:65-83)."""
    out = []
    for third, proj in enumerate(("q_proj", "k_proj", "v_proj")):
        out += [(f"{src}.in_proj_weight", f"{dst}.{proj}.weight", third),
                (f"{src}.in_proj_bias", f"{dst}.{proj}.bias", third)]
    return out + linear(f"{src}.out_proj", f"{dst}.out_proj")


def convert_bert(num_layers: int, src: str, dst: str) -> List[Entry]:
    """HF BertModel (or RobertaModel) names -> nn/bert.py::BertModel."""
    out = (embedding(f"{src}.embeddings.word_embeddings",
                     f"{dst}.embeddings.word_embeddings")
           + embedding(f"{src}.embeddings.position_embeddings",
                       f"{dst}.embeddings.position_embeddings")
           + embedding(f"{src}.embeddings.token_type_embeddings",
                       f"{dst}.embeddings.token_type_embeddings")
           + layer_norm(f"{src}.embeddings.LayerNorm",
                        f"{dst}.embeddings.LayerNorm")
           + linear(f"{src}.pooler.dense", f"{dst}.pooler"))
    for i in range(num_layers):
        s, d = f"{src}.encoder.layer.{i}", f"{dst}.layer.{i}"
        out += (linear(f"{s}.attention.self.query", f"{d}.attention.q_proj")
                + linear(f"{s}.attention.self.key", f"{d}.attention.k_proj")
                + linear(f"{s}.attention.self.value", f"{d}.attention.v_proj")
                + linear(f"{s}.attention.output.dense",
                         f"{d}.attention.out_proj")
                + layer_norm(f"{s}.attention.output.LayerNorm",
                             f"{d}.attention_norm")
                + linear(f"{s}.intermediate.dense", f"{d}.intermediate")
                + linear(f"{s}.output.dense", f"{d}.output")
                + layer_norm(f"{s}.output.LayerNorm", f"{d}.output_norm"))
    return out


def convert_resnet(depth: str, src: str, dst: str) -> List[Entry]:
    """torchvision ResNet-50/101 names (FrozenBN's four tensors a norm) ->
    nn/resnet.py::ResNet; the blocks per stage from RESNET_LAYERS."""
    out = conv(f"{src}.conv1", f"{dst}.conv1") + frozen_bn(f"{src}.bn1",
                                                            f"{dst}.bn1")
    for stage, n_blocks in enumerate(RESNET_LAYERS[depth], start=1):
        for b in range(n_blocks):
            s, d = f"{src}.layer{stage}.{b}", f"{dst}.layer{stage}.{b}"
            for j in (1, 2, 3):
                out += (conv(f"{s}.conv{j}", f"{d}.conv{j}")
                        + frozen_bn(f"{s}.bn{j}", f"{d}.bn{j}"))
            if b == 0:  # the first block of every stage projects
                out += (conv(f"{s}.downsample.0", f"{d}.downsample_conv")
                        + frozen_bn(f"{s}.downsample.1", f"{d}.downsample_bn"))
    return out


def convert_encoder_layer(src: str, dst: str) -> List[Entry]:
    return (mha(f"{src}.self_attn", f"{dst}.self_attn")
            + linear(f"{src}.linear1", f"{dst}.ffn.linear1")
            + linear(f"{src}.linear2", f"{dst}.ffn.linear2")
            + layer_norm(f"{src}.norm1", f"{dst}.norm1")
            + layer_norm(f"{src}.norm2", f"{dst}.norm2"))


def convert_decoder_layer(src: str, dst: str) -> List[Entry]:
    return (mha(f"{src}.self_attn", f"{dst}.self_attn")
            + mha(f"{src}.multihead_attn", f"{dst}.multihead_attn")
            + linear(f"{src}.linear1", f"{dst}.ffn.linear1")
            + linear(f"{src}.linear2", f"{dst}.ffn.linear2")
            + layer_norm(f"{src}.norm1", f"{dst}.norm1")
            + layer_norm(f"{src}.norm2", f"{dst}.norm2")
            + layer_norm(f"{src}.norm3", f"{dst}.norm3"))


def convert_encoder(num_layers: int, src: str, dst: str) -> List[Entry]:
    """TransformerEncoder (layers.{i}.*, and the final norm of a pre-norm
    encoder)."""
    out = layer_norm(f"{src}.norm", f"{dst}.norm")
    for i in range(num_layers):
        out += convert_encoder_layer(f"{src}.layers.{i}", f"{dst}.layers.{i}")
    return out


def convert_decoder(num_layers: int, src: str, dst: str) -> List[Entry]:
    out = layer_norm(f"{src}.norm", f"{dst}.norm")
    for i in range(num_layers):
        out += convert_decoder_layer(f"{src}.layers.{i}", f"{dst}.layers.{i}")
    return out


def convert_mlp(num_layers: int, src: str, dst: str) -> List[Entry]:
    """DETR's MLP head (layers.{i}) -> nn/mlp.py::MLP."""
    out = []
    for i in range(num_layers):
        out += linear(f"{src}.layers.{i}", f"{dst}.layers.{i}")
    return out


def convert_mlp_mapping(src: str, dst: str) -> List[Entry]:
    """The reference's mlp_mapping Sequential(Linear, LN, ReLU, Dropout,
    Linear, LN, ReLU): children 0, 1, 4, 5 -> nn/mlp.py::MLPMapping."""
    return (linear(f"{src}.0", f"{dst}.fc1") + layer_norm(f"{src}.1",
                                                          f"{dst}.ln1")
            + linear(f"{src}.4", f"{dst}.fc2") + layer_norm(f"{src}.5",
                                                            f"{dst}.ln2"))


def reftr_entries(enc_layers: int = 6, dec_layers: int = 6,
                  bert_layers: int = 12, backbone: str = "resnet50",
                  num_feature_levels: int = 1) -> List[Entry]:
    """Every tensor a reference RefTR or RefTRSeg state dict (models/
    reftr_transformer.py, reftr_segmentation.py) can give the port, at the
    config's depths and levels (nn/convert.py:229-296)."""
    vl = "vl_transformer"
    out = (convert_resnet(backbone, "img_backbone.0.body", "img_backbone")
           + convert_bert(bert_layers, "lang_backbone", "lang_backbone")
           + convert_mlp_mapping("map_sentence", "map_sentence")
           + convert_mlp_mapping("map_phrase", "map_phrase")
           + embedding(f"{vl}.lang_pos_embeddings",
                       f"{vl}.lang_pos_embeddings")
           + embedding(f"{vl}.token_type_embeddings",
                       f"{vl}.token_type_embeddings")
           + [(f"{vl}.level_embed", f"{vl}.level_embed", None)]
           + convert_encoder(enc_layers, f"{vl}.encoder", f"{vl}.encoder")
           + convert_decoder(dec_layers, f"{vl}.decoder", f"{vl}.decoder")
           + [("query_encoder.query_embed.weight", "query_encoder.query_embed",
               None)]
           + linear("query_encoder.linear1", "query_encoder.linear1")
           + linear("query_encoder.linear2", "query_encoder.linear2")
           + linear("query_encoder.linear3", "query_encoder.linear3")
           + linear("query_encoder.context_out.0", "query_encoder.context_fc")
           + layer_norm("query_encoder.context_out.1",
                        "query_encoder.context_ln")
           + convert_mlp_mapping("query_encoder.fuse_encoder_query",
                                 "query_encoder.fuse_encoder_query")
           + convert_mlp(3, "bbox_embed", "bbox_embed"))
    for i in range(num_feature_levels):
        out += (conv(f"input_proj.{i}.0", f"input_proj.{i}.conv")
                + group_norm(f"input_proj.{i}.1", f"input_proj.{i}.norm"))
    # the RES heads (RefTRSeg)
    out += (linear("bbox_attention.q_linear", "bbox_attention.q_linear")
            + linear("bbox_attention.k_linear", "bbox_attention.k_linear"))
    for j in range(1, 6):
        out += (conv(f"mask_head.lay{j}", f"mask_head.lay{j}")
                + group_norm(f"mask_head.gn{j}", f"mask_head.gn{j}"))
    for j in range(1, 4):
        out += conv(f"mask_head.adapter{j}", f"mask_head.adapter{j}")
    out += conv("mask_head.out_lay", "mask_head.out_lay")
    for j in range(1, 4):
        out += linear(f"cem_block.c{j}", f"cem_block.c{j}")
    return out


def detr_entries(enc_layers: int = 6, backbone: str = "resnet50"
                 ) -> List[Entry]:
    """A DETR checkpoint's backbone and encoder (the reference's init,
    reftr_transformer.py:137-146); everything else keeps its init."""
    return (convert_resnet(backbone, "backbone.0.body", "img_backbone")
            + convert_encoder(enc_layers, "transformer.encoder",
                              "vl_transformer.encoder"))


def _strip_module(sd: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Drop the ``module.`` prefix of a checkpoint saved under DDP."""
    return {k.removeprefix("module."): v for k, v in sd.items()}


def apply_entries(sd: Mapping[str, torch.Tensor], entries: List[Entry]
                  ) -> Dict[str, torch.Tensor]:
    """The port's tensors of ``entries`` that ``sd`` holds, in float32; a
    third of a packed projection is its rows' slice."""
    out = {}
    for ref, port, third in entries:
        if ref not in sd:
            continue
        value = torch.as_tensor(sd[ref]).detach()
        if third is not None:
            value = value.chunk(3, dim=0)[third]
        out[port] = value.to(torch.float32).contiguous()
    return out


def convert_reftr(sd: Mapping[str, torch.Tensor], enc_layers: int = 6,
                  dec_layers: int = 6, bert_layers: int = 12,
                  backbone: str = "resnet50",
                  num_feature_levels: int = 1) -> Dict[str, torch.Tensor]:
    """A reference RefTR(/Seg) state dict (``module.`` prefixes allowed)
    -> the port's tensors, by name. A module the file lacks is left out,
    for the load's report to name."""
    return apply_entries(_strip_module(sd), reftr_entries(
        enc_layers, dec_layers, bert_layers, backbone, num_feature_levels))


def convert_detr(sd: Mapping[str, torch.Tensor], enc_layers: int = 6,
                 backbone: str = "resnet50") -> Dict[str, torch.Tensor]:
    """A DETR state dict -> the port's backbone and encoder tensors."""
    return apply_entries(_strip_module(sd), detr_entries(enc_layers,
                                                         backbone))


def convert_for(sd: Mapping[str, torch.Tensor], cfg
                ) -> Dict[str, torch.Tensor]:
    """The DETR branch (a checkpoint with any ``transformer.encoder``
    tensor) or the whole RefTR, at the depths of ``cfg`` (a
    ModelConfig)."""
    if any(k.removeprefix("module.").startswith("transformer.encoder")
           for k in sd):
        return convert_detr(sd, cfg.enc_layers, cfg.backbone)
    return convert_reftr(sd, cfg.enc_layers, cfg.dec_layers,
                         cfg.bert.num_hidden_layers, cfg.backbone,
                         cfg.num_feature_levels)


def reference_state_dict(state_dict: Mapping[str, torch.Tensor], cfg
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a model of ``cfg`` (a ModelConfig)
    under the reference's names, q, k and v packed into ``in_proj_*``:
    what ``convert_reftr`` reads back. Tensors the reference has no name
    for (the vision probe's) are left out."""
    entries = reftr_entries(cfg.enc_layers, cfg.dec_layers,
                            cfg.bert.num_hidden_layers, cfg.backbone,
                            cfg.num_feature_levels)
    out: Dict[str, torch.Tensor] = {}
    packed: Dict[str, list] = {}
    for ref, port, third in entries:
        if port not in state_dict:
            continue
        value = state_dict[port].detach()
        if third is None:
            out[ref] = value
        else:
            packed.setdefault(ref, [None] * 3)[third] = value
    for ref, parts in packed.items():
        out[ref] = torch.cat(parts, dim=0)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` of a reference checkpoint on the host; its model
    state dict, unwrapped from main_vg.py's ``{"model": ...}``. The file
    holds an ``args`` namespace, so it is not loaded weights-only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        return ckpt["model"]
    return ckpt


def save_reference_checkpoint(path: str, state_dict: Mapping[str,
                                                              torch.Tensor],
                              cfg, epoch: int = 0) -> str:
    """Write the port's ``state_dict`` (a model of ``cfg``) as the
    reference's ``main_vg.py`` saves a checkpoint under DDP (:377-385):
    ``{"model", "optimizer", "lr_scheduler", "epoch", "args"}``, every
    name ``module.``-prefixed, float32 tensors on the host."""
    import argparse

    model = {f"module.{k}": v.detach().to("cpu", torch.float32).contiguous()
             for k, v in reference_state_dict(state_dict, cfg).items()}
    args = argparse.Namespace(
        backbone=cfg.backbone, enc_layers=cfg.enc_layers,
        dec_layers=cfg.dec_layers, hidden_dim=cfg.hidden_dim,
        nheads=cfg.nheads, num_feature_levels=cfg.num_feature_levels,
        masks=cfg.masks, bert_model=cfg.bert_model)
    torch.save({"model": model, "optimizer": {}, "lr_scheduler": {},
                "epoch": epoch, "args": args}, path)
    return path
