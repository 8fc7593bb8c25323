"""RefTR, single-phrase REC (port of reftr_tpu/models/reftr.py:53-376).

  image [B,H,W,3] -> ResNet (FrozenBN) -> 1x1 proj + GroupNorm(32) ->
  sentence [B,S]  -> BERT -> MLP map ->
  VL encoder over [lang; img] -> QueryEncoder -> decoder -> 3-layer MLP ->
  sigmoid cxcywh boxes per (phrase, query).

Batch dict (validity masks True = real): image [B,H,W,3] uint8 canvases
(normalised on the device) or normalised float, image_valid [B,H,W] bool,
sentence [B,S] int token ids, sentence_valid [B,S].

Outputs: pred_boxes [B,1,nq,4] sigmoid cxcywh, phrase_mask [B,nq],
aux_outputs (per decoder layer but the last, with aux_loss) and, with
return_internals, the encoder memory and decoder states.

Not in this slice: multi-phrase inputs, more than one feature level,
``vision_aux`` and ``heatmap_box`` raise NotImplementedError; the RES mask
head and the other from-scratch options (img_pos_in_stream,
pos_in_value) have no config field yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from reftr_torch.core.config import ModelConfig
from reftr_torch.models.vl_transformer import VLTransformer
from reftr_torch.nn.bert import BertModel
from reftr_torch.nn.mlp import MLP, MLPMapping
from reftr_torch.nn.posembed import ImagePositionEmbedding
from reftr_torch.nn.query_encoder import QueryEncoder
from reftr_torch.nn.resnet import FrozenBatchNorm, ResNet, downsample_mask
from reftr_torch.ops.image import normalize_images

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class InputProj(nn.Module):
    """1x1 conv + GroupNorm(32), on NCHW."""

    def __init__(self, in_channels: int, hidden_dim: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden_dim, 1)
        self.norm = nn.GroupNorm(32, hidden_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class RefTR(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        mc = config
        if mc.num_feature_levels != 1:
            raise NotImplementedError(
                "the port serves one feature level; multi-level comes later")
        if mc.vision_aux or mc.heatmap_box:
            raise NotImplementedError(
                "vision_aux and heatmap_box come with a later slice")
        self.config = mc
        self.dtype = _DTYPES[mc.dtype]
        self.img_backbone = ResNet(mc.backbone, mc.dilation)
        self.lang_backbone = BertModel(mc.bert)
        self.map_sentence = MLPMapping(mc.bert.hidden_size, mc.hidden_dim)
        self.vl_transformer = VLTransformer(
            d_model=mc.hidden_dim, nhead=mc.nheads,
            num_encoder_layers=mc.enc_layers,
            num_decoder_layers=mc.dec_layers,
            dim_feedforward=mc.dim_feedforward, activation=mc.activation,
            normalize_before=mc.normalize_before,
            num_feature_levels=mc.num_feature_levels,
            max_lang_seq=mc.max_lang_seq)
        self.map_phrase = MLPMapping(mc.bert.hidden_size, mc.hidden_dim)
        self.query_encoder = QueryEncoder(mc.num_queries_per_phrase,
                                          mc.hidden_dim)
        self.bbox_embed = MLP(mc.hidden_dim, mc.hidden_dim, 4, 3,
                              final_zero_init=True)
        self.pos_embedding = ImagePositionEmbedding(mc.hidden_dim,
                                                    mc.position_embedding)
        self.input_proj = nn.ModuleList([InputProj(2048, mc.hidden_dim)])

    def cast_to_compute_dtype(self) -> "RefTR":
        """Cast parameters and buffers to the compute dtype, except the
        FrozenBatchNorm statistics, which stay float32 (the JAX package
        keeps all parameters f32 and computes the BN scale in f32)."""
        frozen = {id(t) for m in self.modules()
                  if isinstance(m, FrozenBatchNorm) for t in m.buffers()}
        for t in list(self.parameters()) + list(self.buffers()):
            if id(t) not in frozen and t.is_floating_point():
                t.data = t.data.to(self.dtype)
        return self

    def extract_image_features(self, image: torch.Tensor,
                               image_valid: torch.Tensor):
        """Backbone + projection + mask and sine position per level.
        Returns (srcs, valids, poss), lists per level, NHWC."""
        if image.dtype == torch.uint8:
            image = normalize_images(image, self.dtype)
        feat = self.img_backbone(image.to(self.dtype))
        # backbone features are the NHWC view of NCHW channels-last memory
        src = self.input_proj[0](feat.permute(0, 3, 1, 2))
        src = src.permute(0, 2, 3, 1)
        valid = downsample_mask(image_valid.bool(), tuple(src.shape[1:3]))
        pos = self.pos_embedding(valid).to(src.dtype)
        return [src], [valid], [pos]

    def encode_language(self, sentence, sentence_valid):
        seq, pooled = self.lang_backbone(sentence, sentence_valid)
        return self.map_sentence(seq), pooled

    def phrase_inputs(self, batch: Dict[str, torch.Tensor],
                      pooled_sentence: torch.Tensor):
        """Single phrase: the pooled sentence feature, a context mask that
        excludes [CLS], the final [SEP] and padding, and all queries valid.
        Returns (phrase_pooled [B,1,D], context_valid [B,1,S],
        query_valid [B,nq])."""
        if "phrases" in batch:
            raise NotImplementedError("multi-phrase inputs come later")
        sentence_valid = batch["sentence_valid"].bool()
        b, s = sentence_valid.shape
        lengths = sentence_valid.long().sum(-1)
        t = torch.arange(s, device=sentence_valid.device)[None, :]
        context_valid = (sentence_valid & (t != 0)
                         & (t != (lengths - 1)[:, None]))[:, None, :]
        query_valid = torch.ones(b, self.config.num_queries_per_phrase,
                                 dtype=torch.bool,
                                 device=sentence_valid.device)
        phrase_pooled = self.map_phrase(pooled_sentence[:, None, :])
        return phrase_pooled, context_valid, query_valid

    def forward(self, batch: Dict[str, torch.Tensor],
                return_internals: bool = False) -> Dict[str, Any]:
        mc = self.config
        n_q = mc.num_queries_per_phrase
        sentence_valid = batch["sentence_valid"].bool()
        b, s = sentence_valid.shape

        srcs, img_valids, img_poss = self.extract_image_features(
            batch["image"], batch["image_valid"])
        sentence_feat, pooled = self.encode_language(batch["sentence"],
                                                     sentence_valid)
        phrase_pooled, context_valid, query_valid = self.phrase_inputs(
            batch, pooled)
        memory, memory_valid, memory_pos = self.vl_transformer.encode(
            srcs, img_valids, img_poss, sentence_feat, sentence_valid)
        query, query_pos = self.query_encoder(memory[:, :s], phrase_pooled,
                                              context_valid)
        hs = self.vl_transformer.decode(query, query_pos, query_valid,
                                        memory, memory_valid, memory_pos)
        n_layers = hs.shape[0]
        n_ph = query_valid.shape[1] // n_q
        hs_r = hs.reshape(n_layers, b, n_ph, n_q, -1)
        coords = torch.sigmoid(self.bbox_embed(hs_r).float())

        out: Dict[str, Any] = {"pred_boxes": coords[-1],
                               "phrase_mask": query_valid}
        if mc.aux_loss:
            out["aux_outputs"] = [
                {"pred_boxes": coords[i], "phrase_mask": query_valid}
                for i in range(n_layers - 1)]
        if return_internals:
            out["internals"] = {
                "memory": memory,
                "memory_valid": memory_valid,
                "srcs": srcs,
                "img_valids": img_valids,
                "hs": hs_r,
                "lang_len": s,
            }
        return out
