"""RefTR, REC over one or many phrases per sentence (port of
reftr_tpu/models/reftr.py:53-376).

  image [B,H,W,3] -> ResNet (FrozenBN) -> 1x1 proj + GroupNorm(32) per
  level (+ 3x3/stride-2 extras) ->
  sentence [B,S]  -> BERT -> MLP map ->
  VL encoder over [lang; img] -> QueryEncoder -> decoder -> 3-layer MLP ->
  sigmoid cxcywh boxes per (phrase, query).

Batch dict (validity masks True = real): image [B,H,W,3] uint8 canvases
(normalised on the device) or normalised float, image_valid [B,H,W] bool,
sentence [B,S] int token ids, sentence_valid [B,S]. Multi-phrase adds
phrases [B,P,Sp] and phrase_valid [B,P,Sp], each phrase tokenised alone,
and phrase_pos_l / phrase_pos_r [B,P], its token span [l, r) in the
sentence; the ``phrases`` key selects that path, as in the JAX package.

Outputs: pred_boxes [B,P,nq,4] sigmoid cxcywh (P = 1 for one phrase),
phrase_mask [B,P*nq] (True = a real phrase's query), aux_outputs (per
decoder layer but the last, with aux_loss) and, with return_internals,
the encoder memory and decoder states.

Feature levels: one (layer4) or, with ``num_feature_levels`` > 1, the
last min(nfl, 3) backbone stages each through its own 1x1 projection,
then 3x3/stride-2 projections of the previous level up to nfl (the JAX
package's deformable-DETR scheme, reftr_tpu/models/reftr.py:27-31).

Training (``model.train()``) keeps the parameters float32 and runs the
compute dtype through ``torch.autocast`` (``train/steps.py``); dropout is
``ModelConfig.dropout`` in the VL modules and the BERT config's rates in
BERT. The ResNet stem and layer1 never train unless ``train_stem`` (every
stage with ``freeze_backbone``), nor BERT with ``freeze_bert``
(reftr_tpu/models/reftr.py:94-104, 226-227, 252): their parameters get
``requires_grad=False`` and they run without a graph, over the sentence
and over the phrases.

The JAX step's knobs (reftr_tpu/core/config.py:177-201): the backbone's
reparameterisations and ``backbone_remat`` act in ``nn/resnet.py`` (under
``fold_normalize`` a uint8 canvas is only cast, its normalisation being
in the stem, and a float image raises), ``remat`` in the VL encoder, and
``use_pallas_attention`` routes every attention (``nn/attention.py``).

The from-scratch options (reftr_tpu/core/config.py:103-167):
``backbone_norm="group"`` and ``train_stem`` act in the backbone;
``img_pos_in_stream`` adds each level's sine position into its projected
features before the encoder (q/k positions as before);
``decoder_pos_in_value`` adds the memory's position into the decoder's
cross-attention values; ``vision_aux`` runs ``vision_probe``, a Linear(d,
1) in float32, on the encoder's image tokens of each level and returns
``vision_logits`` and ``vision_valid`` (per level [B, h, w]); with
``heatmap_box`` the final box is ``heatmap_box`` of level 0's logits and
the decoder's last layer joins aux_outputs.

RES (``masks``) is ``models/reftr_seg.py::RefTRSeg``, which runs this
trunk; ``freeze_reftr`` belongs to it and is refused without ``masks``,
and ``vision_aux`` with ``masks`` by ``convert.model_class`` (RES's mask
loss supervises the image; the CLI turns the flag off under masks).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict

import torch
from torch import nn

from reftr_torch.core.config import ModelConfig
from reftr_torch.models.vl_transformer import VLTransformer
from reftr_torch.nn.attention import set_attention_route
from reftr_torch.nn.bert import BertModel
from reftr_torch.nn.mlp import MLP, MLPMapping
from reftr_torch.nn.posembed import ImagePositionEmbedding
from reftr_torch.nn.query_encoder import QueryEncoder
from reftr_torch.nn.resnet import NORMS, ResNet, downsample_mask
from reftr_torch.ops.boxes import valid_cell_centres
from reftr_torch.ops.image import normalize_images

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# output channels of the backbone's stages C1-C4 (ResNet-50 and -101)
STAGE_CHANNELS = (256, 512, 1024, 2048)


class InputProj(nn.Module):
    """1x1 (or 3x3, stride 2) conv + GroupNorm(32), on NCHW."""

    def __init__(self, in_channels: int, hidden_dim: int, kernel: int = 1,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, hidden_dim, kernel, stride,
                              padding=(kernel - 1) // 2)
        self.norm = nn.GroupNorm(32, hidden_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class RefTR(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        mc = config
        if mc.freeze_reftr and not mc.masks:
            raise ValueError("freeze_reftr freezes the REC trunk under RES's "
                             "mask head: it needs masks")
        self.config = mc
        self.dtype = _DTYPES[mc.dtype]
        # the backbone's four stages (RES's mask head, more than one
        # feature level) or layer4 alone
        self.img_backbone = ResNet(
            mc.backbone, mc.dilation,
            mc.masks or mc.num_feature_levels > 1, mc.backbone_norm,
            space_to_depth=mc.space_to_depth_stem, fold_bn=mc.fold_bn,
            min_inner_width=mc.backbone_pad_width,
            block_layer1=mc.block_layer1, remat_blocks=mc.backbone_remat,
            remat_stages=tuple(mc.backbone_remat_stages))
        self.img_backbone.freeze(
            4 if mc.freeze_backbone or mc.freeze_reftr
            else 0 if mc.train_stem else 1)
        self.lang_backbone = BertModel(mc.bert)
        if mc.freeze_bert:
            self.lang_backbone.requires_grad_(False)
        self.map_sentence = MLPMapping(mc.bert.hidden_size, mc.hidden_dim,
                                       mc.dropout)
        self.vl_transformer = VLTransformer(
            d_model=mc.hidden_dim, nhead=mc.nheads,
            num_encoder_layers=mc.enc_layers,
            num_decoder_layers=mc.dec_layers,
            dim_feedforward=mc.dim_feedforward, activation=mc.activation,
            normalize_before=mc.normalize_before,
            num_feature_levels=mc.num_feature_levels,
            max_lang_seq=mc.max_lang_seq, dropout=mc.dropout,
            pos_in_value=mc.decoder_pos_in_value, remat=mc.remat)
        self.map_phrase = MLPMapping(mc.bert.hidden_size, mc.hidden_dim,
                                     mc.dropout)
        self.query_encoder = QueryEncoder(mc.num_queries_per_phrase,
                                          mc.hidden_dim, mc.dropout)
        self.bbox_embed = MLP(mc.hidden_dim, mc.hidden_dim, 4, 3,
                              final_zero_init=True)
        self.vision_aux = mc.vision_aux
        if self.vision_aux:
            self.vision_probe = nn.Linear(mc.hidden_dim, 1)
        self.pos_embedding = ImagePositionEmbedding(mc.hidden_dim,
                                                    mc.position_embedding)
        nfl = mc.num_feature_levels
        n_base = min(nfl, 3)
        self.input_proj = nn.ModuleList(
            [InputProj(c, mc.hidden_dim) for c in STAGE_CHANNELS[-n_base:]]
            + [InputProj(mc.hidden_dim, mc.hidden_dim, 3, 2)
               for _ in range(n_base, nfl)])
        set_attention_route(self, mc.use_pallas_attention)

    def cast_to_compute_dtype(self) -> "RefTR":
        """Cast parameters and buffers to the compute dtype, except the
        backbone norms' (FrozenBatchNorm's statistics, GroupNorm's affine)
        and the vision probe's, which stay float32 (the JAX package keeps
        all parameters f32, computes the norms in f32 and runs the probe in
        f32).

        For serving only: training keeps every parameter float32 and runs
        the compute dtype through ``torch.autocast``."""
        keep = [m for m in self.modules()
                if isinstance(m, tuple(NORMS.values()))]
        if self.vision_aux:
            keep.append(self.vision_probe)
        kept = {id(t) for m in keep
                for t in [*m.buffers(), *m.parameters()]}
        for t in list(self.parameters()) + list(self.buffers()):
            if id(t) not in kept and t.is_floating_point():
                t.data = t.data.to(self.dtype)
        return self

    def extract_image_features(self, image: torch.Tensor,
                               image_valid: torch.Tensor):
        """Backbone + projection + mask and sine position per level.
        Returns (srcs, valids, poss), lists per level, NHWC."""
        return self.project_features(self.run_backbone(image), image_valid)

    def run_backbone(self, image: torch.Tensor):
        """The backbone on uint8 canvases (normalised here) or normalised
        float images: layer4, or the four stages with masks or more than
        one feature level, NHWC. Under ``fold_normalize`` the stem holds
        the normalisation, so a uint8 canvas is only cast to the compute
        dtype and a float image raises (reftr_tpu/models/reftr.py:
        182-193)."""
        if image.dtype == torch.uint8:
            if not self.config.fold_normalize:
                image = normalize_images(image, self.dtype)
        elif self.config.fold_normalize:
            raise ValueError(
                "fold_normalize expects uint8 image inputs (the affine is "
                "in the stem weights; float inputs would be normalized "
                "twice)")
        return self.img_backbone(image.to(self.dtype))

    def project_features(self, feats, image_valid: torch.Tensor):
        """Projections, masks and sine positions of the backbone's output
        ``feats`` (layer4, or the four stages): the last min(nfl, 3) maps
        each through its projection, then each extra level from the one
        before. Returns (srcs, valids, poss), lists per level, NHWC."""
        if isinstance(feats, torch.Tensor):
            feats = (feats,)
        n_base = min(self.config.num_feature_levels, 3)
        # backbone features are the NHWC view of NCHW channels-last memory
        srcs = [proj(f.permute(0, 3, 1, 2)) for proj, f in
                zip(self.input_proj, feats[-n_base:])]
        for proj in self.input_proj[n_base:]:
            srcs.append(proj(srcs[-1]))
        srcs = [src.permute(0, 2, 3, 1) for src in srcs]
        valids, poss = [], []
        for src in srcs:
            valid = downsample_mask(image_valid.bool(),
                                    tuple(src.shape[1:3]))
            valids.append(valid)
            poss.append(self.pos_embedding(valid).to(src.dtype))
        return srcs, valids, poss

    def run_bert(self, ids, valid):
        """BERT's (sequence, pooled) output, without a graph under
        freeze_bert."""
        with torch.no_grad() if self.config.freeze_bert else nullcontext():
            return self.lang_backbone(ids, valid)

    def encode_language(self, sentence, sentence_valid):
        seq, pooled = self.run_bert(sentence, sentence_valid)
        return self.map_sentence(seq), pooled

    def phrase_inputs(self, batch: Dict[str, torch.Tensor],
                      pooled_sentence: torch.Tensor):
        """Per-phrase pooled features, context validity and query validity
        (reftr_tpu/models/reftr.py:231-266).

        Multi-phrase (a ``phrases`` key): BERT's pooled output over the
        B*P phrases, the context inside each phrase's token span
        [phrase_pos_l, phrase_pos_r), and a phrase's queries valid where
        its third token is real (an empty phrase is "[CLS] [SEP]").
        Single phrase: the pooled sentence feature, a context mask that
        excludes [CLS], the final [SEP] and padding, and all queries valid.
        Returns (phrase_pooled [B,P,D], context_valid [B,P,S],
        query_valid [B,P*nq])."""
        n_q = self.config.num_queries_per_phrase
        sentence_valid = batch["sentence_valid"].bool()
        b, s = sentence_valid.shape
        t = torch.arange(s, device=sentence_valid.device)
        if "phrases" in batch:
            phrase_valid = batch["phrase_valid"]
            _, n_ph, sp = batch["phrases"].shape
            _, pooled = self.run_bert(batch["phrases"].reshape(b * n_ph, sp),
                                      phrase_valid.reshape(b * n_ph, sp))
            phrase_pooled = pooled.reshape(b, n_ph, -1)
            context_valid = ((t >= batch["phrase_pos_l"][:, :, None])
                             & (t < batch["phrase_pos_r"][:, :, None]))
            query_valid = phrase_valid[:, :, 2].bool()[:, :, None].expand(
                b, n_ph, n_q).reshape(b, n_ph * n_q)
        else:
            lengths = sentence_valid.long().sum(-1)
            context_valid = (sentence_valid & (t != 0)
                             & (t != (lengths - 1)[:, None]))[:, None, :]
            query_valid = torch.ones(b, n_q, dtype=torch.bool,
                                     device=sentence_valid.device)
            phrase_pooled = pooled_sentence[:, None, :]
        return self.map_phrase(phrase_pooled), context_valid, query_valid

    def in_stream(self, srcs, poss):
        """The encoder's image input: the projected features, plus their
        sine position with ``img_pos_in_stream``."""
        if not self.config.img_pos_in_stream:
            return srcs
        return [src + pos for src, pos in zip(srcs, poss)]

    def vision_logits(self, memory: torch.Tensor, srcs, lang_len: int):
        """vision_probe over the encoder's image tokens of each level
        (memory is [B, S + sum(h * w), D], levels in ``srcs``' order), in
        float32 whatever the compute dtype (its parameters stay float32):
        per level [B, h, w] logits."""
        b = memory.shape[0]
        logits, off = [], lang_len
        with torch.autocast(memory.device.type, enabled=False):
            for src in srcs:
                h, w = src.shape[1:3]
                tok = memory[:, off:off + h * w].float()
                off += h * w
                logits.append(self.vision_probe(tok).reshape(b, h, w))
        return logits

    def forward(self, batch: Dict[str, torch.Tensor],
                return_internals: bool = False) -> Dict[str, Any]:
        mc = self.config
        n_q = mc.num_queries_per_phrase
        sentence_valid = batch["sentence_valid"].bool()
        b, s = sentence_valid.shape

        srcs, img_valids, img_poss = self.extract_image_features(
            batch["image"], batch["image_valid"])
        srcs = self.in_stream(srcs, img_poss)
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
        if self.vision_aux:
            logits = self.vision_logits(memory, srcs, s)
            out["vision_logits"] = logits
            out["vision_valid"] = img_valids
            if mc.heatmap_box:
                if "phrases" in batch or n_q != 1:
                    raise ValueError(
                        "heatmap_box supports single-phrase REC only (one "
                        "query, one box per image)")
                out["pred_boxes"] = heatmap_box(
                    logits[0], img_valids[0]).reshape(b, 1, 1, 4)
        # with heatmap_box the decoder's last layer moves into the aux list,
        # so the query path keeps training end to end; without aux_loss
        # nothing supervises the decoder then, as in the JAX package
        n_aux = n_layers if self.vision_aux and mc.heatmap_box \
            else n_layers - 1
        if mc.aux_loss:
            out["aux_outputs"] = [
                {"pred_boxes": coords[i], "phrase_mask": query_valid}
                for i in range(n_aux)]
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


def heatmap_box(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The soft-argmax box of a vision_aux heatmap (heatmap_box; port of
    reftr_tpu/models/reftr.py:273-296): logits [B, h, w], valid [B, h, w]
    -> [B, 4] cxcywh in the boxes' frame (``valid_cell_centres``). The
    centre is the centroid of sigmoid(logits) over the valid cells,
    normalised to sum 1; the extent sqrt(12 * variance) of each marginal,
    exact for a filled axis-aligned rectangle; clipped to [1e-4, 1]."""
    xs, ys = valid_cell_centres(valid)
    q = torch.sigmoid(logits.float()) * valid.float()
    q = q / q.sum((1, 2), keepdim=True).clamp(min=1e-6)
    qx, qy = q.sum(1), q.sum(2)  # [B, w], [B, h] marginals
    cx = (qx * xs).sum(-1)
    cy = (qy * ys).sum(-1)
    bw = torch.sqrt(12.0 * (qx * (xs - cx[:, None]) ** 2).sum(-1) + 1e-12)
    bh = torch.sqrt(12.0 * (qy * (ys - cy[:, None]) ** 2).sum(-1) + 1e-12)
    return torch.stack([cx, cy, bw, bh], dim=-1).clamp(1e-4, 1.0)
