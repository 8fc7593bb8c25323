"""RefTRSeg: REC + referring expression segmentation (port of
reftr_tpu/models/reftr_seg.py:35-141).

  * the REC trunk of RefTR, one feature level (another number is
    refused, as the JAX package asserts) and one phrase (a batch's phrase
    keys are left out); the box head on the last decoder layer only, with
    no aux outputs;
  * the encoder's visual memory reshaped back to the [h, w] map and
    concatenated with the projected backbone features (2 * hidden
    channels), the per-head query -> pixel attention (MHAttentionMap),
    then the FPN mask head over the backbone's C3, C2 and C1, giving mask
    logits at 1/4 of the canvas;
  * with ``ablation="cem_loss"`` the CEM energy loss;
  * the trunk's from-scratch options as in RefTR (``img_pos_in_stream``
    enters the encoder's input only: the mask head takes the projected
    features without it, reftr_tpu/models/reftr_seg.py:83-86, 117);
  * ``freeze_reftr``: the trunk's parameters get requires_grad=False (the
    reference freezes them before it builds the mask branch and CEM) and
    the trunk runs without a graph, where the JAX package puts
    stop_gradient at its outputs; so its attentions run no backward.

Outputs: pred_boxes [B, 1, nq, 4], phrase_mask [B, nq], pred_masks
[B, nq, H/4, W/4] float32 logits, mask_att [B, heads, h, w] (query 0's
attention maps) and, with cem_loss, cem_loss (a scalar).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict

import torch

from reftr_torch.core.config import ModelConfig
from reftr_torch.models.reftr import RefTR
from reftr_torch.nn.seg_heads import CEM, MaskHeadSmallConv, MHAttentionMap

# channels of the backbone's C3, C2 and C1 (ResNet-50 and -101)
FPN_DIMS = (1024, 512, 256)
PHRASE_KEYS = ("phrases", "phrase_valid", "phrase_pos_l", "phrase_pos_r")


class RefTRSeg(RefTR):
    def __init__(self, config: ModelConfig):
        mc = config
        if mc.num_feature_levels != 1:
            raise ValueError("RefTRSeg supports a single feature level "
                             "(reference :83-84)")
        super().__init__(config)
        if mc.freeze_reftr:
            self.requires_grad_(False)
        self.bbox_attention = MHAttentionMap(mc.hidden_dim, mc.nheads)
        self.mask_head = MaskHeadSmallConv(2 * mc.hidden_dim + mc.nheads,
                                           FPN_DIMS, mc.hidden_dim)
        if mc.cem_loss:
            self.cem_block = CEM(mc.hidden_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                return_internals: bool = False) -> Dict[str, Any]:
        mc = self.config
        n_q = mc.num_queries_per_phrase
        sentence_valid = batch["sentence_valid"].bool()
        b, s = sentence_valid.shape

        with torch.no_grad() if mc.freeze_reftr else nullcontext():
            feats = self.run_backbone(batch["image"])
            srcs, img_valids, img_poss = self.project_features(
                feats, batch["image_valid"])
            sentence_feat, pooled = self.encode_language(batch["sentence"],
                                                         sentence_valid)
            # RES is single-phrase (reference :96-106)
            phrase_pooled, context_valid, query_valid = self.phrase_inputs(
                {k: v for k, v in batch.items() if k not in PHRASE_KEYS},
                pooled)
            memory, memory_valid, memory_pos = self.vl_transformer.encode(
                self.in_stream(srcs, img_poss), img_valids, img_poss,
                sentence_feat, sentence_valid)
            query, query_pos = self.query_encoder(memory[:, :s],
                                                  phrase_pooled,
                                                  context_valid)
            hs = self.vl_transformer.decode(query, query_pos, query_valid,
                                            memory, memory_valid, memory_pos)
            # the box head on the last layer only, no aux (reference
            # :134-137)
            last_hs = hs[-1].reshape(b, 1, n_q, -1)
            coords = torch.sigmoid(self.bbox_embed(last_hs).float())
        out: Dict[str, Any] = {"pred_boxes": coords,
                               "phrase_mask": query_valid}

        src, img_valid = srcs[0], img_valids[0]
        h, w = src.shape[1:3]
        memory_visual = memory[:, s:].reshape(b, h, w, -1)
        img_src = torch.cat([src, memory_visual], -1)  # [B, h, w, 2D]
        bbox_mask = self.bbox_attention(hs[-1], memory_visual, img_valid)
        # image features tiled per query, the attention maps as channels
        nq = bbox_mask.shape[1]
        x = img_src.permute(0, 3, 1, 2).repeat_interleave(nq, 0)
        att = bbox_mask.reshape(b * nq, -1, h, w)
        x = torch.cat([x, att.to(x.dtype)], 1)
        fpns = [f.permute(0, 3, 1, 2) for f in (feats[2], feats[1], feats[0])]
        seg_logits, res_feat = self.mask_head(x, fpns)
        oh, ow = seg_logits.shape[-2:]
        out["pred_masks"] = seg_logits.reshape(b, nq, oh, ow).float()
        out["mask_att"] = bbox_mask[:, 0]
        if mc.cem_loss:
            res = res_feat.reshape(b, nq, -1, oh, ow)[:, 0]
            out["cem_loss"] = self.cem_block(last_hs, res.permute(0, 2, 3, 1))
        if return_internals:
            out["internals"] = {"memory": memory, "hs": hs,
                                "res_feat": res_feat}
        return out
