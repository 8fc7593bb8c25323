"""Fused visual-linguistic transformer (port of
reftr_tpu/models/vl_transformer.py): an encoder over the ``[lang; img]``
sequence and a decoder over phrase queries.

Learned language position and 2-way token-type embeddings, a per-level
``level_embed`` added to the image position encoding, image levels
flattened and concatenated after the language tokens (so
``memory[:, :S_lang]`` is the language memory). Batch-first; masks are
validity masks (True = real token). ``pos_in_value``: the decoder's
cross-attention values carry the memory's position (``nn/transformer.py``).
``remat``: the encoder's layers are recomputed in the backward, the
decoder's kept, as in reftr_tpu/models/vl_transformer.py:39, 64.
``quantize``: the encoder's and decoder's projections and FFNs run as int8
products (reftr_tpu/models/vl_transformer.py:41, 65, 72).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from reftr_torch.nn.transformer import TransformerDecoder, TransformerEncoder


class VLTransformer(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, activation: str = "relu",
                 normalize_before: bool = False, num_feature_levels: int = 1,
                 max_lang_seq: int = 128, dropout: float = 0.1,
                 pos_in_value: bool = False, remat: bool = False,
                 quantize: bool = False):
        super().__init__()
        if num_decoder_layers <= 0:
            raise NotImplementedError("the serving path needs a decoder")
        self.max_lang_seq = max_lang_seq
        self.lang_pos_embeddings = nn.Embedding(max_lang_seq, d_model)
        self.token_type_embeddings = nn.Embedding(2, d_model)
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels,
                                                    d_model))
        self.encoder = TransformerEncoder(
            num_encoder_layers, d_model, nhead, dim_feedforward, activation,
            normalize_before, dropout=dropout, remat=remat,
            quantize=quantize)
        self.decoder = TransformerDecoder(
            num_decoder_layers, d_model, nhead, dim_feedforward, activation,
            normalize_before, dropout=dropout, pos_in_value=pos_in_value,
            quantize=quantize)

    def process_img_feat(self, img_srcs: Sequence[torch.Tensor],
                         img_valids: Sequence[torch.Tensor],
                         img_pos: Sequence[torch.Tensor]):
        """Per level [B, h, w, D] sources and positions, [B, h, w] masks ->
        flattened and concatenated over levels, positions + level and
        token-type (1 = image) embeddings."""
        srcs: List[torch.Tensor] = []
        valids: List[torch.Tensor] = []
        poss: List[torch.Tensor] = []
        for lvl, (src, valid, pos) in enumerate(zip(img_srcs, img_valids,
                                                    img_pos)):
            b, h, w, d = src.shape
            srcs.append(src.reshape(b, h * w, d))
            valids.append(valid.reshape(b, h * w))
            poss.append(pos.reshape(b, h * w, d)
                        + self.level_embed[lvl].to(src.dtype))
        src = torch.cat(srcs, dim=1)
        valid = torch.cat(valids, dim=1)
        pos = torch.cat(poss, dim=1)
        tt = self.token_type_embeddings.weight[1].to(src.dtype)
        return src, valid, pos + tt

    def process_lang_feat(self, lang_src: torch.Tensor,
                          lang_valid: torch.Tensor):
        s = lang_src.shape[1]
        if s > self.max_lang_seq:
            raise ValueError(f"sentence length {s} > max_lang_seq "
                             f"{self.max_lang_seq}")
        pos = (self.lang_pos_embeddings.weight[:s]
               + self.token_type_embeddings.weight[0])
        pos = pos.to(lang_src.dtype).expand(lang_src.shape[0], s, -1)
        return lang_src, lang_valid.bool(), pos

    def encode(self, img_srcs, img_valids, img_pos, lang_src, lang_valid
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (memory [B, S_lang + S_img, D], valid, pos)."""
        i_src, i_valid, i_pos = self.process_img_feat(img_srcs, img_valids,
                                                      img_pos)
        l_src, l_valid, l_pos = self.process_lang_feat(lang_src, lang_valid)
        src = torch.cat([l_src, i_src], dim=1)
        valid = torch.cat([l_valid, i_valid], dim=1)
        pos = torch.cat([l_pos, i_pos], dim=1)
        return self.encoder(src, pos, valid), valid, pos

    def decode(self, query, query_pos, query_valid, memory, memory_valid,
               memory_pos) -> torch.Tensor:
        """Returns the [L, B, n_queries, D] decoder intermediate stack."""
        return self.decoder(query, memory, query_valid, memory_valid,
                            memory_pos, query_pos)
