"""Image position embedding: sine (default) or learned (port of
reftr_tpu/nn/posembed.py). NHWC output."""

from __future__ import annotations

import torch
from torch import nn

from reftr_torch.ops.posenc import sine_position_embedding


class ImagePositionEmbedding(nn.Module):
    def __init__(self, hidden_dim: int, kind: str = "sine"):
        super().__init__()
        if kind not in ("sine", "learned"):
            raise ValueError(f"position embedding {kind!r}")
        self.kind = kind
        self.n = hidden_dim // 2
        if kind == "learned":
            # 50x50 row/col tables, [col, row] along channels
            self.row_embed = nn.Embedding(50, self.n)
            self.col_embed = nn.Embedding(50, self.n)

    def forward(self, valid_mask: torch.Tensor) -> torch.Tensor:
        """valid_mask [B, H, W] bool -> [B, H, W, hidden_dim] float32 for
        sine, the tables' dtype for learned."""
        if self.kind == "sine":
            return sine_position_embedding(valid_mask, self.n)
        b, h, w = valid_mask.shape
        row = self.row_embed.weight[:h]
        col = self.col_embed.weight[:w]
        pos = torch.cat([col[None, :, :].expand(h, w, self.n),
                         row[:, None, :].expand(h, w, self.n)], dim=-1)
        return pos[None].expand(b, h, w, 2 * self.n)
