"""2D sinusoidal position embedding, padding-aware (port of
reftr_tpu/ops/posenc.py:19). NHWC output, like the JAX package."""

from __future__ import annotations

import math
from typing import Optional

import torch


def sine_position_embedding(valid_mask: torch.Tensor,
                            num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """valid_mask [B, H, W] bool (True = real pixel) ->
    [B, H, W, 2 * num_pos_feats] float32, y channels before x channels."""
    if scale is None:
        scale = 2.0 * math.pi
    not_mask = valid_mask.to(torch.float32)
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        eps = 1e-6
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=valid_mask.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    # interleave: out[2k] = sin(v / dim_t[2k]), out[2k+1] = cos(v / dim_t[2k+1])
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=4).flatten(3)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=4).flatten(3)
    return torch.cat([pos_y, pos_x], dim=3)
