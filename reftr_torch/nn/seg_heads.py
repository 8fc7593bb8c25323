"""Segmentation heads: the per-pixel attention map, the FPN mask head and
CEM (port of reftr_tpu/nn/seg_heads.py:28-151).

  * MHAttentionMap: per-head query -> pixel attention that returns only
    the softmax map, taken jointly over heads x pixels;
  * MaskHeadSmallConv: five conv + GroupNorm(8) stages with three FPN
    adapters (backbone C3, C2, C1) and nearest upsampling; returns the
    1-channel logits and the features before the last conv (res_feat);
  * CEM: the energy loss between the decoder's REC features and the mask
    head's RES features (--ablation cem_loss).

The JAX heads are NHWC; here the convolutions run NCHW (channels_last
memory on a card). GroupNorm groups contiguous channels on both sides, so
the channel order of the head's input decides parity.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reftr_torch.kernels.attention import NEG_INF

# GroupNorm's groups in every stage of the mask head
MASK_HEAD_GROUPS = 8


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two axes (NCHW or [..., H, W]) with
    F.interpolate(mode='nearest')'s index rule, src = floor(dst * in/out),
    the indices built from the two sizes alone."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    dev = x.device
    ys = torch.floor(torch.arange(oh, dtype=torch.float32, device=dev)
                     * (h / oh)).long()
    xs = torch.floor(torch.arange(ow, dtype=torch.float32, device=dev)
                     * (w / ow)).long()
    return x.index_select(-2, ys).index_select(-1, xs)


class MHAttentionMap(nn.Module):
    """q [B, Q, D]; k [B, h, w, D] (NHWC feature map); img_valid [B, h, w].
    Returns the attention weights [B, Q, heads, h, w] in q's projected
    dtype: the logits and the softmax are float32 whatever the compute
    dtype, as the JAX package computes them (preferred_element_type)."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                img_valid: torch.Tensor) -> torch.Tensor:
        q = self.q_linear(q)
        k = self.k_linear(k)
        b, nq, d = q.shape
        _, h, w, _ = k.shape
        nh = self.num_heads
        dh = d // nh
        qh = q.reshape(b, nq, nh, dh) * (float(dh) ** -0.5)
        kh = k.reshape(b, h, w, nh, dh)
        with torch.autocast(q.device.type, enabled=False):
            # products of the compute-dtype values, summed in float32
            logits = torch.einsum("bqnc,bhwnc->bqnhw", qh.float(), kh.float())
            logits = logits + torch.where(img_valid.bool(), 0.0,
                                          NEG_INF)[:, None, None]
            # softmax jointly over heads x pixels
            weights = torch.softmax(logits.reshape(b, nq, -1), dim=-1)
        return weights.reshape(b, nq, nh, h, w).to(q.dtype)


class MaskHeadSmallConv(nn.Module):
    """x [B*Q, 2D + heads, h, w] (the projected and memory features tiled
    over queries, then the attention maps); fpns [C3, C2, C1], NCHW
    backbone stages at [B, ...] (tiled over queries here).

    Returns (logits [B*Q, 1, H1, W1] at C1's size, res_feat
    [B*Q, D/16, H1, W1])."""

    def __init__(self, in_dim: int, fpn_dims: Sequence[int],
                 context_dim: int):
        super().__init__()
        cd = context_dim
        dims = [in_dim, cd // 2, cd // 4, cd // 8, cd // 16]

        def conv(cin, cout, kernel=3):
            return nn.Conv2d(cin, cout, kernel, padding=(kernel - 1) // 2)

        def gn(c):
            return nn.GroupNorm(MASK_HEAD_GROUPS, c, eps=1e-5)

        self.lay1, self.gn1 = conv(dims[0], dims[0]), gn(dims[0])
        self.lay2, self.gn2 = conv(dims[0], dims[1]), gn(dims[1])
        self.adapter1 = conv(fpn_dims[0], dims[1], 1)
        self.lay3, self.gn3 = conv(dims[1], dims[2]), gn(dims[2])
        self.adapter2 = conv(fpn_dims[1], dims[2], 1)
        self.lay4, self.gn4 = conv(dims[2], dims[3]), gn(dims[3])
        self.adapter3 = conv(fpn_dims[2], dims[3], 1)
        self.lay5, self.gn5 = conv(dims[3], dims[4]), gn(dims[4])
        self.out_lay = conv(dims[4], 1)

    def forward(self, x: torch.Tensor, fpns: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.gn1(self.lay1(x)))
        x = F.relu(self.gn2(self.lay2(x)))
        for fpn, adapter, lay, norm in (
                (fpns[0], self.adapter1, self.lay3, self.gn3),
                (fpns[1], self.adapter2, self.lay4, self.gn4),
                (fpns[2], self.adapter3, self.lay5, self.gn5)):
            cur = adapter(fpn)
            if cur.shape[0] != x.shape[0]:  # tile over queries
                cur = cur.repeat_interleave(x.shape[0] // cur.shape[0], 0)
            x = cur + nearest_resize(x, tuple(cur.shape[-2:]))
            x = F.relu(norm(lay(x)))
        return self.out_lay(x), x


class CEM(nn.Module):
    """The energy loss between REC decoder features and RES mask features.
    rec [B, P, Q, D]; res [B, h, w, D/16] (NHWC). Returns a scalar."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        d = hidden_dim
        self.hidden_dim = d
        self.c1 = nn.Linear(d, 1)
        self.c2 = nn.Linear(d // 16, 1)
        self.c3 = nn.Linear(d, d // 16)

    def forward(self, rec_feat: torch.Tensor,
                res_feat: torch.Tensor) -> torch.Tensor:
        d = self.hidden_dim
        b = rec_feat.shape[0]
        rec = rec_feat.reshape(b, -1, d)  # [B, PQ, D]
        res = res_feat.reshape(b, -1, d // 16)  # [B, hw, D/16]
        es = torch.softmax(self.c1(rec).float(), dim=-2)
        ec = torch.softmax(self.c2(res).float(), dim=-2)
        rec_n = self.c3(rec)
        rec_n = rec_n / (torch.linalg.vector_norm(rec_n, dim=-1,
                                                  keepdim=True) + 1e-12)
        res_n = res / (torch.linalg.vector_norm(res, dim=-1, keepdim=True)
                       + 1e-12)
        with torch.autocast(rec.device.type, enabled=False):
            tsc = torch.einsum("bqc,bpc->bqp", rec_n.float(), res_n.float())
            tsc = ((tsc + 1.0) / 2.0).clamp(1e-6, 1.0 - 1e-6)
            energy = torch.einsum("bqo,bqp->bop", es, tsc)
            energy = torch.einsum("bop,bpz->boz", energy, ec)
            return -1.0 * torch.log(energy + 1e-6).sum() / b
