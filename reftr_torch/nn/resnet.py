"""ResNet-50/101 image backbone with frozen BatchNorm or GroupNorm (port of
reftr_tpu/nn/resnet.py).

torchvision ResNet v1.5 topology (stride on the 3x3 conv of each
bottleneck), written by hand because torchvision is not a dependency.
FrozenBatchNorm adds eps before the rsqrt and computes its scale and shift
in f32 (:36-66). ``norm="group"`` (the from-scratch option, :68-82) puts a
live GroupNorm(32) with float32 statistics at every place FrozenBN sits,
under the same names. The public layout is NHWC, as in the JAX package;
inside, the convolutions run on the channels-last view of the same memory
with FrozenBN, and on one contiguous NCHW copy with GroupNorm.

Training freezes a prefix of the network (``freeze``): the stem and layer1
unless ``train_stem``, every stage with ``freeze_backbone`` or
``freeze_reftr``, as ``stop_grad_stages`` does in the JAX package
(reftr_tpu/models/reftr.py:94-104, nn/resnet.py:222, 326).
Their parameters get ``requires_grad=False`` and they run under
``torch.no_grad()``, so no graph is kept for them.

The JAX package's reparameterisations, each exact for weights rewritten
by ``nn/fold.py`` (reftr_tpu/nn/resnet.py:191-212, 256-323):
``fold_bn`` (FrozenBN as a bias add after a conv that holds its scale),
``space_to_depth`` (the stem as a 4x4/stride-1 conv on the input's 2x2
space-to-depth, channel order (s, t, c)), ``min_inner_width`` (every
bottleneck's inner width padded with zero channels) and ``block_layer1``
(layer1 on the 2x2 space-to-depth grid of its input, channel order
(py, px, c), and back). ``remat_blocks`` / ``remat_stages`` recompute a
bottleneck's activations in the backward (``torch.utils.checkpoint``)
instead of keeping them. Left out: int8.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

RESNET_LAYERS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, all buffers.

    Its buffers stay float32 when the model is cast to bf16
    (``RefTR.cast_to_compute_dtype``); scale and shift are applied in the
    activation dtype. ``folded``: the scale lives in the preceding conv's
    kernel (``nn/fold.py``) and only the shift is left, a float32 ``bias``
    buffer added in the activation dtype."""

    def __init__(self, features: int, eps: float = 1e-5,
                 folded: bool = False):
        super().__init__()
        self.eps = eps
        self.folded = folded
        if not folded:
            self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        if not folded:
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W]."""
        if self.folded:
            return x + self.bias.to(x.dtype)[:, None, None]
        scale = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class BackboneGroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) with float32 statistics and affine (float64
    on float64 input), giving the input's dtype, as flax's ``GroupNorm(dtype=compute dtype)`` does
    (under autocast torch's group_norm would give float32). Its parameters
    stay float32 when the model is cast to bf16, as FrozenBatchNorm's
    buffers do."""

    def __init__(self, features: int):
        super().__init__(32, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W]. torch's CUDA group_norm takes contiguous NCHW
        (it copies a channels-last input), so one copy converts the dtype,
        and the layout of a channels-last input, on the way in and one on
        the way out, back to the layout of the convolutions around it."""
        channels_last = (x.is_contiguous(memory_format=torch.channels_last)
                         and not x.is_contiguous())
        dt = torch.promote_types(x.dtype, torch.float32)
        y = F.group_norm(
            x.to(dt, memory_format=torch.contiguous_format), self.num_groups,
            self.weight.to(dt), self.bias.to(dt), self.eps)
        return y.to(x.dtype, memory_format=torch.channels_last
                    if channels_last else torch.contiguous_format)


NORMS = {"frozen": FrozenBatchNorm, "group": BackboneGroupNorm}


def _norm(norm: str, features: int, folded: bool) -> nn.Module:
    if norm == "frozen":
        return FrozenBatchNorm(features, folded=folded)
    if folded:
        raise ValueError("fold_bn requires frozen BN statistics "
                         "(norm='frozen')")
    return NORMS[norm](features)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel order (row in the 2x2
    cell, column in it, c): JAX's reshape and transpose, on NHWC."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """``space_to_depth``'s inverse, [B, H, W, 4C] -> [B, 2H, 2W, C]."""
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c4 // 4)


def _nchw(x: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """The NCHW view of NHWC ``x``, made contiguous NCHW unless
    ``channels_last``."""
    x = x.permute(0, 3, 1, 2)
    return x if channels_last else x.contiguous()


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4, stride on conv2)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 norm: str = "frozen", fold_bn: bool = False,
                 pad_width: int = 0):
        super().__init__()
        out_ch = width * 4
        # pad_width > width: zero inner channels (nn/fold.py pads weights)
        inner = max(width, pad_width)
        self.conv1 = _conv(cin, inner, 1)
        self.bn1 = _norm(norm, inner, fold_bn)
        self.conv2 = _conv(inner, inner, 3, stride, dilation)
        self.bn2 = _norm(norm, inner, fold_bn)
        self.conv3 = _conv(inner, out_ch, 1)
        self.bn3 = _norm(norm, out_ch, fold_bn)
        if downsample:
            self.downsample_conv = _conv(cin, out_ch, 1, stride)
            self.downsample_bn = _norm(norm, out_ch, fold_bn)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + identity)


class ResNet(nn.Module):
    """Input NHWC float images (already normalised; uint8 canvases cast to
    the compute dtype under ``fold_normalize``). Returns the NHWC layer4
    feature map, the one feature level REC uses, or with
    ``return_interm_layers`` the four stage outputs C1-C4 (strides 4-32),
    as RES's mask head needs them. ``norm``: "frozen" or "group".

    ``channels_last``: the convolutions run on the channels-last view of
    the input's memory, as with FrozenBN; with GroupNorm the input is
    copied to contiguous NCHW once and the network runs in NCHW
    throughout, returning an NHWC view of NCHW memory. Its norms cast to
    float32 and back in either layout (the casts cost the same as the
    copies that also change the layout), and in NCHW the rest of the
    step moves less (phase 10a of chip_smoke.py times both).

    The reparameterisations (module docstring) keep the names of the
    standard network but ``conv1_s2d``, the space-to-depth stem's conv,
    which takes ``conv1``'s place."""

    def __init__(self, name: str = "resnet50", dilation: bool = False,
                 return_interm_layers: bool = False, norm: str = "frozen",
                 space_to_depth: bool = False, fold_bn: bool = False,
                 min_inner_width: int = 0, block_layer1: bool = False,
                 remat_blocks: bool = False,
                 remat_stages: Sequence[int] = ()):
        super().__init__()
        if block_layer1 and min_inner_width:
            raise ValueError("backbone_pad_width and block_layer1 are "
                             "exclusive")
        self.return_interm_layers = return_interm_layers
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.conv1_s2d = nn.Conv2d(12, 64, 4, bias=False)
        else:
            self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = _norm(norm, 64, fold_bn)
        self.block_layer1 = block_layer1
        cin = 64
        for stage, (width, n_blocks) in enumerate(
                zip((64, 128, 256, 512), RESNET_LAYERS[name]), start=1):
            stride = 1 if stage == 1 else 2
            dil = 1
            if stage == 4 and dilation:
                stride, dil = 1, 2
            # block_layer1: layer1 on the 2x2 space-to-depth grid, four
            # times the channels at stride 1
            grid = 4 if block_layer1 and stage == 1 else 1
            blocks = []
            c = cin * grid
            for b in range(n_blocks):
                # torchvision's replace_stride_with_dilation: block 0 keeps
                # dilation 1, later blocks use the new one
                blocks.append(Bottleneck(c, width * grid,
                                         stride if b == 0 else 1,
                                         1 if b == 0 else dil,
                                         downsample=(b == 0), norm=norm,
                                         fold_bn=fold_bn,
                                         pad_width=min_inner_width))
                c = width * grid * 4
            cin = width * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.remat_stages = frozenset(
            s for s in range(1, 5) if remat_blocks or s in remat_stages)
        self.frozen_stages = 0
        self.channels_last = norm != "group"

    def stem_conv(self) -> nn.Conv2d:
        return self.conv1_s2d if self.space_to_depth else self.conv1

    def freeze(self, stages: int) -> None:
        """Freeze the stem and layers 1..``stages`` (none at 0): no
        gradient, no graph."""
        self.frozen_stages = stages
        frozen = [self.stem_conv(), self.bn1] if stages else []
        frozen += [getattr(self, f"layer{s}") for s in range(1, stages + 1)]
        for mod in frozen:
            mod.requires_grad_(False)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The stem on NHWC ``x``: conv, norm, relu and max pool, NCHW out.
        The space-to-depth stem pads by 4, runs its 4x4 VALID conv and
        drops the extra last output row and column."""
        if self.space_to_depth:
            _, h, w, _ = x.shape
            if h % 2 or w % 2:
                raise ValueError(f"the space-to-depth stem needs an even "
                                 f"height and width, not {h} x {w}")
            y = space_to_depth(F.pad(x, (0, 0, 4, 4, 4, 4)))
            y = self.conv1_s2d(_nchw(y, self.channels_last))
            y = y[:, :, :(h + 1) // 2, :(w + 1) // 2]
        else:
            y = self.conv1(_nchw(x, self.channels_last))
        y = F.relu(self.bn1(y))
        return F.max_pool2d(y, 3, stride=2, padding=1)

    def run_stage(self, stage: int, x: torch.Tensor) -> torch.Tensor:
        """Layer ``stage`` (1-4) on NCHW ``x``; its bottlenecks recomputed
        in the backward where the stage is in ``remat_stages`` and a graph
        is kept."""
        blocks = getattr(self, f"layer{stage}")
        grid = self.block_layer1 and stage == 1
        if grid:
            hh, ww = x.shape[2:]
            if hh % 2 or ww % 2:
                raise ValueError(f"block_layer1 needs an even post-stem "
                                 f"height and width, not {hh} x {ww}")
            x = _nchw(space_to_depth(x.permute(0, 2, 3, 1)),
                      self.channels_last)
        if stage in self.remat_stages and torch.is_grad_enabled():
            for block in blocks:
                x = checkpoint(block, x, use_reentrant=False)
        else:
            x = blocks(x)
        if grid:
            x = _nchw(depth_to_space(x.permute(0, 2, 3, 1)),
                      self.channels_last)
        return x

    def forward(self, x: torch.Tensor):
        n = self.frozen_stages
        feats = []
        with torch.no_grad() if n else nullcontext():
            x = self.stem(x)
            for stage in range(1, n + 1):
                x = self.run_stage(stage, x)
                feats.append(x)
        for stage in range(n + 1, 5):
            x = self.run_stage(stage, x)
            feats.append(x)
        if self.return_interm_layers:
            return tuple(f.permute(0, 2, 3, 1) for f in feats)
        return x.permute(0, 2, 3, 1)


def downsample_mask(valid_mask: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-subsample a [B, H, W] bool mask to out_hw, with torch
    F.interpolate(mode='nearest') index selection: src = floor(dst * in/out).
    """
    _, h, w = valid_mask.shape
    oh, ow = out_hw
    dev = valid_mask.device
    ys = torch.floor(torch.arange(oh, dtype=torch.float32, device=dev)
                     * (h / oh)).long()
    xs = torch.floor(torch.arange(ow, dtype=torch.float32, device=dev)
                     * (w / ow)).long()
    return valid_mask[:, ys][:, :, xs]
