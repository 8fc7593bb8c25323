"""ResNet-50/101 image backbone with frozen BatchNorm or GroupNorm (port of
reftr_tpu/nn/resnet.py but its TPU reparameterisations).

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

Left out: the space-to-depth stem, ``block_layer1``, ``min_inner_width``,
remat and int8 (TPU reparameterisations).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

RESNET_LAYERS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, all buffers.

    Its buffers stay float32 when the model is cast to bf16
    (``RefTR.cast_to_compute_dtype``); scale and shift are applied in the
    activation dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W]."""
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


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4, stride on conv2)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 norm: str = "frozen"):
        super().__init__()
        out_ch = width * 4
        norm_cls = NORMS[norm]
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = norm_cls(width)
        self.conv2 = _conv(width, width, 3, stride, dilation)
        self.bn2 = norm_cls(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = norm_cls(out_ch)
        if downsample:
            self.downsample_conv = _conv(cin, out_ch, 1, stride)
            self.downsample_bn = norm_cls(out_ch)
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
    """Input NHWC float images (already normalised). Returns the NHWC
    layer4 feature map, the one feature level REC uses, or with
    ``return_interm_layers`` the four stage outputs C1-C4 (strides 4-32),
    as RES's mask head needs them. ``norm``: "frozen" or "group".

    ``channels_last``: the convolutions run on the channels-last view of
    the input's memory, as with FrozenBN; with GroupNorm the input is
    copied to contiguous NCHW once and the network runs in NCHW
    throughout, returning an NHWC view of NCHW memory. Its norms cast to
    float32 and back in either layout (the casts cost the same as the
    copies that also change the layout), and in NCHW the rest of the
    step moves less (phase 10a of chip_smoke.py times both)."""

    def __init__(self, name: str = "resnet50", dilation: bool = False,
                 return_interm_layers: bool = False, norm: str = "frozen"):
        super().__init__()
        self.return_interm_layers = return_interm_layers
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = NORMS[norm](64)
        cin = 64
        for stage, (width, n_blocks) in enumerate(
                zip((64, 128, 256, 512), RESNET_LAYERS[name]), start=1):
            stride = 1 if stage == 1 else 2
            dil = 1
            if stage == 4 and dilation:
                stride, dil = 1, 2
            blocks = []
            for b in range(n_blocks):
                # torchvision's replace_stride_with_dilation: block 0 keeps
                # dilation 1, later blocks use the new one
                blocks.append(Bottleneck(cin, width,
                                         stride if b == 0 else 1,
                                         1 if b == 0 else dil,
                                         downsample=(b == 0), norm=norm))
                cin = width * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.frozen_stages = 0
        self.channels_last = norm != "group"

    def freeze(self, stages: int) -> None:
        """Freeze the stem and layers 1..``stages`` (none at 0): no
        gradient, no graph."""
        self.frozen_stages = stages
        frozen = [self.conv1, self.bn1] if stages else []
        frozen += [getattr(self, f"layer{s}") for s in range(1, stages + 1)]
        for mod in frozen:
            mod.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        if not self.channels_last:
            x = x.contiguous()
        stages = (self.layer1, self.layer2, self.layer3, self.layer4)
        n = self.frozen_stages
        feats = []
        with torch.no_grad() if n else nullcontext():
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for stage in stages[:n]:
                x = stage(x)
                feats.append(x)
        for stage in stages[n:]:
            x = stage(x)
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
