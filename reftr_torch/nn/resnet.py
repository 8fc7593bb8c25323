"""ResNet-50/101 image backbone with frozen BatchNorm (port of the default
path of reftr_tpu/nn/resnet.py).

torchvision ResNet v1.5 topology (stride on the 3x3 conv of each
bottleneck), written by hand because torchvision is not a dependency.
FrozenBatchNorm adds eps before the rsqrt and computes its scale and shift
in f32 (:36-66). The public layout is NHWC, as in the JAX package; inside,
the convolutions run on the channels-last view of the same memory.

Left out: the space-to-depth stem, ``block_layer1``, ``min_inner_width``,
remat, GroupNorm and int8 (TPU reparameterisations, training and
from-scratch options).
"""

from __future__ import annotations

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


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (expansion 4, stride on conv2)."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out_ch = width * 4
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = FrozenBatchNorm(out_ch)
        if downsample:
            self.downsample_conv = _conv(cin, out_ch, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out_ch)
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
    layer4 feature map, the one feature level the port serves."""

    def __init__(self, name: str = "resnet50", dilation: bool = False):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
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
                                         downsample=(b == 0)))
                cin = width * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
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
