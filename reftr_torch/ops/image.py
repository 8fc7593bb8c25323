"""Device-side image normalisation (port of reftr_tpu/ops/image.py:16).

Servers ship uint8 canvases to the device; the /255 and ImageNet mean/std
normalisation runs there. The constants are copied from
reftr_tpu/data/transforms.py, which the port does not import.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] uint8 in [0, 255] -> normalised float NHWC."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=images.device)
    x = images.to(dtype) / 255.0
    return (x - mean) / std
