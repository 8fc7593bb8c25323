"""The device an entry point of the port runs on."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``device`` as a torch.device, a bare "cuda" as the current card.
    Asking for CUDA where there is none raises; nothing falls back to the
    CPU unless the caller asks."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
