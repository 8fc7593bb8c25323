"""Small MLP heads (port of reftr_tpu/nn/mlp.py).

``MLP``: N linear layers with ReLU between (the DETR bbox head; the final
layer starts at zero, see ``convert.init_params``). ``MLPMapping``: Linear
-> LayerNorm -> ReLU -> Linear -> LayerNorm -> ReLU, mapping BERT features
to the VL width (LayerNorm eps 1e-6, Flax's default), with dropout after the
first ReLU (reftr_tpu/nn/mlp.py:57).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, final_zero_init: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.final_zero_init = final_zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MLPMapping(nn.Module):
    def __init__(self, input_dim: int, output_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, output_dim)
        self.ln1 = nn.LayerNorm(output_dim, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.fc2 = nn.Linear(output_dim, output_dim)
        self.ln2 = nn.LayerNorm(output_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(F.relu(self.ln1(self.fc1(x))))
        return F.relu(self.ln2(self.fc2(x)))
