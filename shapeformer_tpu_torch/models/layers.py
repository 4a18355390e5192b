"""Shared fully-connected blocks (shapeformer_tpu/models/layers.py)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


class ResnetBlockFC(nn.Module):
    """Pre-activation residual FC block: x_s + fc_1(relu(fc_0(relu(x)))),
    with a bias-free linear shortcut when the widths differ."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = (nn.Linear(size_in, size_out, bias=False)
                         if size_in != size_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx
