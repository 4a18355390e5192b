"""3D U-Net over the quantized feature grid
(shapeformer_tpu/models/vqdif/unet3d.py): DoubleConv blocks in 'gcr' order,
max-pool encoders, nearest-upsample + concat decoders, final 1x1 conv.
`forward` takes channels-last grids; `forward_cf` channels-first ones.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from .updown import GN, to_cf, to_cl, upsample_nearest2x_cf


class SingleConv(nn.Module):
    """Layers from an order string over {c, r, g}; submodules are named by
    kind and position (norm0, conv1 for 'gcr'), as in the JAX package."""

    def __init__(self, in_channels: int, features: int, order: str = "gcr",
                 num_groups: int = 8, kernel: int = 3):
        super().__init__()
        self.order = order
        has_norm = "g" in order
        n_ch = in_channels
        for i, ch in enumerate(order):
            if ch == "c":
                setattr(self, f"conv{i}", nn.Conv3d(
                    n_ch, features, kernel, padding=kernel // 2,
                    bias=not has_norm))
                n_ch = features
            elif ch == "g":
                groups = num_groups if n_ch >= num_groups else 1
                setattr(self, f"norm{i}", GN(n_ch, groups))
            elif ch != "r":
                raise ValueError(f"unsupported layer char {ch!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, ch in enumerate(self.order):
            if ch == "c":
                x = getattr(self, f"conv{i}")(x)
            elif ch == "g":
                x = getattr(self, f"norm{i}")(x)
            else:
                x = F.relu(x)
        return x


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 order: str = "gcr", num_groups: int = 8):
        super().__init__()
        conv1_out = (max(out_channels // 2, in_channels) if encoder
                     else out_channels)
        self.SingleConv1 = SingleConv(in_channels, conv1_out, order,
                                      num_groups)
        self.SingleConv2 = SingleConv(conv1_out, out_channels, order,
                                      num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


class UNet3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 f_maps: Union[int, Sequence[int]] = 64,
                 layer_order: str = "gcr", num_groups: int = 8,
                 num_levels: int = 4, final_sigmoid: bool = True,
                 is_segmentation: bool = False):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = [f_maps * 2 ** k for k in range(num_levels)]
        self.num_levels = len(f_maps)
        c = in_channels
        for i, out_f in enumerate(f_maps):
            enc = DoubleConv(c, out_f, True, layer_order, num_groups)
            setattr(self, f"encoder{i}", enc)
            c = out_f
        skips = list(f_maps[:-1])
        for i, skip in enumerate(reversed(skips)):
            setattr(self, f"decoder{i}", DoubleConv(
                skip + c, skip, False, layer_order, num_groups))
            c = skip
        self.final_conv = nn.Conv3d(c, out_channels, 1)

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i in range(self.num_levels):
            if i > 0:
                x = F.max_pool3d(x, 2, 2)
            x = getattr(self, f"encoder{i}")(x)
            skips.append(x)
        for i, skip in enumerate(reversed(skips[:-1])):
            x = torch.cat([skip, upsample_nearest2x_cf(x)], dim=1)
            x = getattr(self, f"decoder{i}")(x)
        return self.final_conv(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_cl(self.forward_cf(to_cf(x)))
