"""Strided-conv Downsampler and nearest-upsample Upsampler
(shapeformer_tpu/models/vqdif/updown.py).

Public forwards take and return channels-last (B, X, Y, Z, C) grids; the
convolutions run channels-first on permute(0, 4, 1, 2, 3), through the
`*_cf` methods that callers chaining several modules use directly.
ConvLayer order 'crg': Conv3d (no bias) -> ReLU -> GroupNorm.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def to_cf(x: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B, C, X, Y, Z)."""
    return x.permute(0, 4, 1, 2, 3)


def to_cl(x: torch.Tensor) -> torch.Tensor:
    """(B, C, X, Y, Z) -> (B, X, Y, Z, C)."""
    return x.permute(0, 2, 3, 4, 1)


class GN(nn.Module):
    """GroupNorm over channels with the JAX package's statistics: f32
    fast variance E[x^2] - E[x]^2 clamped at 0 (not torch's two-pass
    variance), eps 1e-5.  Works on channels-first (B, C, ...) tensors."""

    def __init__(self, features: int, num_groups: int = 8,
                 epsilon: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.num_groups
        xg = x.float().reshape(B, G, -1)
        mu = xg.mean(-1, keepdim=True)
        var = ((xg * xg).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        y = ((xg - mu) * torch.rsqrt(var + self.epsilon)).reshape(x.shape)
        shape = (1, C) + (1,) * (x.dim() - 2)
        return (y * self.weight.reshape(shape)
                + self.bias.reshape(shape)).to(x.dtype)


class Conv3dNB(nn.Module):
    """Bias-free 3D conv; weight (Cout, Cin, kx, ky, kz), channels-first."""

    def __init__(self, features: int, in_features: int, ksize: int = 3,
                 stride: int = 1, pad: int = 1):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(
            torch.empty(features, in_features, ksize, ksize, ksize))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, stride=self.stride, padding=self.pad)


class ConvCRG(nn.Module):
    """Conv3d (no bias) -> ReLU -> GroupNorm, channels-first."""

    def __init__(self, features: int, in_features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1, num_groups: int = 8):
        super().__init__()
        groups = num_groups if features >= num_groups else 1
        self.conv = Conv3dNB(features, in_features, kernel, stride, padding)
        self.norm = GN(features, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class Downsampler(nn.Module):
    """Per step: k2 s2 conv doubling channels, then a 1x1x1 mix conv."""

    def __init__(self, in_channels: int, downsample_steps: int = 1):
        super().__init__()
        self.downsample_steps = downsample_steps
        c = in_channels
        for i in range(downsample_steps):
            setattr(self, f"down{i}_conv",
                    ConvCRG(2 * c, c, kernel=2, stride=2, padding=0))
            setattr(self, f"down{i}_mix",
                    ConvCRG(2 * c, 2 * c, kernel=1, stride=1, padding=0))
            c *= 2

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.downsample_steps):
            x = getattr(self, f"down{i}_conv")(x)
            x = getattr(self, f"down{i}_mix")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_cl(self.forward_cf(to_cf(x)))


def upsample_nearest2x_cf(x: torch.Tensor) -> torch.Tensor:
    """(B, C, X, Y, Z) -> (B, C, 2X, 2Y, 2Z) nearest neighbour."""
    for dim in (2, 3, 4):
        x = torch.repeat_interleave(x, 2, dim=dim)
    return x


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B, 2X, 2Y, 2Z, C) nearest neighbour."""
    return to_cl(upsample_nearest2x_cf(to_cf(x)))


class Upsampler(nn.Module):
    """Per step: x2 nearest upsample, then two k3 convs halving channels."""

    def __init__(self, in_channels: int, upsampler_steps: int = 1):
        super().__init__()
        self.upsampler_steps = upsampler_steps
        c = in_channels
        for i in range(upsampler_steps):
            out = int(c / 2)
            setattr(self, f"up{i}_conv0", ConvCRG(out, c))
            setattr(self, f"up{i}_conv1", ConvCRG(out, out))
            c = out

    def forward_cf(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.upsampler_steps):
            x = upsample_nearest2x_cf(x)
            x = getattr(self, f"up{i}_conv0")(x)
            x = getattr(self, f"up{i}_conv1")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_cl(self.forward_cf(to_cf(x)))
