"""LocalDecoder: implicit occupancy decoder on local grid features
(shapeformer_tpu/models/vqdif/dec.py).

process_grid runs the UNet and the Upsampler once per shape; query samples
the processed grid trilinearly at arbitrary points; query_grid does the same
for a regular lattice with separable interpolation matrices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.gridcoords import normalize_3d_coordinate
from ..layers import ResnetBlockFC
from .unet3d import UNet3D
from .updown import Upsampler, to_cf, to_cl


def trilinear_sample(grid: torch.Tensor, p_nor: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) grid at (B, M, 3) coordinates in [0, 1] -> (B, M, C).

    align_corners=True with border padding, as ops/grid_sample.py.  Axis d
    of p_nor indexes grid axis 1 + d; grid_sample reads its last coordinate
    as the first spatial axis, hence the flip."""
    B, M, _ = p_nor.shape
    g = (p_nor * 2.0 - 1.0).flip(-1).reshape(B, 1, 1, M, 3)
    out = F.grid_sample(to_cf(grid), g.to(grid.dtype), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.reshape(B, grid.shape[-1], M).transpose(1, 2)


class LocalDecoder(nn.Module):
    def __init__(self, dim: int = 3, c_dim: int = 128, unet3d: bool = False,
                 unet3d_kwargs: Optional[dict] = None,
                 upsampler: bool = False,
                 upsampler_kwargs: Optional[dict] = None,
                 hidden_size: int = 256, n_blocks: int = 5,
                 leaky: bool = False, sample_mode: str = "bilinear",
                 padding: float = 0.1):
        super().__init__()
        if sample_mode != "bilinear":
            raise ValueError(f"unsupported sample_mode {sample_mode!r}")
        self.c_dim, self.n_blocks, self.leaky = c_dim, n_blocks, leaky
        self.padding = padding
        self.unet = UNet3D(**unet3d_kwargs) if unet3d else None
        self.upsampler_mod = (Upsampler(**upsampler_kwargs) if upsampler
                              else None)
        self.fc_p = nn.Linear(dim, hidden_size)
        for i in range(n_blocks):
            if c_dim != 0:
                setattr(self, f"fc_c_{i}", nn.Linear(c_dim, hidden_size))
            setattr(self, f"blocks_{i}", ResnetBlockFC(hidden_size))
        self.fc_out = nn.Linear(hidden_size, 1)

    def process_grid(self, c_grid: torch.Tensor) -> torch.Tensor:
        """UNet + upsample: (B, r, r, r, C) -> (B, R, R, R, C')."""
        x = to_cf(c_grid)
        if self.unet is not None:
            x = self.unet.forward_cf(x)
        if self.upsampler_mod is not None:
            x = self.upsampler_mod.forward_cf(x)
        return to_cl(x)

    def _mlp(self, net: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            if self.c_dim != 0:
                net = net + getattr(self, f"fc_c_{i}")(c)
            net = getattr(self, f"blocks_{i}")(net)
        act = F.leaky_relu(net, 0.2) if self.leaky else F.relu(net)
        return self.fc_out(act)

    def query(self, p: torch.Tensor, c_grid_processed: torch.Tensor
              ) -> torch.Tensor:
        """(B, M, 3) queries in [-0.5, 0.5] -> (B, M, 1) logits."""
        p_nor = normalize_3d_coordinate(p, padding=self.padding)
        c = trilinear_sample(c_grid_processed, p_nor)
        return self._mlp(self.fc_p(p), c)

    def query_grid(self, c_grid_processed: torch.Tensor,
                   axes: Sequence[torch.Tensor]) -> torch.Tensor:
        """query() on the cartesian product of three 1D axes in
        [-0.5, 0.5], (x, y, z) scan order -> (B, Rx * Ry * Rz, 1).
        Trilinear sampling on a lattice is separable: three interpolation
        matmuls; fc_p over the lattice is a sum of per-axis rank-1 terms."""
        g = c_grid_processed
        mats = []
        for d, ax in enumerate(axes):
            r_in = g.shape[1 + d]
            f = normalize_3d_coordinate(ax, padding=self.padding) * (r_in - 1)
            raw = torch.floor(f).long()
            w = (f - raw).to(g.dtype)
            i0 = raw.clamp(0, r_in - 1)
            i1 = (raw + 1).clamp(0, r_in - 1)
            eye = torch.eye(r_in, dtype=g.dtype, device=g.device)
            mats.append(eye[i0] * (1 - w)[:, None] + eye[i1] * w[:, None])
        wx, wy, wz = mats
        g = torch.einsum("rx,bxyzc->bryzc", wx, g)
        g = torch.einsum("sy,bryzc->brszc", wy, g)
        c = torch.einsum("tz,brszc->brstc", wz, g)
        B = c.shape[0]
        rx, ry, rz = (a.shape[0] for a in axes)
        c = c.reshape(B, rx * ry * rz, c.shape[-1])
        kern = self.fc_p.weight.T                          # (3, H)
        px = axes[0][:, None] * kern[0]
        py = axes[1][:, None] * kern[1]
        pz = axes[2][:, None] * kern[2]
        net = (px[:, None, None, :] + py[None, :, None, :]
               + pz[None, None, :, :] + self.fc_p.bias)
        net = net.reshape(1, rx * ry * rz, -1).expand(B, -1, -1)
        return self._mlp(net, c)

    def forward(self, p: torch.Tensor, c_grid: torch.Tensor) -> torch.Tensor:
        return self.query(p, self.process_grid(c_grid))
