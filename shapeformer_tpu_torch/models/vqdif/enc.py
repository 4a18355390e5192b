"""LocalPoolPointnet encoder, dense-grid path
(shapeformer_tpu/models/vqdif/enc.py).

Points are sorted by their cell id once (ops.scatter.pool_plan) and the
per-point ResNet-FC stack runs in that order.  Between blocks every point
gets the max (or mean) of the features of the points in its cell: on the
card that is the hand-written CUDA segment_pool kernel, n_blocks - 1 = 4
launches per encode.  The per-cell mean grid then feeds the Downsampler.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops import scatter
from ...ops.gridcoords import coordinate2index, normalize_3d_coordinate
from ...ops.segment_pool import SegmentPool
from ..layers import ResnetBlockFC
from .updown import Downsampler


class LocalPoolPointnet(nn.Module):
    def __init__(self, c_dim: int = 128, dim: int = 3, hidden_dim: int = 128,
                 scatter_type: str = "max", downsampler: bool = False,
                 downsampler_kwargs: Optional[dict] = None,
                 grid_resolution: Optional[int] = None,
                 plane_type: str = "grid", padding: float = 0.1,
                 n_blocks: int = 5, sparse_tokenize: bool = False,
                 c2i_order: str = "original", sparse_densify_at: int = 32):
        super().__init__()
        if plane_type != "grid":
            raise ValueError("only 3D grid features are supported")
        if sparse_tokenize:
            raise NotImplementedError("the sparse-direct tokenize path is "
                                      "not ported; use the dense path")
        if scatter_type not in ("max", "mean"):
            raise ValueError(f"unknown scatter_type {scatter_type!r}")
        self.c_dim, self.hidden_dim = c_dim, hidden_dim
        self.scatter_type = scatter_type
        self.reso = grid_resolution
        self.padding = padding
        self.n_blocks = n_blocks
        self.fc_pos = nn.Linear(dim, 2 * hidden_dim)
        for i in range(n_blocks):
            setattr(self, f"block{i}", ResnetBlockFC(2 * hidden_dim,
                                                     hidden_dim))
        self.fc_c = nn.Linear(hidden_dim, c_dim)
        self.downsampler = (Downsampler(**downsampler_kwargs)
                            if downsampler else None)
        self.segment_pool = SegmentPool()

    def forward(self, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) points in [-0.5, 0.5] -> (grid_feat (B, r, r, r, C),
        grid_mask (B, r, r, r) bool occupancy at the output resolution)."""
        reso = self.reso
        n_cells = reso ** 3
        p_nor = normalize_3d_coordinate(p, padding=self.padding)
        ids = coordinate2index(p_nor, reso)
        plan = scatter.pool_plan(ids)
        ps = torch.gather(p, 1, plan["perm"][..., None].expand(-1, -1, 3))
        net = self.block0(self.fc_pos(ps))
        for i in range(1, self.n_blocks):
            pooled = self.segment_pool(net, plan["offsets"], self.scatter_type)
            net = getattr(self, f"block{i}")(torch.cat([net, pooled], dim=-1))
        c = self.fc_c(net)

        fine_mask = scatter.occupancy_from_plan(plan, n_cells)
        fea_grid = scatter.scatter_mean_sorted_c(c, plan, n_cells)
        fea_grid = fea_grid.reshape(-1, reso, reso, reso, self.c_dim)
        if self.downsampler is not None:
            fea_grid = self.downsampler(fea_grid)
        out_reso = fea_grid.shape[1]
        if reso % out_reso:
            raise ValueError("the downsampler must divide the grid resolution")
        f = reso // out_reso
        # floor(p * out) == floor(p * reso) // f per axis, so the coarse
        # occupancy is a max-pool of the fine one
        mask = fine_mask.reshape(-1, out_reso, f, out_reso, f, out_reso, f)
        return fea_grid, mask.any(dim=6).any(dim=4).any(dim=2)
