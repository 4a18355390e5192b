"""Coordinate <-> grid-cell transforms (shapeformer_tpu/ops/gridcoords.py).

Grids are channels-last (B, X, Y, Z, C); flat cell ids are C-order over
(ix, iy, iz): flat = (ix * r + iy) * r + iz.
"""
from __future__ import annotations

import torch


def normalize_3d_coordinate(p: torch.Tensor, padding: float = 0.1
                            ) -> torch.Tensor:
    """Points in roughly [-0.5 - pad/2, 0.5 + pad/2] -> [0, 1 - 1e-3]."""
    p_nor = p / (1.0 + padding + 10e-4) + 0.5
    return p_nor.clamp(0.0, 1.0 - 10e-4)


def coordinate2index(p_nor: torch.Tensor, reso: int) -> torch.Tensor:
    """Normalized points (..., 3) -> flat cell ids (...,) int64."""
    cell = torch.floor(p_nor * reso).long().clamp(0, reso - 1)
    return (cell[..., 0] * reso + cell[..., 1]) * reso + cell[..., 2]
