"""Point -> grid pooling for the encoder (shapeformer_tpu/ops/scatter.py).

The points are sorted by cell id once per encode (`pool_plan`); the encoder
then keeps its per-point stack in sorted order.  Per-point segment pooling
is ops/segment_pool.py (the CUDA kernel on the card); the dense per-cell
mean grid and the occupancy grid are index_add_/scatter_ builds.  Cells
holding no point are 0 (torch_scatter's convention, as in the reference).
"""
from __future__ import annotations

from typing import Dict

import torch


def pool_plan(ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sort each batch row's (B, N) cell ids once.

    Returns perm (B, N), ids_sorted (B, N), seg_start (B, N) bool and
    offsets (S + 1,) int32: the first row of each of the S segments of the
    flattened B * N sorted rows, then B * N.  Every batch row starts a
    segment, so no segment crosses one.  Finding the segments syncs with
    the host once per plan."""
    B, N = ids.shape
    perm = torch.argsort(ids, dim=1, stable=True)
    ids_sorted = torch.gather(ids, 1, perm)
    seg_start = torch.ones_like(ids_sorted, dtype=torch.bool)
    seg_start[:, 1:] = ids_sorted[:, 1:] != ids_sorted[:, :-1]
    starts = torch.nonzero(seg_start.reshape(-1)).reshape(-1)
    offsets = torch.cat([starts, starts.new_tensor([B * N])]).to(torch.int32)
    return dict(perm=perm, ids_sorted=ids_sorted, seg_start=seg_start,
                offsets=offsets)


def scatter_mean_sorted_c(cs: torch.Tensor, plan: Dict[str, torch.Tensor],
                          n_cells: int) -> torch.Tensor:
    """Dense per-cell mean grid (B, n_cells, C) from sorted-order features;
    f32 accumulation, empty cells 0."""
    B, N, C = cs.shape
    flat = (plan["ids_sorted"]
            + torch.arange(B, device=cs.device)[:, None] * n_cells).reshape(-1)
    sums = torch.zeros((B * n_cells, C), device=cs.device)
    sums.index_add_(0, flat, cs.reshape(B * N, C).float())
    counts = torch.zeros((B * n_cells,), device=cs.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    mean = sums / counts.clamp(min=1.0)[:, None]
    return mean.reshape(B, n_cells, C).to(cs.dtype)


def occupancy_from_plan(plan: Dict[str, torch.Tensor], n_cells: int
                        ) -> torch.Tensor:
    """(B, n_cells) bool: True where a cell holds at least one point."""
    ids = plan["ids_sorted"]
    occ = torch.zeros((ids.shape[0], n_cells), dtype=torch.bool,
                      device=ids.device)
    return occ.scatter_(1, ids, True)
