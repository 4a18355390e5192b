"""Host-side numpy helpers (own copy of shapeformer_tpu/utils/nputil.py
parts the port needs)."""
from __future__ import annotations

import numpy as np


def makeGrid(bb_min=(0, 0, 0), bb_max=(1, 1, 1), shape=(10, 10, 10),
             mode="on", flatten=True, indexing="ij"):
    """Dense grid of coordinates over a bounding box.

    mode='on'  -> vertices on the boundary (align_corners=True)
    mode='in'  -> cell centers strictly inside (align_corners=False)
    Returns (prod(shape), D) if flatten else (*shape, D).
    """
    bb_min, bb_max = np.asarray(bb_min, np.float64), np.asarray(bb_max, np.float64)
    if isinstance(shape, int):
        shape = [shape] * bb_min.shape[0]
    coords = []
    for i, si in enumerate(shape):
        if mode == "on":
            coords.append(np.linspace(bb_min[i], bb_max[i], si))
        elif mode == "in":
            off = (bb_max[i] - bb_min[i]) / 2.0 / si
            coords.append(np.linspace(bb_min[i] + off, bb_max[i] - off, si))
        else:
            raise ValueError(f"unknown grid mode {mode!r}")
    grid = np.stack(np.meshgrid(*coords, sparse=False, indexing=indexing), axis=-1)
    if flatten:
        grid = grid.reshape(-1, grid.shape[-1])
    return grid
