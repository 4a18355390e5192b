"""Vector quantizer, inference path
(shapeformer_tpu/models/vqdif/quantizer.py).

Nearest code by expanded L2 distance in f32; the codebook is a buffer (the
JAX package keeps it in the 'vq' collection, not in 'params').  The EMA
codebook update belongs to training and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class Quantizer(nn.Module):
    def __init__(self, vocab_size: int, n_embd: int, gamma: float = 0.99,
                 x_dim: int = 3):
        super().__init__()
        self.vocab_size, self.n_embd = vocab_size, n_embd
        self.register_buffer("codebook", torch.zeros(vocab_size, n_embd))

    def distances(self, flat: torch.Tensor) -> torch.Tensor:
        """(M, C) features -> (M, V) squared distances to every code."""
        w = self.codebook.float()
        flat = flat.float()
        return ((flat ** 2).sum(-1, keepdim=True) - 2.0 * flat @ w.T
                + (w ** 2).sum(-1)[None, :])

    def get_code(self, ind: torch.Tensor) -> torch.Tensor:
        """(B, r, r, r) indices -> (B, r, r, r, C) code features."""
        return self.codebook[ind]

    def forward(self, grid_feat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, r, r, r, C) -> (quant_feat, indices (B, r, r, r))."""
        ind = torch.argmin(self.distances(grid_feat.reshape(-1, self.n_embd)),
                           dim=-1)
        indices = ind.reshape(grid_feat.shape[:-1])
        return self.get_code(indices).to(grid_feat.dtype), indices
