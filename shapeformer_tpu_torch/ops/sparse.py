"""Sparse VQ-token codec (shapeformer_tpu/ops/sparse.py).

Dense (B, r, r, r) index grids <-> (B, max_length, 2) (position, value)
sequences padded with end tokens.  Positions follow the JAX codec's raster:
the canonical grid is transposed (0, 3, 2, 1) before flattening.  Cells
equal to the batch mode are empty.  Rows with >= max_length tokens keep
their first max_length - 1 and end at column max_length - 1.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def get_mode(vals: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Most frequent value (scalar int64); ties go to the smallest value,
    as bincount + argmax gives them (not torch.mode)."""
    counts = torch.bincount(vals.reshape(-1), minlength=vocab_size)
    return torch.argmax(counts)


def dense2sparse(dense: torch.Tensor, max_length: int,
                 end_tokens: Sequence[int], vocab_size: int, mode=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, r, r, r) canonical-layout int grid -> ((B, max_length, 2) int64
    sequence, mode)."""
    B = dense.shape[0]
    if dense.dim() == 4:
        dense = dense.permute(0, 3, 2, 1)
    flat = dense.reshape(B, -1).long()
    n_cells = flat.shape[1]
    if mode is None:
        mode = get_mode(flat, vocab_size)
    keep = flat != mode
    slot = torch.cumsum(keep.long(), dim=1) - 1
    count = keep.sum(dim=1)
    valid = keep & (slot < max_length)
    tgt = torch.where(valid, slot, torch.full_like(slot, max_length))
    pos_ids = torch.arange(n_cells, device=flat.device).expand(B, n_cells)
    e0, e1 = int(end_tokens[0]), int(end_tokens[1])
    out_pos = torch.full((B, max_length + 1), e0, dtype=torch.long,
                         device=flat.device)
    out_val = torch.full_like(out_pos, e1)
    out_pos.scatter_(1, tgt, torch.where(valid, pos_ids, e0))
    out_val.scatter_(1, tgt, torch.where(valid, flat, e1))
    out_pos, out_val = out_pos[:, :max_length], out_val[:, :max_length]
    overflow = count >= max_length
    out_pos[:, max_length - 1] = torch.where(overflow, e0,
                                             out_pos[:, max_length - 1])
    out_val[:, max_length - 1] = torch.where(overflow, e1,
                                             out_val[:, max_length - 1])
    return torch.stack([out_pos, out_val], dim=-1), mode


def sparse2dense(seq: torch.Tensor, empty_ind, reso: int) -> torch.Tensor:
    """(B, L, 2) sequence -> (B, r, r, r) canonical-layout index grid.
    End and out-of-range positions are ignored; other cells hold empty_ind."""
    B = seq.shape[0]
    n_cells = reso ** 3
    pos, val = seq[..., 0].long(), seq[..., 1].long()
    valid = (pos >= 0) & (pos < n_cells)
    dense = torch.empty((B, n_cells + 1), dtype=torch.long, device=seq.device)
    dense[:] = torch.as_tensor(empty_ind, device=seq.device)
    dense.scatter_(1, torch.where(valid, pos, n_cells), val)
    dense = dense[:, :n_cells].reshape(B, reso, reso, reso)
    return dense.permute(0, 3, 2, 1)


def _is_end(seq: torch.Tensor, end_tokens: Sequence[int]) -> torch.Tensor:
    out = torch.ones(seq.shape[:-1], dtype=torch.bool, device=seq.device)
    for i in range(min(seq.shape[-1], len(end_tokens))):
        out &= seq[..., i] == end_tokens[i]
    return out


def token_mask(seq: torch.Tensor, end_tokens: Sequence[int]) -> torch.Tensor:
    """(B, L, n) -> (B, L) float: 1 up to and including the first end token."""
    is_end = _is_end(seq, end_tokens).long()
    after_first_end = torch.cumsum(is_end, dim=1) - is_end
    return (after_first_end == 0).float()


def seq_lengths(seq: torch.Tensor, end_tokens: Sequence[int]) -> torch.Tensor:
    """Number of real (non-end) tokens per row."""
    is_end = _is_end(seq, end_tokens)
    pad = torch.ones((seq.shape[0], 1), dtype=torch.bool, device=seq.device)
    return torch.argmax(torch.cat([is_end, pad], dim=1).long(), dim=1)
