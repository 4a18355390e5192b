"""AR_N representer, test-stage path
(shapeformer_tpu/models/shapeformer/representers.py).

Bridges the frozen VQDIF and the transformer: condition tokens from a
partial cloud, the 'next condition position' extra channel, and the
sampling maskers (monotonic positions, end-token forcing, completion
consistency).  Sequences are padded to max_length = block_size // 2.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...ops import sparse as sparse_ops
from ...ops.sampling import NEG_INF


def get_next_cond(c_pos: torch.Tensor, z_pos: torch.Tensor, end_token: int
                  ) -> torch.Tensor:
    """For each z position, the smallest condition position strictly greater
    (end_token if none, or if z is the end token).  c_pos (B, Lc) ascending
    with end padding; z_pos (B, Lz)."""
    if z_pos.shape[1] == 0:
        return z_pos
    cand = torch.where(c_pos[:, None, :] > z_pos[:, :, None],
                       c_pos[:, None, :], torch.full_like(c_pos[:, None, :],
                                                          end_token))
    nxt = cand.min(dim=-1).values
    return torch.where(z_pos == end_token, torch.full_like(nxt, end_token),
                       nxt)


class AR_N:
    """Absolute raveled positions plus the next-condition-position extra
    channel.  Training-only options (random_cind_masking) are accepted and
    not used: only the test stage is ported."""

    extra_tuple_n = 1

    def __init__(self, voxel_res: int = 16,
                 end_tokens: Sequence[int] = None,
                 input_end_tokens: Optional[Sequence[int]] = None,
                 block_size: int = None, uncond: bool = False,
                 no_val_ind: bool = False, vqvae_opt: Optional[dict] = None,
                 cloud_shrinkage: float = 1.0,
                 random_cind_masking: bool = False, mask_invalid: bool = True,
                 mask_invalid_completion: bool = False):
        self.voxel_res = voxel_res
        self.end_tokens = tuple(end_tokens)
        self.input_end_tokens = tuple(input_end_tokens or end_tokens)
        self.block_size = block_size
        self.uncond, self.no_val_ind = uncond, no_val_ind
        self.cloud_shrinkage = cloud_shrinkage
        self.mask_invalid = mask_invalid
        self.mask_invalid_completion = mask_invalid_completion
        self.max_length = block_size // 2
        self.vqdif = None

    def set_vqdif(self, vqdif) -> None:
        self.vqdif = vqdif

    def cond_token_mask(self, c_indices: torch.Tensor) -> torch.Tensor:
        """(B, L, 2) condition tokens -> (B, L) bool validity."""
        return sparse_ops.token_mask(c_indices, self.input_end_tokens) > 0

    def encode_cloud(self, cloud: torch.Tensor):
        """(B, N, 3) in [-1, 1] -> (quant_feat, quant_ind, mode, (B, L, 2))."""
        quant_ind, mode, encoded = self.vqdif.quantize_cloud(
            cloud * self.cloud_shrinkage)
        seq, mode = sparse_ops.dense2sparse(
            quant_ind, self.max_length, self.input_end_tokens,
            self.vqdif.quantizer.vocab_size, mode=mode)
        if self.no_val_ind:
            seq[..., 1] = 0
        return encoded["quant_feat"], quant_ind, mode, seq

    def get_indices(self, Xct: torch.Tensor):
        """Test stage: (c_indices, empty z_indices, extra_indices, others)."""
        _, _, mode, c_indices = self.encode_cloud(Xct)
        z_indices = c_indices[:, :0]
        if self.uncond:
            e = torch.tensor(self.input_end_tokens, device=c_indices.device)
            c_indices = e.expand_as(c_indices).clone()
        others = dict(empty_index=mode, origin_c_indices=c_indices,
                      origin_z_indices=z_indices)
        extra = self.get_extra_indices(c_indices, z_indices)
        return c_indices, z_indices, extra, others

    def get_extra_indices(self, c_indices: torch.Tensor,
                          z_indices: torch.Tensor) -> torch.Tensor:
        z_extra = get_next_cond(c_indices[..., 0], z_indices[..., 0],
                                self.end_tokens[0])
        return torch.cat([c_indices[..., 0], z_extra], dim=1)[..., None]

    def sampling_next_extra(self, cond_pos: torch.Tensor,
                            new_pos: torch.Tensor) -> torch.Tensor:
        """Extra index of a freshly sampled generation token."""
        return get_next_cond(cond_pos, new_pos[:, None],
                             self.end_tokens[0])[:, 0]

    def sampling_masker(self, logits: torch.Tensor, tuple_i: int, step_j: int,
                        new_pos: Optional[torch.Tensor] = None,
                        prev_pos: Optional[torch.Tensor] = None,
                        cond_pos: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """tuple_i 0 masks position logits given the previous position
        (B,); tuple_i 1 masks value logits given the new position (B,)."""
        end = self.end_tokens
        V = logits.shape[-1]
        positions = torch.arange(V, device=logits.device)[None, :]
        neg = torch.full_like(logits, NEG_INF)
        if tuple_i == 1:
            forced = torch.where(positions == end[1],
                                 torch.ones_like(logits), neg)
            return torch.where((new_pos == end[0])[:, None], forced, logits)
        if self.mask_invalid and step_j > 0:
            invalid = (positions <= prev_pos[:, None]) & (positions != end[0])
            logits = torch.where(invalid, neg, logits)
        if self.mask_invalid_completion:
            nxt = get_next_cond(cond_pos, prev_pos[:, None], end[0])[:, 0]
            # no condition position beyond prev: nothing is masked
            nxt = torch.where(nxt == end[0], nxt + 1, nxt)
            logits = torch.where(positions > nxt[:, None], neg, logits)
        return logits

    def mask_element(self, logits, tuple_i, step_j, prev_token, cur_elems,
                     cond_pos):
        """Mask element tuple_i's logits given the previous (B, 2) token and
        the elements already sampled this step."""
        if tuple_i == 0:
            return self.sampling_masker(logits, 0, step_j,
                                        prev_pos=prev_token[:, 0],
                                        cond_pos=cond_pos)
        return self.sampling_masker(logits, tuple_i, step_j,
                                    new_pos=cur_elems[0])
