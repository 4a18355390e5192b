"""AR_N representer (shapeformer_tpu/models/shapeformer/representers.py).

Bridges the frozen VQDIF and the transformer: condition tokens from a
partial cloud and, for training, target tokens from the full cloud, the
train-stage random thinning of the condition, the 'next condition position'
extra channel, and the sampling maskers (monotonic positions, end-token
forcing, completion consistency).  Sequences are padded to max_length =
block_size // 2.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def draw_cind_mask(B: int, L: int, generator: torch.Generator, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniform draws of the condition thinning: (k_u (B,), u (B, L))."""
    k_u = torch.rand((B,), device=device, generator=generator)
    u = torch.rand((B, L), device=device, generator=generator)
    return k_u, u


def random_cind_mask(c_indices: torch.Tensor, k_u: torch.Tensor,
                     u: torch.Tensor, end_tokens: Sequence[int]
                     ) -> torch.Tensor:
    """Keep a random subset of each row's condition tokens, in order, moved
    to the front and end-padded.  Row b keeps floor(k_u[b] * (len_b + 1))
    tokens (at most len_b): those with the smallest u among its real
    tokens.  A pure function of its arguments."""
    B, L, _ = c_indices.shape
    lens = sparse_ops.seq_lengths(c_indices, end_tokens)
    k = torch.minimum(torch.floor(k_u * (lens + 1)).long(), lens)
    real = torch.arange(L, device=c_indices.device)[None, :] < lens[:, None]
    u = torch.where(real, u, torch.full_like(u, float("inf")))
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1,
                         stable=True)
    keep = rank < k[:, None]
    slot = torch.cumsum(keep.long(), dim=1) - 1
    tgt = torch.where(keep, slot, torch.full_like(slot, L))
    e = torch.tensor(list(end_tokens), device=c_indices.device,
                     dtype=c_indices.dtype)
    out = e.expand(B, L + 1, len(end_tokens)).clone()
    src = torch.where(keep[..., None], c_indices, e.expand_as(c_indices))
    out.scatter_(1, tgt[..., None].expand_as(src), src)
    return out[:, :L]


class AR_N:
    """Absolute raveled positions plus the next-condition-position extra
    channel."""

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
        self.random_cind_masking = random_cind_masking
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

    def get_indices(self, Xct: torch.Tensor,
                    Xbd: Optional[torch.Tensor] = None, stage: str = "train",
                    generator: Optional[torch.Generator] = None):
        """-> (c_indices, z_indices, extra_indices, others), all (B, L, .)
        end-padded.  Xct is the partial cloud, Xbd the full one (None: no
        target tokens, as in sampling).  At stage 'train' with
        random_cind_masking the condition is thinned with draws from
        `generator`."""
        _, _, mode, c_indices = self.encode_cloud(Xct)
        if Xbd is None:
            z_indices = c_indices[:, :0]
        else:
            _, _, _, z_indices = self.encode_cloud(Xbd)
        if self.uncond:
            e = torch.tensor(self.input_end_tokens, device=c_indices.device)
            c_indices = e.expand_as(c_indices).clone()
        others = dict(empty_index=mode, origin_c_indices=c_indices,
                      origin_z_indices=z_indices)
        if stage == "train" and self.random_cind_masking:
            if generator is None:
                raise ValueError("random_cind_masking needs a generator")
            k_u, u = draw_cind_mask(*c_indices.shape[:2], generator,
                                    c_indices.device)
            c_indices = random_cind_mask(c_indices, k_u, u,
                                         self.input_end_tokens)
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
