"""ShapeFormer sampling (shapeformer_tpu/models/shapeformer/shapeformer.py).

One prefill of the condition, candidate tiling of the caches, then a Python
loop of KV-cached two-stage decode steps with the representer's maskers and
ranked top-k / top-p sampling.  The loop stops at block_size, or at the
first step after which every row's last token has an end element (the JAX
package's exit check).  The caches are plain per-row caches; the JAX
package's split condition cache yields the same tokens.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...ops import sampling
from .representers import AR_N
from .transformer.mingpt import CondTupleGPT

_CLASSES = {"CondTupleGPT": CondTupleGPT, "AR_N": AR_N}


def _build(opt: dict, **extra):
    name = opt["class"].rsplit(".", 1)[-1]
    if name not in _CLASSES:
        raise ValueError(f"{opt['class']} has no counterpart in the port")
    return _CLASSES[name](**dict(opt.get("kwargs") or {}), **extra)


class ShapeFormer:
    """A CondTupleGPT and its representer, built from the JAX package's
    option dict (pl_model_opt kwargs)."""

    def __init__(self, tuple_n=None, block_size=None, end_tokens=None,
                 vocab_sizes=None, extra_vocab_sizes=None, voxel_res=16,
                 transformer_opt=None, representer_opt=None, optim_opt=None):
        self.tuple_n = tuple_n
        self.block_size = block_size
        self.end_tokens = tuple(end_tokens)
        self.voxel_res = voxel_res
        self.transformer = _build(transformer_opt)
        self.representer = _build(representer_opt)
        self.max_length = self.representer.max_length

    @torch.no_grad()
    def sample_indices(self, c_indices: torch.Tensor,
                       generator: torch.Generator, max_steps: int = 512,
                       top_k: int = 100, top_p: float = 0.8,
                       temperature: float = 1.0, best_in_first: bool = False,
                       candidates: int = 1,
                       best_rows: Optional[torch.Tensor] = None,
                       on_phase: Optional[Callable[..., None]] = None):
        """(B, L_c, 2) condition tokens -> (tokens (B * candidates, max_gen,
        2) end-padded, log_prob (B * candidates,)).

        best_in_first pins the first candidate of every condition to the
        argmax; best_rows, a (B * candidates,) bool mask, overrides it.
        on_phase(name, **info), when given, is called after the prefill
        ('prefill') and after the loop ('ar_loop', steps=...)."""
        tf, rep = self.transformer, self.representer
        B, L_c, _ = c_indices.shape
        dev = c_indices.device
        n = self.tuple_n
        T = tf.cache_block
        max_gen = min(int(max_steps), tf.block_size - L_c)
        ends = torch.tensor(self.end_tokens, device=dev)
        cond_pos = c_indices[..., 0]
        extra_c = rep.get_extra_indices(c_indices, c_indices[:, :0])
        cond_valid = rep.cond_token_mask(c_indices)
        caches, h0, logits0 = tf.prefill(c_indices, extra_c, cond_valid)
        if on_phase is not None:
            on_phase("prefill")
        if candidates > 1:
            caches = [[(k.repeat_interleave(candidates, 0),
                        v.repeat_interleave(candidates, 0)) for k, v in stage]
                      for stage in caches]
            h0 = h0.repeat_interleave(candidates, 0)
            logits0 = logits0.repeat_interleave(candidates, 0)
            cond_pos = cond_pos.repeat_interleave(candidates, 0)
            cond_valid = cond_valid.repeat_interleave(candidates, 0)
            B = B * candidates
        if best_rows is None and best_in_first:
            best_rows = torch.arange(B, device=dev) % candidates == 0
        # attendable keys: valid condition tokens plus the generated
        # positions appended so far (L_c .. L_c + j - 1 at the start of
        # step j).  Stages >= 1 write position L_c + j - 1 at step j, which
        # at j = 0 is the last condition position.
        valid = torch.zeros((B, T), dtype=torch.bool, device=dev)
        valid[:, :L_c] = cond_valid

        buf = ends.expand(B, max_gen, n).clone()
        prev = ends.expand(B, n).clone()
        logp = torch.zeros(B, device=dev)

        def pick(masked):
            return sampling.sample_ranked(
                masked, generator, top_k=top_k, top_p=top_p,
                temperature=temperature, best_rows=best_rows)

        j = 0
        while j < max_gen:
            m = rep.mask_element(logits0, 0, j, prev, (), cond_pos)
            elem, lp = pick(m)
            cur = [elem]
            h = h0
            for i in range(1, n):
                logits_i, h = tf.decode_stage_i(caches, h, cur[-1], i,
                                                L_c + j - 1, valid)
                m = rep.mask_element(logits_i, i, j, prev, cur, cond_pos)
                elem, lp_i = pick(m)
                lp = lp + lp_i
                cur.append(elem)
            token = torch.stack(cur, dim=-1)
            buf[:, j] = token
            extra_new = rep.sampling_next_extra(cond_pos, cur[0])[:, None]
            valid[:, L_c + j] = True
            h0, logits0 = tf.decode_stage0(caches, token, extra_new,
                                           L_c + j, j, valid)
            logp = logp + lp
            prev = token
            j += 1
            if bool((prev == ends).any(dim=-1).all()):
                break
        if on_phase is not None:
            on_phase("ar_loop", steps=j)
        return buf, logp

    def sample(self, c_indices, generator, **kw):
        """sample_indices; AR_N's output coding is its input coding.
        Returns (out_tokens, raw_tokens, log_prob)."""
        x, logp = self.sample_indices(c_indices, generator, **kw)
        return x, x, logp

    def complete_many(self, Xct: torch.Tensor, generator: torch.Generator,
                      candidates: int = 8, max_steps: int = 512,
                      top_k: int = 100, top_p: float = 0.4,
                      temperature: float = 1.0, best_in_first: bool = False
                      ) -> dict:
        """Complete S partial clouds (S, N, 3) in one sampling call,
        `candidates` samples each.  Returns tokens / raw (S, candidates, L,
        2), log_prob (S, candidates) and the empty_index of the batch."""
        with torch.no_grad():
            c, _, _, others = self.representer.get_indices(Xct)
        out, raw, logp = self.sample(
            c, generator, max_steps=max_steps, top_k=top_k, top_p=top_p,
            temperature=temperature, best_in_first=best_in_first,
            candidates=candidates)
        S = c.shape[0]
        return dict(tokens=out.reshape(S, candidates, *out.shape[1:]),
                    raw=raw.reshape(S, candidates, *raw.shape[1:]),
                    log_prob=logp.reshape(S, candidates),
                    empty_index=others["empty_index"])
