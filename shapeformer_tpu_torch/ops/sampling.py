"""Logit filtering and ranked sampling (shapeformer_tpu/ops/sampling.py).

Filter order: temperature -> top-k -> top-p (nucleus) on the top-k values,
keeping at least the best token.  Draws are Gumbel-max over the kept set
from an explicit torch.Generator; they follow the same distribution as the
JAX sampler's but not its bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite stand-in for -inf (safe under softmax)


def _nucleus_min(sorted_desc: torch.Tensor, top_p: float) -> torch.Tensor:
    """Smallest kept logit of descending-sorted rows under nucleus top_p."""
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    remove = torch.cat([torch.zeros_like(cum[..., :1], dtype=torch.bool),
                        (cum > top_p)[..., :-1]], dim=-1)
    kept = torch.where(remove, torch.full_like(sorted_desc, float("inf")),
                       sorted_desc)
    return kept.min(dim=-1, keepdim=True).values


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                  temperature: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> filtered (B, V) logits, removed entries NEG_INF."""
    logits = logits.float() / temperature
    V = logits.shape[-1]
    neg = torch.full_like(logits, NEG_INF)
    if top_k and top_k > 0:
        topv = torch.topk(logits, min(int(top_k), V), dim=-1).values
        logits = torch.where(logits < topv[..., -1:], neg, logits)
        if top_p and top_p > 0.0:
            logits = torch.where(logits < _nucleus_min(topv, top_p), neg,
                                 logits)
    elif top_p and top_p > 0.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        logits = torch.where(logits < _nucleus_min(sorted_desc, top_p), neg,
                             logits)
    return logits


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_ranked(logits: torch.Tensor, generator: torch.Generator,
                  top_k: int = 0, top_p: float = 0.0,
                  temperature: float = 1.0,
                  best_rows: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter + sample + log-prob, compressed to the top-k set.

    best_rows: optional (B,) bool, True rows take the argmax of the filtered
    logits instead of a draw.  The log-prob is p(token) under the UNSCALED
    input logits (no temperature, no filter): the sampler's ranking key.
    Returns ((B,) int64 tokens, (B,) f32 log-probs)."""
    raw = logits.float()
    scaled = raw / temperature
    V = scaled.shape[-1]
    lse = torch.logsumexp(raw, dim=-1)
    if top_k and top_k > 0:
        topv, topi = torch.topk(scaled, min(int(top_k), V), dim=-1)
        if top_p and top_p > 0.0:
            vals = torch.where(topv < _nucleus_min(topv, top_p),
                               torch.full_like(topv, NEG_INF), topv)
        else:
            vals = topv
        g = _gumbel(vals.shape, generator, vals.device)
        sel = torch.argmax(vals + g, dim=-1)
        if best_rows is not None:
            sel = torch.where(best_rows, torch.zeros_like(sel), sel)
        tok = torch.gather(topi, 1, sel[:, None])[:, 0]
    else:
        filtered = filter_logits(scaled, top_k=0, top_p=top_p)
        g = _gumbel(filtered.shape, generator, filtered.device)
        tok = torch.argmax(filtered + g, dim=-1)
        if best_rows is not None:
            tok = torch.where(best_rows, torch.argmax(filtered, dim=-1), tok)
    chosen = torch.gather(raw, 1, tok[:, None])[:, 0]
    return tok, chosen - lse
