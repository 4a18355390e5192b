"""CondTupleGPT: the training forward, prefill and KV-cached two-stage
decode (shapeformer_tpu/models/shapeformer/transformer/mingpt.py).

Numerics follow the JAX package: f32 compute, exact erf GELU, LayerNorm eps
1e-5, finite NEG_INF masking with an f32 softmax, and a bf16 KV cache
(`cache_dtype`).  Prefill attends with its unrounded f32 k/v while the cache
stores them rounded.  Caches are per-layer (B, T, C) tensors (heads unsplit)
that decode updates in place, where the JAX package returns new arrays.

Prefill and decode attend with torch ops: the JAX package runs them in XLA.
The training forward attends with torch ops too, or, with `flash_attn=True`,
with the hand CUDA kernels of ops/attention.py, as the JAX package's
training forward takes its Pallas kernel.  Dropout masks come from an
explicit torch.Generator.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ....ops.attention import CausalAttention

NEG_INF = -1e30

Cache = List[List[Tuple[torch.Tensor, torch.Tensor]]]


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from `generator`; the identity at
    p = 0 or without a generator (the deterministic forward)."""
    if p <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    return x * keep / (1.0 - p)


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.attn_pdrop, self.resid_pdrop = attn_pdrop, resid_pdrop
        self.qkv = nn.Linear(n_embd, 3 * n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                key_valid: Optional[torch.Tensor] = None,
                flash: Optional[CausalAttention] = None,
                generator: Optional[torch.Generator] = None):
        """x (B, T, C) -> (y, (k, v)) with k, v (B, T, C) in f32.  Without
        `flash`, mask (broadcastable to (B, 1, T, T)) says what is attended;
        with it, the kernel op attends causally over key_valid (B, T) and
        mask is not read.  generator: dropout source, None = deterministic."""
        B, T, C = x.shape
        H, D = self.n_head, C // self.n_head
        q, k, v = self.qkv(x).split(C, dim=-1)
        if flash is not None:
            y = flash(*(t.view(B, T, H, D) for t in (q, k, v)), key_valid)
        else:
            qh, kh, vh = (t.reshape(B, T, H, D).transpose(1, 2)
                          for t in (q, k, v))
            att = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(D))
            att = att.masked_fill(~mask, NEG_INF).float().softmax(dim=-1)
            att = dropout(att, self.attn_pdrop, generator)
            y = (att @ vh).transpose(1, 2).reshape(B, T, C)
        return dropout(self.proj(y), self.resid_pdrop, generator), (k, v)

    def decode(self, x_new: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, index: int, key_valid: torch.Tensor
               ) -> torch.Tensor:
        """One position against this layer's cache.  x_new (B, 1, C);
        cache_k/v (B, T, C), written at `index` in place; key_valid (B, T)
        bool, causality included."""
        B, _, C = x_new.shape
        H, D = self.n_head, C // self.n_head
        q, k, v = self.qkv(x_new).split(C, dim=-1)
        cache_k[:, index] = k[:, 0].to(cache_k.dtype)
        cache_v[:, index] = v[:, 0].to(cache_v.dtype)
        T = cache_k.shape[1]
        qh = q.reshape(B, H, 1, D) * (1.0 / math.sqrt(D))
        kh = cache_k.float().reshape(B, T, H, D).transpose(1, 2)
        vh = cache_v.float().reshape(B, T, H, D).transpose(1, 2)
        att = (qh @ kh.transpose(-1, -2))                     # (B, H, 1, T)
        att = att.masked_fill(~key_valid[:, None, None, :], NEG_INF)
        y = att.softmax(dim=-1) @ vh                          # (B, H, 1, D)
        return self.proj(y.reshape(B, 1, C))


class Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0):
        super().__init__()
        self.resid_pdrop = resid_pdrop
        self.ln1 = nn.LayerNorm(n_embd, eps=1e-5)
        self.ln2 = nn.LayerNorm(n_embd, eps=1e-5)
        self.attn = CausalSelfAttention(n_embd, n_head, attn_pdrop,
                                        resid_pdrop)
        self.fc1 = nn.Linear(n_embd, 4 * n_embd)
        self.fc2 = nn.Linear(4 * n_embd, n_embd)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                key_valid: Optional[torch.Tensor] = None,
                flash: Optional[CausalAttention] = None,
                generator: Optional[torch.Generator] = None):
        a, kv = self.attn(self.ln1(x), mask, key_valid, flash, generator)
        x = x + a
        mlp = dropout(self._mlp(self.ln2(x)), self.resid_pdrop, generator)
        return x + mlp, kv

    def decode(self, x_new, cache_k, cache_v, index, key_valid):
        x = x_new + self.attn.decode(self.ln1(x_new), cache_k, cache_v, index,
                                     key_valid)
        return x + self._mlp(self.ln2(x))


class Head(nn.Module):
    def __init__(self, vocab_size: int, n_embd: int,
                 head_hidden_layers: int = 0):
        super().__init__()
        self.head_hidden_layers = head_hidden_layers
        self.LayerNorm_0 = nn.LayerNorm(n_embd, eps=1e-5)
        for i in range(head_hidden_layers):
            setattr(self, f"Dense_{i}", nn.Linear(n_embd, n_embd))
        setattr(self, f"Dense_{head_hidden_layers}",
                nn.Linear(n_embd, vocab_size, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.LayerNorm_0(x)
        for i in range(self.head_hidden_layers):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.head_hidden_layers}")(x)


class CondTupleGPT(nn.Module):
    """Tuple-factorized conditional GPT.  Stage i runs n_layers[i] blocks on
    the running stream and emits logits for tuple element i; the embedding of
    element i is added before stage i + 1.  Condition and generation tokens
    have separate positional tables, the generation one restarting at 0.
    Submodule names follow the JAX parameter tree (tok_embs_0,
    stages_0_3, heads_1, ...).

    flash_attn: the training forward attends with the CUDA kernels of
    ops/attention.py (`self.attention`, which counts their launches).  What
    the kernels do not express (active attention dropout) raises there; the
    forward never changes its attention path by itself."""

    def __init__(self, vocab_sizes: Sequence[int],
                 extra_vocab_sizes: Sequence[int], block_size: int,
                 tuple_n: int, n_layers: Sequence[int] = (12,),
                 n_head: int = 8, n_embd: int = 256,
                 embd_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 attn_pdrop: float = 0.0, n_unmasked: int = 0,
                 head_hidden_layers: int = 0,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 flash_attn: bool = False):
        super().__init__()
        if not tuple_n == len(vocab_sizes) == len(n_layers):
            raise ValueError("tuple_n, vocab_sizes and n_layers disagree")
        if n_unmasked:
            raise NotImplementedError("n_unmasked > 0 is not ported")
        self.tuple_n, self.block_size = tuple_n, block_size
        self.n_layers = tuple(n_layers)
        self.n_embd, self.n_head = n_embd, n_head
        self.cache_dtype = cache_dtype
        self.embd_pdrop, self.attn_pdrop = embd_pdrop, attn_pdrop
        self.resid_pdrop = resid_pdrop
        self.flash_attn = flash_attn
        self.attention = CausalAttention()
        self.n_extra = len(extra_vocab_sizes)
        for i, v in enumerate(vocab_sizes):
            setattr(self, f"tok_embs_{i}", nn.Embedding(v, n_embd))
        for i, v in enumerate(extra_vocab_sizes):
            setattr(self, f"extra_tok_embs_{i}", nn.Embedding(v, n_embd))
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        self.cond_pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        for i, n in enumerate(n_layers):
            for j in range(n):
                setattr(self, f"stages_{i}_{j}",
                        Block(n_embd, n_head, attn_pdrop, resid_pdrop))
            setattr(self, f"heads_{i}",
                    Head(vocab_sizes[i], n_embd, head_hidden_layers))

    def tok_emb(self, i: int, idx: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"tok_embs_{i}")(idx)

    def stage(self, i: int) -> List[Block]:
        return [getattr(self, f"stages_{i}_{j}")
                for j in range(self.n_layers[i])]

    def head(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"heads_{i}")(x)

    def _token_embedding(self, idx, extra_idx):
        tok = sum(self.tok_emb(i, idx[..., i]) for i in range(self.tuple_n))
        extra = sum(getattr(self, f"extra_tok_embs_{i}")(extra_idx[..., i])
                    for i in range(self.n_extra))
        return tok + extra

    def forward(self, idx: torch.Tensor, extra_idx: torch.Tensor,
                L_cond: int, target_idx: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                logits_start: int = 0) -> List[torch.Tensor]:
        """Training forward: [logits_i (B, T - logits_start, V_i)].

        idx (B, T, tuple_n), extra_idx (B, T, n_extra); the first L_cond
        positions take the condition positional table, the rest the
        generation table from 0.  target_idx is idx shifted left by one:
        stage i + 1 runs on stage i's stream plus tok_emb_i(target[..., i]).
        key_valid (B, T) bool hides padding keys.  The heads run only from
        position logits_start on.  Dropout is active when `deterministic` is
        False, with masks from `generator`."""
        T = idx.shape[1]
        if T > self.block_size:
            raise ValueError(f"sequence of {T} exceeds block_size "
                             f"{self.block_size}")
        pdrops = (self.embd_pdrop, self.resid_pdrop, self.attn_pdrop)
        if deterministic:
            generator = None
        elif generator is None and any(p > 0 for p in pdrops):
            raise ValueError("dropout needs a generator")
        flash = None
        mask = None
        if self.flash_attn:
            if generator is not None and self.attn_pdrop > 0:
                raise NotImplementedError(
                    "the attention kernels have no dropout: use attn_pdrop = "
                    "0 or flash_attn = False")
            flash = self.attention
        else:
            causal = torch.ones((T, T), dtype=torch.bool,
                                device=idx.device).tril()
            mask = causal[None, None]
            if key_valid is not None:
                mask = mask & key_valid[:, None, None, :]
        pos = torch.cat([self.cond_pos_emb[:, :L_cond],
                         self.pos_emb[:, :T - L_cond]], dim=1)
        x = self._token_embedding(idx, extra_idx) + pos
        logits = []
        for i in range(self.tuple_n):
            x = dropout(x, self.embd_pdrop, generator)
            for blk in self.stage(i):
                x, _ = blk(x, mask, key_valid, flash, generator)
            logits.append(self.head(i, x[:, logits_start:]))
            if i < self.tuple_n - 1:
                x = x + self.tok_emb(i, target_idx[..., i])
        return logits

    @property
    def cache_block(self) -> int:
        """Cache T extent: block_size rounded up to a multiple of 8; the
        tail is key-masked."""
        return -(-self.block_size // 8) * 8

    def prefill(self, idx: torch.Tensor, extra_idx: torch.Tensor,
                key_valid: torch.Tensor):
        """Run the (B, P, tuple_n) condition prefix once, filling every
        stage's caches.  Stage i + 1 reads element i of token t + 1 at
        position t, so position P - 1 of stages >= 1 stays unfinished until
        decode_stage_i writes it.  Returns (caches, h0_last (B, C),
        logits0_last (B, V0))."""
        B, P, _ = idx.shape
        x = self._token_embedding(idx, extra_idx) + self.cond_pos_emb[:, :P]
        causal = torch.ones((P, P), dtype=torch.bool, device=idx.device).tril()
        mask = causal[None, None] & key_valid[:, None, None, :]
        T = self.cache_block
        caches: Cache = []
        h_last = logits0_last = None
        for i in range(self.tuple_n):
            stage_caches = []
            for blk in self.stage(i):
                x, (k, v) = blk(x, mask)
                ck = torch.zeros((B, T, self.n_embd), dtype=self.cache_dtype,
                                 device=x.device)
                cv = torch.zeros_like(ck)
                ck[:, :P] = k
                cv[:, :P] = v
                stage_caches.append((ck, cv))
            caches.append(stage_caches)
            if i == 0:
                h_last = x[:, -1]
                logits0_last = self.head(0, x[:, -1])
            if i < self.tuple_n - 1:
                nxt = torch.cat([idx[:, 1:, i], idx[:, -1:, i]], dim=1)
                x = x + self.tok_emb(i, nxt)
        return caches, h_last, logits0_last

    def decode_stage_i(self, caches: Cache, h_prev: torch.Tensor,
                       prev_elem: torch.Tensor, stage_i: int, index: int,
                       key_valid: torch.Tensor):
        """Stage stage_i >= 1 at one position, fed the freshly sampled
        element stage_i - 1.  Returns (logits_i (B, V_i), h_i (B, C))."""
        x = (h_prev + self.tok_emb(stage_i - 1, prev_elem))[:, None]
        for blk, (ck, cv) in zip(self.stage(stage_i), caches[stage_i]):
            x = blk.decode(x, ck, cv, index, key_valid)
        return self.head(stage_i, x[:, 0]), x[:, 0]

    def decode_stage0(self, caches: Cache, new_token: torch.Tensor,
                      new_extra: torch.Tensor, index: int, gen_pos: int,
                      key_valid: torch.Tensor):
        """Append the completed (B, tuple_n) token at `index` and advance
        stage 0; gen_pos indexes the generation positional table.  Returns
        (h0 (B, C), logits0 (B, V0))."""
        x = (self._token_embedding(new_token, new_extra)
             + self.pos_emb[0, gen_pos])[:, None]
        for blk, (ck, cv) in zip(self.stage(0), caches[0]):
            x = blk.decode(x, ck, cv, index, key_valid)
        return x[:, 0], self.head(0, x[:, 0])
