"""The port's CondTupleGPT and sampler against the JAX package's, at test
size: prefill and one decode step of each stage (rtol 1e-4, atol 1e-4, f32
in another summation order with a bf16 cache), argmax sampling token for
token, and sampled runs against the filtered, masked support."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeformer_tpu.models.shapeformer.transformer.mingpt import (
    CondTupleGPT as JCondTupleGPT)
from shapeformer_tpu.ops import sampling as jsampling
from shapeformer_tpu_torch.ops import sampling
from torch_parity import build_pair, synthetic_cloud, t

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    pair = build_pair(seed=0)
    clouds = np.concatenate([synthetic_cloud(s, 1024) for s in (3, 4)])
    c, _, _, _ = pair.jax_sf.representer.get_indices(
        Xct=jnp.asarray(clouds), stage="test", vqdif_vars=pair.jax_vars)
    return pair, np.asarray(c), clouds


def test_prefill_and_decode_steps_match_jax(setup):
    pair, c, _ = setup
    jtf, params = pair.jax_sf.transformer, pair.jax_params
    rep = pair.jax_sf.representer
    tf = pair.port.transformer
    B, L_c, _ = c.shape
    cj = jnp.asarray(c)
    extra = rep.get_extra_indices(cj, cj[:, :0])
    cond_valid = rep.cond_token_mask(cj)
    jcaches, jh0, jl0 = jtf.apply(params, cj, extra, L_c, cond_valid,
                                  method=JCondTupleGPT.prefill)
    with torch.no_grad():
        caches, h0, l0 = tf.prefill(t(c), t(np.asarray(extra)),
                                    t(np.asarray(cond_valid)))
    np.testing.assert_allclose(h0.numpy(), np.asarray(jh0), **TOL)
    np.testing.assert_allclose(l0.numpy(), np.asarray(jl0), **TOL)
    # the caches hold bf16 roundings of f32 k/v that agree to ~1e-6, so a
    # value on a rounding boundary may land one bf16 step (at most 2^-7 of
    # the value) apart
    for stage, jstage in zip(caches, jcaches):
        for kv, jkv in zip(stage, jstage):
            for a, b in zip(kv, jkv):
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=2 ** -7, atol=1e-6)

    # decode from the JAX caches, so both run one step on the same inputs:
    # stage 1 finishes position L_c - 1, stage 0 appends at L_c
    caches = [[tuple(torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in kv) for kv in stage] for stage in jcaches]
    pos = np.asarray(jnp.argmax(jl0, -1))
    block = jtf.block_size
    kv1 = np.pad(np.asarray(cond_valid), ((0, 0), (0, block - L_c)))
    jl1, _, jcaches = jtf.apply(params, jcaches, jh0, jnp.asarray(pos), 1,
                                L_c - 1, jnp.asarray(kv1),
                                method=JCondTupleGPT.decode_stage_i)
    valid = torch.zeros((B, tf.cache_block), dtype=torch.bool)
    valid[:, :L_c] = t(np.asarray(cond_valid))
    with torch.no_grad():
        l1, _ = tf.decode_stage_i(caches, h0, t(pos), 1, L_c - 1, valid)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), **TOL)

    val = np.asarray(jnp.argmax(jl1, -1))
    token = np.stack([pos, val], -1)
    new_extra = np.asarray(rep.next_extra_for(cj[..., 0],
                                              jnp.asarray(pos)))[:, None]
    kv0 = kv1.copy()
    kv0[:, L_c] = True
    _, _, jl0b = jtf.apply(params, jcaches, jnp.asarray(token),
                           jnp.asarray(new_extra), L_c, 0, jnp.asarray(kv0),
                           method=JCondTupleGPT.decode_stage0)
    valid[:, L_c] = True
    with torch.no_grad():
        _, l0b = tf.decode_stage0(caches, t(token), t(new_extra), L_c, 0,
                                  valid)
    np.testing.assert_allclose(l0b.numpy(), np.asarray(jl0b), **TOL)


def _record_sampler(monkeypatch):
    """Wrap the port's sample_ranked; returns the list of
    (masked logits, tokens, kwargs) of every call."""
    calls = []
    inner = sampling.sample_ranked

    def wrapped(logits, generator, **kw):
        tok, lp = inner(logits, generator, **kw)
        calls.append((logits.clone(), tok.clone(), kw))
        return tok, lp
    monkeypatch.setattr(sampling, "sample_ranked", wrapped)
    return calls


def test_argmax_sampling_matches_jax_token_for_token(setup, monkeypatch):
    """best_rows all True: tokens equal the JAX sampler's, log-probs at rtol
    1e-4.  Every step's top-2 masked-logit margin is at least 1e-4, so the
    comparison cannot hinge on a tie."""
    pair, c, _ = setup
    kw = dict(max_steps=512, top_k=100, top_p=0.4)
    B = c.shape[0]
    want_tok, want_lp = pair.jax_sf.sample_indices(
        pair.jax_params, jnp.asarray(c), jax.random.PRNGKey(0),
        best_rows=jnp.ones((B,), bool), **kw)
    calls = _record_sampler(monkeypatch)
    got_tok, got_lp = pair.port.sample_indices(
        t(c), torch.Generator().manual_seed(0),
        best_rows=torch.ones(B, dtype=torch.bool), **kw)
    top2 = torch.stack([torch.topk(m, 2).values for m, _, _ in calls])
    assert float((top2[..., 0] - top2[..., 1]).min()) >= 1e-4
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), **TOL)


def test_sampled_tokens_lie_in_filtered_masked_support(setup, monkeypatch):
    """Sampled runs (torch's generator is not jax.random): every token lies
    in the JAX filter's support of the representer-masked logits, and
    positions keep the masker's order."""
    pair, c, _ = setup
    calls = _record_sampler(monkeypatch)
    tok, lp = pair.port.sample_indices(
        t(c), torch.Generator().manual_seed(1), max_steps=512, top_k=100,
        top_p=0.4, candidates=3)
    assert len(calls) > 0 and torch.isfinite(lp).all()
    for masked, chosen, kw in calls:
        filt = np.asarray(jsampling.filter_logits(
            jnp.asarray(masked.numpy()), top_k=kw["top_k"],
            top_p=kw["top_p"]))
        assert (filt[np.arange(len(chosen)), chosen.numpy()]
                > jsampling.NEG_INF).all()
    end = pair.port.end_tokens
    pos = tok[..., 0].numpy()
    for row in pos:
        real = row[row != end[0]]
        assert (np.diff(real) > 0).all()


def test_complete_many_matches_jax_on_pinned_candidates(setup):
    """complete_many over two clouds, two candidates each, best_in_first:
    the pinned first candidate of each condition equals the JAX tokens and
    log-prob; the layout is (S, candidates, L, 2)."""
    pair, c, clouds = setup
    kw = dict(candidates=2, max_steps=512, top_k=100, top_p=0.4,
              best_in_first=True)
    want = pair.jax_sf.complete_many(pair.jax_params, jnp.asarray(clouds),
                                     jax.random.PRNGKey(0),
                                     vqdif_vars=pair.jax_vars, **kw)
    got = pair.port.complete_many(t(clouds), torch.Generator().manual_seed(0),
                                  **kw)
    assert got["tokens"].shape == tuple(np.asarray(want["tokens"]).shape)
    assert int(got["empty_index"]) == int(want["empty_index"])
    np.testing.assert_array_equal(got["tokens"][:, 0].numpy(),
                                  np.asarray(want["tokens"])[:, 0])
    np.testing.assert_allclose(got["log_prob"][:, 0].numpy(),
                               np.asarray(want["log_prob"])[:, 0], **TOL)
