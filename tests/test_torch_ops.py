"""The port's ops against the JAX package's: segment pooling (plain version
of the CUDA kernel) against the Pallas scan kernel run in interpret mode,
the grid builds, the token codec and the sampler."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeformer_tpu.ops import gridcoords as jgrid
from shapeformer_tpu.ops import pallas_scatter as jpallas
from shapeformer_tpu.ops import sampling as jsampling
from shapeformer_tpu.ops import scatter as jscatter
from shapeformer_tpu.ops import sparse as jsparse
from shapeformer_tpu_torch.ops import gridcoords, sampling, scatter, sparse
from shapeformer_tpu_torch.ops.segment_pool import (
    SegmentPool, segment_pool_plain, segmented_scan_plain)
from torch_parity import t


def _port_pool_gather(c, ids, mode):
    """Port plan + plain segment_pool, read back in the original order."""
    plan = scatter.pool_plan(t(ids))
    perm = plan["perm"]
    cs = torch.gather(t(c), 1, perm[..., None].expand(-1, -1, c.shape[-1]))
    out_s = segment_pool_plain(cs, plan["offsets"], mode)
    return torch.empty_like(out_s).scatter_(
        1, perm[..., None].expand_as(out_s), out_s).numpy()


@pytest.mark.parametrize("mode", ["max", "mean"])
def test_segment_pool_plain_matches_pallas_and_pooled_sorted(rng, mode):
    """Plain segment_pool == JAX pooled_gather(use_pallas=True) (the Pallas
    scan kernel, interpret mode on the CPU) and == pooled_sorted.  Max is
    exact; mean is rtol 1e-5 (another summation order)."""
    B, N, C, n_cells = 2, 300, 5, 23
    c = rng.normal(size=(B, N, C)).astype(np.float32)
    ids = rng.integers(0, n_cells, (B, N))
    jplan = jscatter.pool_plan(jnp.asarray(ids))
    want_pallas = np.asarray(jscatter.pooled_gather(
        jnp.asarray(c), jplan, mode=mode, use_pallas=True))
    cs = jnp.take_along_axis(jnp.asarray(c), jplan["perm"][..., None], axis=1)
    want_sorted = np.asarray(jnp.take_along_axis(
        jscatter.pooled_sorted(cs, jplan, mode),
        jplan["inv_perm"][..., None], axis=1))
    got = _port_pool_gather(c, ids, mode)
    for want in (want_pallas, want_sorted):
        if mode == "max":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_segment_pool_plain_one_cell_and_bf16(rng):
    """All points in one cell, and bf16 input accumulated in f32."""
    c = rng.normal(size=(1, 257, 32)).astype(np.float32)
    ids = np.zeros((1, 257), np.int64)
    for mode, ref in (("max", c.max(1, keepdims=True)),
                      ("mean", c.mean(1, keepdims=True))):
        got = _port_pool_gather(c, ids, mode)
        np.testing.assert_allclose(got, np.broadcast_to(ref, c.shape),
                                   rtol=1e-5, atol=1e-6)
    cb = t(c).to(torch.bfloat16)
    plan = scatter.pool_plan(t(ids))
    got = segment_pool_plain(cb, plan["offsets"], "mean")
    assert got.dtype == torch.bfloat16
    ref = cb.float().mean(1, keepdim=True).expand_as(got).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), ref.float().numpy())


@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("reverse", [False, True])
def test_segmented_scan_plain_matches_pallas(rng, mode, reverse):
    """Plain segmented_scan == the Pallas kernel (interpret mode) across its
    256-row tiles, forward and reverse, max and sum; tolerance 1e-5."""
    B, N, C = 2, 300, 5
    vals = rng.normal(size=(B, N, C)).astype(np.float32)
    ids = np.sort(rng.integers(0, 40, (B, N)), axis=1)
    start = np.concatenate([np.ones((B, 1), bool), ids[:, 1:] != ids[:, :-1]],
                           axis=1)
    end = np.concatenate([start[:, 1:], np.ones((B, 1), bool)], axis=1)
    flags = end if reverse else start
    want = np.asarray(jpallas.segmented_scan(
        jnp.asarray(vals), jnp.asarray(flags), mode, reverse=reverse))
    got = segmented_scan_plain(t(vals), t(flags), mode, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_pool_dispatch_by_device(rng):
    """A CPU tensor takes the plain version and launches nothing; a device
    the kernel does not serve raises instead of falling back."""
    pool = SegmentPool()
    c = t(rng.normal(size=(1, 64, 32)).astype(np.float32))
    plan = scatter.pool_plan(t(rng.integers(0, 9, (1, 64))))
    out = pool(c, plan["offsets"], "max")
    assert out.shape == c.shape and pool.launches == 0
    with pytest.raises(ValueError):
        pool(c.to("meta"), plan["offsets"].to("meta"), "max")
    with pytest.raises(ValueError):
        pool(c, plan["offsets"], "sum")


def test_grid_build_and_occupancy_match_jax(rng):
    """Dense per-cell mean grid (empty cells 0) and occupancy == JAX."""
    B, N, C, n_cells = 3, 512, 8, 64
    c = rng.normal(size=(B, N, C)).astype(np.float32)
    ids = rng.integers(0, n_cells, (B, N))
    jplan = jscatter.pool_plan(jnp.asarray(ids))
    cs_j = jnp.take_along_axis(jnp.asarray(c), jplan["perm"][..., None], 1)
    want = np.asarray(jscatter.scatter_mean_sorted_c(cs_j, jplan, n_cells))
    want_occ = np.asarray(jscatter.occupancy_from_plan(jnp.asarray(ids), jplan,
                                                       n_cells))
    plan = scatter.pool_plan(t(ids))
    cs = torch.gather(t(c), 1, plan["perm"][..., None].expand(-1, -1, C))
    got = scatter.scatter_mean_sorted_c(cs, plan, n_cells).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        scatter.occupancy_from_plan(plan, n_cells).numpy(), want_occ)


def test_gridcoords_match_jax(rng):
    p = rng.uniform(-0.6, 0.6, (2, 500, 3)).astype(np.float32)
    want = np.asarray(jgrid.normalize_3d_coordinate(jnp.asarray(p)))
    got = gridcoords.normalize_3d_coordinate(t(p)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        gridcoords.coordinate2index(t(got), 64).numpy(),
        np.asarray(jgrid.coordinate2index(jnp.asarray(want), 64)))


def _codec_both(dense, L, end, vocab, mode=None):
    jseq, jmode = jsparse.dense2sparse(jnp.asarray(dense), L, end, vocab,
                                       mode=mode)
    seq, pmode = sparse.dense2sparse(t(dense), L, end, vocab, mode=mode)
    return (np.asarray(jseq), int(jmode)), (seq, int(pmode))


@pytest.mark.parametrize("case", ["plain", "tie", "overflow"])
def test_token_codec_matches_jax(rng, case):
    """dense2sparse / sparse2dense / get_mode / token_mask / seq_lengths are
    exact against JAX, including a mode tie (smallest value wins) and a row
    that overflows max_length."""
    reso, vocab, L, end = 4, 16, 20, (64, 16)
    if case == "plain":
        dense = rng.integers(0, vocab, (2, reso, reso, reso))
        dense[:, :2] = 7
    elif case == "tie":
        dense = np.zeros((2, reso, reso, reso), np.int64)
        dense[0] = 5
        dense[1] = 3                       # 64 cells each: tie -> 3
    else:
        L = 6
        dense = np.full((2, reso, reso, reso), 7, np.int64)
        dense[0, 1:3] = rng.integers(0, 7, (2, reso, reso))
        dense[1, 0, 0, :3] = 2
    (jseq, jmode), (seq, mode) = _codec_both(dense, L, end, vocab)
    assert mode == jmode
    if case == "tie":
        assert mode == 3
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_array_equal(
        sparse.sparse2dense(seq, mode, reso).numpy(),
        np.asarray(jsparse.sparse2dense(jnp.asarray(jseq), jmode, reso)))
    np.testing.assert_array_equal(
        sparse.token_mask(seq, end).numpy(),
        np.asarray(jsparse.token_mask(jnp.asarray(jseq), end)))
    np.testing.assert_array_equal(
        sparse.seq_lengths(seq, end).numpy(),
        np.asarray(jsparse.seq_lengths(jnp.asarray(jseq), end)))
    if case == "overflow":
        assert (seq[0, -1].numpy() == end).all()
    assert int(sparse.get_mode(t(dense), vocab)) == int(
        jsparse.get_mode(jnp.asarray(dense), vocab))


@pytest.mark.parametrize("kw", [dict(top_k=5, top_p=0.7), dict(top_k=5),
                                dict(top_p=0.7), dict(top_k=57)])
def test_filter_logits_matches_jax(rng, kw):
    logits = rng.normal(size=(16, 57)).astype(np.float32)
    want = np.asarray(jsampling.filter_logits(jnp.asarray(logits),
                                              temperature=0.8, **kw))
    got = sampling.filter_logits(t(logits), temperature=0.8, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(top_k=5, top_p=0.7), dict(top_k=5),
                                dict(top_p=0.7)])
def test_sample_ranked_support_and_log_prob(rng, kw):
    """Sampled tokens lie in the filtered support of the JAX filter; the
    log-prob is under the unscaled logits; best_rows pins the argmax."""
    logits = rng.normal(size=(16, 57)).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    best = torch.arange(16) % 4 == 0
    tok, lp = sampling.sample_ranked(t(logits), gen, temperature=0.8,
                                     best_rows=best, **kw)
    filt = np.asarray(jsampling.filter_logits(jnp.asarray(logits),
                                              temperature=0.8, **kw))
    tk = tok.numpy()
    assert (filt[np.arange(16), tk] > jsampling.NEG_INF).all()
    assert (tk[best.numpy()] == filt.argmax(-1)[best.numpy()]).all()
    want_lp = np.asarray(jsampling.log_prob_of(jnp.asarray(logits),
                                               jnp.asarray(tk)))
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-5, atol=1e-5)


def test_sample_ranked_distribution():
    """Empirical frequencies follow softmax over the kept top-k set, as the
    JAX test of sample_ranked checks."""
    base = t(np.asarray([[np.log(3.0), 0.0, -50.0, 0.0]] * 3000, np.float32))
    gen = torch.Generator().manual_seed(5)
    tok, _ = sampling.sample_ranked(base, gen, top_k=3)
    freq = np.bincount(tok.numpy(), minlength=4) / 3000.0
    assert abs(freq[0] - 0.6) < 0.05 and freq[2] == 0.0
    assert abs(freq[1] - 0.2) < 0.05 and abs(freq[3] - 0.2) < 0.05
