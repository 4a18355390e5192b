"""The completion slice as a whole: the port's serve.complete against the
JAX package's compute_batch flow (get_indices -> sample -> sparse2dense ->
decode_index_grid) on one synthetic partial cloud, plus the port's import
boundary and its copy of the flagship configuration."""
import copy
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from shapeformer_tpu.models.vqdif.vqdif import VQDIF as JVQDIF
from shapeformer_tpu.ops import sparse as jsparse
from shapeformer_tpu.models.shapeformer.shapeformer import (
    ShapeFormer as JShapeFormer)
from shapeformer_tpu_torch import configs, serve
from shapeformer_tpu_torch.convert import convert_variables
from shapeformer_tpu_torch.models.shapeformer.shapeformer import ShapeFormer
from shapeformer_tpu_torch.models.vqdif.vqdif import VQDIF
from shapeformer_tpu_torch.data.synthetic import (
    partial_cloud, superellipsoid_occupancy)
from shapeformer_tpu_torch.ops import sampling, sparse
from torch_parity import build_pair, synthetic_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_complete_matches_jax_compute_batch_flow(monkeypatch):
    """The argmax row (best_in_first pins candidate 0): condition tokens and
    sampled tokens exact, log-prob at rtol 1e-4; its top-2 masked-logit
    margin is >= 1e-4 at every step.  The other candidate is drawn by
    torch's generator: its tokens only have to be valid.

    Decoded logits: the code grid of sampled tokens is nearly constant (most
    cells hold the empty code), where the decoder's GroupNorm statistics
    E[x^2] - E[x]^2 cancel.  Against a float64 run of the same decode, the
    JAX package's f32 CPU grid (UNet + Upsampler) was ~6e-5 of its range
    off and the port's ~3e-6.  So the port is held to the float64 values at
    1e-5 of the range, and to the JAX result at 1e-3 of it."""
    pair = build_pair(seed=0)
    xct = synthetic_cloud(7, 1024)
    name = "chair"
    kw = dict(sample_n=2, top_k=100, top_p=0.4, temperature=1.0,
              sample_max_step=512, depth=3, decode_res=16)

    rep, jsf = pair.jax_sf.representer, pair.jax_sf
    key = jax.random.PRNGKey(zlib.crc32(name.encode()) % (2 ** 31))
    c, _, _, others = rep.get_indices(Xct=jnp.asarray(xct), stage="test",
                                      vqdif_vars=pair.jax_vars)
    out, raw, logp = jsf.sample(
        pair.jax_params, c, key, max_steps=kw["sample_max_step"],
        top_k=kw["top_k"], top_p=kw["top_p"], temperature=1.0,
        best_in_first=True, candidates=kw["sample_n"])
    dense = jsparse.sparse2dense(out, others["empty_index"], 2 ** kw["depth"])
    logits = pair.jax_vqdif.apply(pair.jax_vars, dense, kw["decode_res"],
                                  method=JVQDIF.decode_index_grid)["logits"]

    margins = []
    inner = sampling.sample_ranked

    def wrapped(masked, generator, **skw):
        top2 = torch.topk(masked[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        return inner(masked, generator, **skw)
    monkeypatch.setattr(sampling, "sample_ranked", wrapped)
    got = serve.complete(pair.port, xct, name, **kw)

    assert set(got) == {"samples", "origin_samples", "log_prob", "c_ind",
                        "empty_index", "decoded_logits", "batch"}
    assert min(margins) >= 1e-4
    np.testing.assert_array_equal(got["c_ind"].numpy(), np.asarray(c))
    assert got["empty_index"] == int(others["empty_index"])
    np.testing.assert_array_equal(got["samples"][0].numpy(),
                                  np.asarray(out)[0])
    np.testing.assert_allclose(got["log_prob"][0].numpy(),
                               np.asarray(logp)[0], rtol=1e-4, atol=1e-4)
    want_logits = np.asarray(logits)[0]
    span = np.abs(want_logits).max()
    vq64 = copy.deepcopy(pair.port.representer.vqdif).double()
    with torch.no_grad():
        exact = vq64.decode_index_grid(
            sparse.sparse2dense(got["samples"][:1], got["empty_index"],
                                2 ** kw["depth"]), kw["decode_res"])
    np.testing.assert_allclose(got["decoded_logits"][0].numpy(),
                               exact["logits"][0].numpy(), rtol=1e-4,
                               atol=1e-5 * span)
    np.testing.assert_allclose(got["decoded_logits"][0].numpy(), want_logits,
                               rtol=1e-4, atol=1e-3 * span)
    end = pair.port.end_tokens
    toks = got["samples"].numpy()
    assert ((toks[..., 0] < end[0]) | (toks[..., 0] == end[0])).all()
    assert (toks[..., 1] <= end[1]).all() and (toks >= 0).all()
    assert got["decoded_logits"].shape == (2, 16 ** 3, 1)
    assert torch.isfinite(got["decoded_logits"]).all()


def test_port_imports_nothing_of_jax():
    """The port and its serving entry import no jax, flax, yaml, h5py or
    shapeformer_tpu module."""
    code = ("import sys\n"
            "import shapeformer_tpu_torch, shapeformer_tpu_torch.serve\n"
            "import shapeformer_tpu_torch.kernels\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'yaml', 'h5py', 'shapeformer_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_flagship_configs_equal_the_yaml():
    for path, want in (("configs/vqdif/shapenet_res16.yaml",
                        configs.VQDIF_RES16),
                       ("configs/shapeformer/shapenet_scale.yaml",
                        configs.SHAPEFORMER_SCALE)):
        with open(os.path.join(REPO, path)) as f:
            opt = yaml.safe_load(f)
        assert opt["pl_model_opt"]["kwargs"] == want
    with open(os.path.join(REPO, "configs/demo/demo_shapeformer.yaml")) as f:
        demo = yaml.safe_load(f)["callbacks"]["vis_recon"]["kwargs"]
    for k in ("sample_n", "top_k", "top_p", "depth"):
        assert demo[k] == configs.DEMO[k]


def test_partial_cloud_sampler():
    """Points lie on the superellipsoid surface (inside when pulled 1%
    inward, outside when pushed 1% outward), in [-1, 1], seed-stable."""
    from shapeformer_tpu_torch.data.synthetic import random_superellipsoid
    pts = partial_cloud(np.random.default_rng(3), 4096)
    assert pts.shape == (4096, 3) and pts.dtype == np.float32
    assert np.abs(pts).max() <= 1.0
    np.testing.assert_array_equal(pts, partial_cloud(
        np.random.default_rng(3), 4096))
    center, radii, power, rot = random_superellipsoid(
        np.random.default_rng(3))
    inward = center + 0.99 * (pts - center)
    outward = center + 1.01 * (pts - center)
    assert superellipsoid_occupancy(inward, center, radii, power, rot).all()
    assert not superellipsoid_occupancy(outward, center, radii, power,
                                        rot).any()


def test_convert_covers_the_flagship_trees():
    """At flagship width the converter maps every leaf of the JAX VQDIF and
    CondTupleGPT trees onto a port state_dict key of the same shape, and
    misses none.  Abstract shapes only (jax.eval_shape, meta tensors)."""
    def zeros_like_tree(tree):
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)

    jvq = JVQDIF(**configs.VQDIF_RES16)
    cloud = jnp.zeros((1, 16384, 3))
    vq_tree = jax.eval_shape(jvq.init, jax.random.PRNGKey(0), cloud,
                             cloud[:, :8])
    jsf = JShapeFormer(**configs.SHAPEFORMER_SCALE, defer_vqvae=True)
    sf_tree = jax.eval_shape(jsf.init_variables, jax.random.PRNGKey(0))
    with torch.device("meta"):
        port_vq = VQDIF(**configs.VQDIF_RES16)
        port_tf = ShapeFormer(**configs.SHAPEFORMER_SCALE).transformer
    for tree, module in ((vq_tree, port_vq), (sf_tree, port_tf)):
        got = {k: tuple(v.shape) for k, v in
               convert_variables(zeros_like_tree(dict(tree))).items()}
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == want
