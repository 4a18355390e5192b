"""The port's VQDIF modules against the JAX package's, at test size, with
the JAX variables carried over by shapeformer_tpu_torch.convert.  Features
compare in f32 at rtol 1e-4, atol 1e-5 (another summation order); the
quantizer's indices compare exactly where the top-2 code distances differ
by more than 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeformer_tpu.models.layers import ResnetBlockFC as JResnetBlockFC
from shapeformer_tpu.models.vqdif.enc import LocalPoolPointnet as JEncoder
from shapeformer_tpu.models.vqdif.unet3d import UNet3D as JUNet3D
from shapeformer_tpu.models.vqdif.updown import Downsampler as JDownsampler
from shapeformer_tpu.models.vqdif.updown import Upsampler as JUpsampler
from shapeformer_tpu.models.vqdif.vqdif import VQDIF as JVQDIF
from shapeformer_tpu.ops.grid_sample import trilinear_sample as jtrilinear
from shapeformer_tpu_torch.convert import load_variables
from shapeformer_tpu_torch.models.layers import ResnetBlockFC
from shapeformer_tpu_torch.models.vqdif.dec import trilinear_sample
from shapeformer_tpu_torch.models.vqdif.enc import LocalPoolPointnet
from shapeformer_tpu_torch.models.vqdif.unet3d import UNet3D
from shapeformer_tpu_torch.models.vqdif.updown import Downsampler, Upsampler
from shapeformer_tpu_torch.utils.nputil import makeGrid
from torch_parity import build_pair, perturb, synthetic_cloud, t, to_numpy

F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


def _module_pair(jmod, port, x, rng):
    """Init jmod on x, perturb its params, load them into port; returns both
    outputs on x as numpy."""
    params = perturb(to_numpy(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)))["params"],
                     rng)
    load_variables(port, {"params": params})
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(t(x)).numpy()
    return got, want


def test_resnet_block_fc_matches_jax(rng):
    x = rng.normal(size=(2, 50, 32)).astype(np.float32)
    got, want = _module_pair(JResnetBlockFC(16), ResnetBlockFC(32, 16), x, rng)
    np.testing.assert_allclose(got, want, **F32)


def test_downsampler_matches_jax(rng):
    x = rng.normal(size=(1, 16, 16, 16, 16)).astype(np.float32)
    got, want = _module_pair(JDownsampler(in_channels=16, downsample_steps=2),
                             Downsampler(16, 2), x, rng)
    assert got.shape == (1, 4, 4, 4, 64)
    np.testing.assert_allclose(got, want, **F32)


def test_unet3d_matches_jax(rng):
    x = rng.normal(size=(1, 8, 8, 8, 64)).astype(np.float32)
    kw = dict(in_channels=64, out_channels=64, f_maps=64, num_levels=2)
    got, want = _module_pair(JUNet3D(**kw), UNet3D(**kw), x, rng)
    np.testing.assert_allclose(got, want, **F32)


def test_upsampler_matches_jax(rng):
    x = rng.normal(size=(1, 4, 4, 4, 64)).astype(np.float32)
    got, want = _module_pair(JUpsampler(in_channels=64, upsampler_steps=2),
                             Upsampler(64, 2), x, rng)
    assert got.shape == (1, 16, 16, 16, 16)
    np.testing.assert_allclose(got, want, **F32)


def test_local_pool_pointnet_grid_features_match_jax(pair):
    """The pooled per-point stack and the per-cell mean grid (the encoder
    without its Downsampler), through the plain segment_pool.  1024 points:
    the JAX grid build takes each cell's sum as a difference of an f32
    running sum over all points, whose rounding grows with the point
    count."""
    kw = dict(c_dim=16, hidden_dim=16, grid_resolution=32, downsampler=False)
    enc_params = {k: v for k, v in pair.jax_vars["params"]["encoder"].items()
                  if k != "downsampler"}
    port = load_variables(LocalPoolPointnet(**kw), {"params": enc_params})
    p = synthetic_cloud(1, 1024) / 2.0
    want, want_mask = jax.jit(JEncoder(**kw).apply)({"params": enc_params},
                                                    jnp.asarray(p))
    with torch.no_grad():
        got, mask = port(t(p))
    assert got.shape == (1, 32, 32, 32, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert port.segment_pool.launches == 0          # CPU: plain version


def test_quantize_cloud_matches_jax(pair):
    """Indices and the mode fill are exact wherever the top-2 code
    distances differ by more than 1e-4; at least 99% of cells qualify."""
    cloud = synthetic_cloud(2, 2048)
    vq = pair.port.representer.vqdif
    jvq, jvars = pair.jax_vqdif, pair.jax_vars
    jind, jmode, _ = jax.jit(lambda v, c: jvq.apply(
        v, c, method=JVQDIF.quantize_cloud))(jvars, jnp.asarray(cloud))
    jfeat, _ = jax.jit(lambda v, c: jvq.apply(v, c, method=JVQDIF.encode))(
        jvars, jnp.asarray(cloud))
    with torch.no_grad():
        ind, mode, _ = vq.quantize_cloud(t(cloud))
        dist = vq.quantizer.distances(t(np.asarray(jfeat)).reshape(
            -1, vq.quantizer.n_embd))
    top2 = torch.topk(dist, 2, largest=False).values
    clear = ((top2[:, 1] - top2[:, 0]) > 1e-4).reshape(ind.shape).numpy()
    assert clear.mean() >= 0.99
    assert int(mode) == int(jmode)
    np.testing.assert_array_equal(ind.numpy()[clear], np.asarray(jind)[clear])


def test_decode_index_grid_matches_jax(pair, rng):
    code = rng.integers(0, 128, (2, 8, 8, 8))
    jvq, jvars = pair.jax_vqdif, pair.jax_vars
    want = jax.jit(lambda v, c: jvq.apply(
        v, c, 16, method=JVQDIF.decode_index_grid)["logits"])(
        jvars, jnp.asarray(code))
    with torch.no_grad():
        got = pair.port.representer.vqdif.decode_index_grid(t(code), 16)
    assert got["logits"].shape == (2, 16 ** 3, 1)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_trilinear_and_query_grid(pair, rng):
    """trilinear_sample == the JAX trilinear_sample, and the decoder's
    separable query_grid == query on the makeGrid 'ij' lattice."""
    grid = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    p = rng.uniform(-0.1, 1.1, (2, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trilinear_sample(t(grid), t(p)).numpy(),
        np.asarray(jtrilinear(jnp.asarray(grid), jnp.asarray(p))), **F32)
    dec = pair.port.representer.vqdif.decoder
    processed = t(rng.normal(size=(1, 16, 16, 16, 16)).astype(np.float32))
    ax = torch.linspace(-1.0, 1.0, 12) / 2.0
    lattice = t(makeGrid([-1, -1, -1.0], [1.0, 1, 1], [12] * 3,
                         indexing="ij").astype(np.float32))[None] / 2.0
    with torch.no_grad():
        a = dec.query_grid(processed, (ax, ax, ax))
        b = dec.query(lattice, processed)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)
