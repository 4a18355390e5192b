"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: small models of the flagship's structure, built in both frameworks
from the same option dicts, with the JAX variables carried into the port by
shapeformer_tpu_torch.convert.  Inputs and weight noise come from numpy
seeds; tensors cross between the frameworks as numpy arrays."""
from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch


def small_opts(voxel_res=8, grid_res=32, vocab=128, vq_dim=64, n_embd=128,
               n_layers=(2, 1), n_head=4, block_size=130):
    """(vqdif_opt, shapeformer_opt) in the YAML's form, at test size."""
    down_steps = int(np.log2(grid_res // voxel_res))
    vqdif_opt = {
        "vq_beta": 0.001,
        "encoder_opt": {
            "class": "shapeformer.models.vqdif.enc.LocalPoolPointnet",
            "kwargs": dict(c_dim=16, hidden_dim=16, plane_type="grid",
                           grid_resolution=grid_res, downsampler=True,
                           downsampler_kwargs=dict(
                               in_channels=16, downsample_steps=down_steps))},
        "quantizer_opt": {
            "class": "shapeformer.models.vqdif.quantizer.Quantizer",
            "kwargs": dict(vocab_size=vocab, n_embd=vq_dim)},
        "decoder_opt": {
            "class": "shapeformer.models.vqdif.dec.LocalDecoder",
            "kwargs": dict(c_dim=16, hidden_size=16, sample_mode="bilinear",
                           unet3d=True,
                           unet3d_kwargs=dict(num_levels=2, f_maps=vq_dim,
                                              in_channels=vq_dim,
                                              out_channels=vq_dim),
                           upsampler=True,
                           upsampler_kwargs=dict(in_channels=vq_dim,
                                                 upsampler_steps=down_steps))},
    }
    end = [voxel_res ** 3, vocab]
    vocab_sizes = [end[0] + 1, end[1] + 1]
    sf_opt = {
        "tuple_n": 2, "voxel_res": voxel_res, "block_size": block_size,
        "end_tokens": end, "vocab_sizes": vocab_sizes,
        "extra_vocab_sizes": [end[0] + 1],
        "representer_opt": {
            "class": "shapeformer.models.shapeformer.representers.AR_N",
            "kwargs": dict(voxel_res=voxel_res, block_size=block_size,
                           end_tokens=end, uncond=False, no_val_ind=False,
                           random_cind_masking=True,
                           mask_invalid_completion=True)},
        "transformer_opt": {
            "class": ("shapeformer.models.shapeformer.transformer.mingpt"
                      ".CondTupleGPT"),
            "kwargs": dict(tuple_n=2, vocab_sizes=vocab_sizes,
                           extra_vocab_sizes=[end[0] + 1],
                           block_size=block_size, n_layers=list(n_layers),
                           n_head=n_head, n_embd=n_embd)},
    }
    return vqdif_opt, sf_opt


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(params, rng, scale=0.05):
    """Add seeded noise to every parameter, so zero-initialised weights
    (ResnetBlockFC.fc_1, positional tables) carry signal in the tests: 5%
    of a leaf's spread, or 0.05 where the leaf is constant."""
    def one(x):
        x = np.asarray(x)
        spread = float(x.std()) or 1.0
        return (x + scale * spread * rng.normal(size=x.shape)
                ).astype(np.float32)
    return jax.tree_util.tree_map(one, params)


@functools.lru_cache(maxsize=None)
def build_pair(seed=0, n_pts=1024, n_head=4):
    """JAX VQDIF + ShapeFormer and their port counterparts (CPU) with the
    same weights.  Returns a namespace with jax_vqdif, jax_vars, jax_sf,
    jax_params, port (serve-built ShapeFormer with its VQDIF) and opts.
    n_head=2 gives the head width 64 that the attention kernels take.
    Cached: the test files of one process share a pair."""
    from shapeformer_tpu.models.shapeformer.shapeformer import (
        ShapeFormer as JaxShapeFormer)
    from shapeformer_tpu.models.vqdif.vqdif import VQDIF as JaxVQDIF
    from shapeformer_tpu_torch import serve

    vqdif_opt, sf_opt = small_opts(n_head=n_head)
    rng = np.random.default_rng(seed)
    jvq = JaxVQDIF(**vqdif_opt)
    jsf = JaxShapeFormer(**sf_opt, defer_vqvae=True)
    cloud = jnp.asarray(rng.uniform(-0.9, 0.9, (1, n_pts, 3)), jnp.float32)
    vq_vars = to_numpy(jax.jit(jvq.init)(jax.random.PRNGKey(seed), cloud,
                                         cloud[:, :8]))
    vq_vars = dict(params=perturb(vq_vars["params"], rng), vq=vq_vars["vq"])
    params = to_numpy(jax.jit(jsf.init_variables)(
        jax.random.PRNGKey(seed + 1)))
    params = dict(params=perturb(params["params"], rng))
    jsf.representer.set_vqdif(jvq, vq_vars)

    port = serve.build_completer("cpu", seed=seed, vqdif_opt=vqdif_opt,
                                 shapeformer_opt=sf_opt)
    serve.load_jax_variables(port, vq_vars, params)
    return types.SimpleNamespace(jax_vqdif=jvq, jax_vars=vq_vars,
                                 jax_sf=jsf, jax_params=params, port=port,
                                 vqdif_opt=vqdif_opt, sf_opt=sf_opt)


def t(x, dtype=None):
    """numpy -> torch (CPU)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def synthetic_cloud(seed, n_points):
    """(1, n, 3) float32 partial cloud from the port's sampler."""
    from shapeformer_tpu_torch.data.synthetic import partial_cloud
    return partial_cloud(np.random.default_rng(seed), n_points)[None]


def train_batch(seed, batch=2, context_n=1024, boundary_n=2048):
    """{Xct (B, context_n, 3), Xbd (B, boundary_n, 3)} float32: a partial
    scan and the whole surface of one shape per row, from the port's
    sampler."""
    from shapeformer_tpu_torch.data.synthetic import training_pair
    rng = np.random.default_rng(seed)
    pairs = [training_pair(rng, context_n, boundary_n) for _ in range(batch)]
    return dict(Xct=np.stack([p[0] for p in pairs]),
                Xbd=np.stack([p[1] for p in pairs]))


def port_named(tree):
    """A JAX parameter-shaped tree (parameters or their gradients, with or
    without the 'params' level) -> {port parameter name: numpy array}."""
    from shapeformer_tpu_torch.convert import convert_variables
    tree = to_numpy(tree)
    if set(tree) != {"params"}:
        tree = {"params": tree}
    return {k: np.ascontiguousarray(v)
            for k, v in convert_variables(tree).items()}
