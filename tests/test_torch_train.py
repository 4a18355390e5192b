"""The ShapeFormer training step of the port against the JAX package, on the
small pair of torch_parity (head width 64, all dropouts 0): the training
forward with both attention paths, the condition thinning fed JAX's own
draws, the loss, every gradient leaf, the optimizer with the same numpy
gradients, the decay split and the training configuration.

On the CPU the JAX forward attends with _attend (its Pallas kernel runs on
the TPU only) and the port's flash_attn=True path takes the plain versions
of its kernels, forward and hand-written backward."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from shapeformer_tpu.ops import sparse as jsparse
from shapeformer_tpu.systems import ShapeFormerSystem as JShapeFormerSystem
from shapeformer_tpu_torch import configs, systems
from shapeformer_tpu_torch.models.shapeformer import representers
from torch_parity import build_pair, port_named, t, to_numpy, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    """The pair and one batch's tokens from the JAX representer at stage
    'val' (no thinning): c, z (B, L, 2), extra (B, 2L, 1)."""
    pair = build_pair(seed=0, n_head=2)
    batch = train_batch(11)
    c, z, extra, _ = pair.jax_sf.representer.get_indices(
        Xct=jnp.asarray(batch["Xct"]), Xbd=jnp.asarray(batch["Xbd"]),
        stage="val", vqdif_vars=pair.jax_vars)
    return pair, batch, np.asarray(c), np.asarray(z), np.asarray(extra)


@pytest.fixture
def no_thinning(setup, monkeypatch):
    """random_cind_masking off on both sides, restored after the test."""
    pair = setup[0]
    monkeypatch.setattr(pair.jax_sf.representer, "random_cind_masking", False)
    monkeypatch.setattr(pair.port.representer, "random_cind_masking", False)


@pytest.mark.parametrize("flash_attn", [False, True])
def test_training_forward_matches_jax(setup, monkeypatch, flash_attn):
    """CondTupleGPT.forward == CondTupleGPT.apply with logits_start = L_c - 1
    (rtol 1e-4, atol 1e-5: f32 in another summation order)."""
    pair, _, c, z, extra = setup
    L_c = c.shape[1]
    cz = np.concatenate([c, z], axis=1)
    idx, target = cz[:, :-1], cz[:, 1:]
    rep = pair.jax_sf.representer
    key_valid = np.concatenate(
        [np.asarray(rep.cond_token_mask(jnp.asarray(c))),
         np.asarray(rep.cond_token_mask(jnp.asarray(z)))], axis=1)[:, :-1]
    assert not key_valid.all() and key_valid[:, 0].all()
    want = pair.jax_sf.transformer.apply(
        pair.jax_params, jnp.asarray(idx), jnp.asarray(extra[:, :-1]), L_c,
        jnp.asarray(target), jnp.asarray(key_valid), deterministic=True,
        logits_start=L_c - 1)
    tf = pair.port.transformer
    monkeypatch.setattr(tf, "flash_attn", flash_attn)
    with torch.no_grad():
        got = tf(t(idx), t(extra[:, :-1]), L_c, t(target), t(key_valid),
                 logits_start=L_c - 1)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (c.shape[0], z.shape[1], w.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_forward_refuses_what_the_kernels_do_not_express(setup, monkeypatch):
    """flash_attn with active attention dropout raises (the JAX package
    quietly takes its XLA path there); dropout without a generator raises."""
    pair, _, c, z, extra = setup
    tf = pair.port.transformer
    cz = t(np.concatenate([c, z], axis=1))
    args = (cz[:, :-1], t(extra[:, :-1]), c.shape[1], cz[:, 1:])
    monkeypatch.setattr(tf, "flash_attn", True)
    monkeypatch.setattr(tf, "attn_pdrop", 0.1)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        tf(*args, deterministic=False, generator=gen)
    with pytest.raises(ValueError):
        tf(*args, deterministic=False)
    with torch.no_grad():
        tf(*args, deterministic=True)          # eval: dropout is the identity


def test_dropout_is_seeded_and_unbiased():
    from shapeformer_tpu_torch.models.shapeformer.transformer.mingpt import (
        dropout)
    x = torch.ones(200, 500)
    a = dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert a.unique().tolist() == [0.0, float(np.float32(1.0 / 0.75))]
    assert abs(float(a.mean()) - 1.0) < 0.01
    assert dropout(x, 0.0, torch.Generator()) is x
    assert dropout(x, 0.25, None) is x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_cind_mask_matches_jax_on_its_own_draws(setup, seed):
    """The port's pure thinning function, fed the uniforms the JAX function
    draws from its key, gives the same tokens."""
    pair, _, c, _, _ = setup
    rep = pair.jax_sf.representer
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(rep._random_cind_mask(jnp.asarray(c), rng))
    k_rng, u_rng = jax.random.split(rng)
    B, L, _ = c.shape
    k_u = np.asarray(jax.random.uniform(k_rng, (B,)))
    u = np.asarray(jax.random.uniform(u_rng, (B, L)))
    got = representers.random_cind_mask(t(c), t(k_u), t(u),
                                        rep.input_end_tokens)
    np.testing.assert_array_equal(got.numpy(), want)
    lens = np.asarray(jsparse.seq_lengths(jnp.asarray(want),
                                          rep.input_end_tokens))
    full = np.asarray(jsparse.seq_lengths(jnp.asarray(c),
                                          rep.input_end_tokens))
    assert (lens <= full).all() and (full > 0).all()


def test_get_indices_train_stage_draws_from_the_generator(setup):
    """Stage 'train' thins the condition with the generator's draws (seeded,
    a subset in order); stage 'val' leaves it whole; no generator raises."""
    pair, batch, c, z, _ = setup
    rep = pair.port.representer
    xct, xbd = t(batch["Xct"]), t(batch["Xbd"])
    with torch.no_grad():
        cv, zv, extra, _ = rep.get_indices(xct, xbd, stage="val")
        c1, z1, _, oth = rep.get_indices(
            xct, xbd, stage="train",
            generator=torch.Generator().manual_seed(5))
        c2, _, _, _ = rep.get_indices(
            xct, xbd, stage="train",
            generator=torch.Generator().manual_seed(5))
        with pytest.raises(ValueError):
            rep.get_indices(xct, xbd, stage="train")
    np.testing.assert_array_equal(cv.numpy(), c)
    np.testing.assert_array_equal(zv.numpy(), z)
    assert extra.shape == (c.shape[0], c.shape[1] + z.shape[1], 1)
    assert torch.equal(c1, c2) and torch.equal(z1, zv)
    assert torch.equal(oth["origin_c_indices"], cv)
    end = rep.input_end_tokens[0]
    for row, full in zip(c1[..., 0].tolist(), cv[..., 0].tolist()):
        kept = [p for p in row if p != end]
        assert kept == sorted(kept) and set(kept) <= set(full)


@pytest.mark.parametrize("stage", ["val", "train"])
def test_loss_matches_jax(setup, no_thinning, stage):
    pair, batch, _, _, _ = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(pair.jax_sf.loss(pair.jax_params, jb, stage=stage,
                                  vqdif_vars=pair.jax_vars))
    tb = {k: t(v) for k, v in batch.items()}
    with torch.no_grad():
        got = float(pair.port.loss(tb, stage=stage))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("flash_attn", [False, True])
def test_loss_gradients_match_jax_grad(setup, no_thinning, monkeypatch,
                                       flash_attn):
    """Every leaf of d loss / d params, carried onto the port's names by the
    converter: max|diff| <= 1e-4 * (max|g| + 1e-6)."""
    pair, batch, _, _, _ = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.grad(lambda p: pair.jax_sf.loss(
        p, jb, stage="train", vqdif_vars=pair.jax_vars))(pair.jax_params)
    want = port_named(grads)
    tf = pair.port.transformer
    monkeypatch.setattr(tf, "flash_attn", flash_attn)
    tf.zero_grad()
    pair.port.loss({k: t(v) for k, v in batch.items()},
                   stage="train").backward()
    got = {k: p.grad.numpy().copy() for k, p in tf.named_parameters()}
    tf.zero_grad()
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * (np.abs(w).max() + 1e-6), name
    assert sum(np.abs(w).max() > 0 for w in want.values()) == len(want)


@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_optimizer_matches_optax_on_the_same_gradients(setup, clip):
    """Three updates from the same numpy gradients through the JAX system's
    optax chain and the port's AdamW, across a StepLR boundary (the rate
    halves at step 2), with and without clipping: parameters at rtol 1e-6
    (atol 1e-8 for leaves that stay at 0)."""
    pair = setup[0]
    optim_opt = {"lr": 1e-3, "scheduler": "StepLR", "step_size": 2,
                 "gamma": 0.5}
    sf_opt = dict(copy.deepcopy(pair.sf_opt), optim_opt=optim_opt)
    jsys = JShapeFormerSystem(
        {"class": "shapeformer.models.shapeformer.shapeformer.ShapeFormer",
         "kwargs": sf_opt}, steps_per_epoch=1, gradient_clip_val=clip)
    assert [float(jsys._lr(s)) for s in range(3)] == [1e-3, 1e-3, 5e-4]
    params = pair.jax_params["params"]
    opt_state = jsys.tx.init(params)

    port = systems.build_trainer("cpu", seed=0, vqdif_opt=pair.vqdif_opt,
                                 shapeformer_opt=sf_opt, steps_per_epoch=1,
                                 gradient_clip_val=clip)
    tf = port.model.transformer
    tf.load_state_dict({k: t(v) for k, v in port_named(params).items()})
    assert [port._lr(s) for s in range(3)] == [1e-3, 1e-3, 5e-4]

    rng = np.random.default_rng(4)
    import optax
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.integers(-4, 1)
                       ).astype(np.float32), to_numpy(params))
        updates, opt_state = jsys.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        named = port_named(grads)
        for name, p in tf.named_parameters():
            p.grad = t(named[name])
        port.apply_gradients()
    assert port.step == 3
    want = port_named(params)
    for name, p in tf.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-8, err_msg=name)


def test_decay_split_is_the_jax_decay_mask(setup):
    """Exactly the Linear weights decay: the leaves JAX's _decay_mask marks
    (`kernel`), under the port's names."""
    pair = setup[0]
    mask = JShapeFormerSystem._decay_mask(pair.jax_params["params"])
    ones = jax.tree_util.tree_map(
        lambda m, x: np.full(np.shape(x), float(m), np.float32), mask,
        to_numpy(pair.jax_params["params"]))
    want = {k for k, v in port_named(ones).items() if v.flat[0] == 1.0}
    tf = pair.port.transformer
    decayed, plain = systems.decay_split(tf)
    names = {id(p): k for k, p in tf.named_parameters()}
    assert {names[id(p)] for p in decayed} == want
    assert len(decayed) + len(plain) == len(names)
    assert all(k.endswith(".weight") for k in want)
    port = systems.ShapeFormerSystem(pair.port)
    groups = port.optimizer.param_groups
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert {names[id(p)] for p in groups[0]["params"]} == want
    assert groups[0]["betas"] == (0.9, 0.95) and groups[0]["eps"] == 1e-8


def test_train_step_updates_and_eval_step_does_not(setup):
    """train_step: finite loss, every parameter gets a gradient and moves,
    the step count advances; eval_step changes nothing and equals the loss
    at stage 'val'."""
    pair, batch, _, _, _ = setup
    port = systems.build_trainer(
        "cpu", seed=3, vqdif_opt=pair.vqdif_opt,
        shapeformer_opt=systems.train_options(pair.sf_opt))
    tf = port.model.transformer
    assert tf.flash_attn and tf.attn_pdrop == tf.resid_pdrop == 0.0
    before = {k: p.detach().clone() for k, p in tf.named_parameters()}
    phases = []
    out = port.train_step(batch, torch.Generator().manual_seed(0),
                          on_phase=phases.append)
    assert phases == ["tokenize", "forward", "backward", "optimizer"]
    assert torch.isfinite(out["loss"]) and out["lr"] == 1e-5
    assert port.step == 1
    for k, p in tf.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        assert not torch.equal(p.detach(), before[k]), k
    assert all(p.grad is None
               for p in port.model.representer.vqdif.parameters())
    after = {k: p.detach().clone() for k, p in tf.named_parameters()}
    ev = port.eval_step(batch)
    with torch.no_grad():
        want = port.model.loss({k: t(v) for k, v in batch.items()},
                               stage="val")
    assert float(ev["loss"]) == float(want)
    assert all(torch.equal(p.detach(), after[k])
               for k, p in tf.named_parameters())


def test_train_config_equals_the_yaml():
    with open(os.path.join(REPO,
                           "configs/shapeformer/shapenet_scale.yaml")) as f:
        opt = yaml.safe_load(f)
    train = configs.TRAIN
    assert train["optim_opt"] == opt["pl_model_opt"]["kwargs"]["optim_opt"]
    data = opt["datamodule_opt"]["kwargs"]
    dset = data["trainset_opt"]["kwargs"]["dset_opt"]["kwargs"]
    assert train["boundary_N"] == dset["boundary_N"]
    assert train["context_N"] == dset["partial_opt"]["kwargs"]["context_N"]
    assert data["batch_size"] == 1      # the yaml's; the port trains at 8
    assert train["batch_size"] == 8
    kw = systems.train_options()["transformer_opt"]["kwargs"]
    base = opt["pl_model_opt"]["kwargs"]["transformer_opt"]["kwargs"]
    changed = {k for k in kw if kw[k] != base.get(k)}
    assert changed == {"flash_attn", "embd_pdrop", "resid_pdrop",
                       "attn_pdrop"}
    assert kw["flash_attn"] is True
    assert kw["embd_pdrop"] == kw["resid_pdrop"] == kw["attn_pdrop"] == 0.0
    assert configs.SHAPEFORMER_SCALE["transformer_opt"]["kwargs"][
        "attn_pdrop"] == 0.01                    # the shared dict is untouched
