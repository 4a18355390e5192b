"""The port's attention op on the CPU: its plain forward against the bundled
JAX reference of the Pallas TPU flash kernel (mha_reference, with key
validity as kv segment ids), its hand-written backward against jax.grad of
mha_reference_no_custom_vjp and against autograd through the port's torch-op
attention, bf16 inputs against f32, and what the wrapper refuses.  All in
f32 on a few dozen keys: sums differ only in their order, hence rtol 1e-5
forward and 1e-4 for gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, mha_reference, mha_reference_no_custom_vjp)

from shapeformer_tpu.models.shapeformer.transformer.mingpt import (
    CausalSelfAttention as JCausalSelfAttention)
from shapeformer_tpu_torch.models.shapeformer.transformer import mingpt
from shapeformer_tpu_torch.ops.attention import (
    CausalAttention, attention_backward_plain, attention_plain)

B, H, D = 2, 2, 64
SIZES = [8, 77, 130]


def _inputs(T, seed=0, with_valid=True):
    """q, k, v (B, T, H, D), w (B, T, H * D), key_valid (B, T) with key 0
    valid, as numpy."""
    rng = np.random.default_rng(seed + T)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for _ in range(3))
    w = rng.normal(size=(B, T, H * D)).astype(np.float32)
    valid = rng.uniform(size=(B, T)) > 0.3
    valid[:, 0] = True
    valid[1, T // 2:] = False                    # a padded tail
    return q, k, v, w, (valid if with_valid else None)


def _jax_args(q, k, v, valid):
    to_bhtd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    kv = np.ones(q.shape[:2], np.int32) if valid is None else valid
    seg = SegmentIds(q=jnp.ones(q.shape[:2], jnp.int32),
                     kv=jnp.asarray(kv, jnp.int32))
    return to_bhtd(q), to_bhtd(k), to_bhtd(v), seg


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("T", SIZES)
def test_plain_forward_matches_jax_reference(T, with_valid):
    q, k, v, _, valid = _inputs(T, with_valid=with_valid)
    jq, jk, jv, seg = _jax_args(q, k, v, valid)
    want = mha_reference(jq, jk, jv, None, segment_ids=seg, causal=True,
                         sm_scale=1.0 / np.sqrt(D))
    o, lse = attention_plain(_t(q), _t(k), _t(v), _t(valid))
    assert o.shape == (B, T, H, D) and lse.shape == (B, H, T)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=1e-5, atol=1e-5)
    got = CausalAttention()(_t(q), _t(k), _t(v), _t(valid))
    assert got.shape == (B, T, H * D)
    np.testing.assert_array_equal(got.numpy(), o.reshape(B, T, H * D).numpy())


@pytest.mark.parametrize("T", SIZES)
def test_function_gradients_match_jax_grad(T):
    """Gradients of (O * W).sum() through the autograd.Function's
    hand-written backward == jax.grad of the reference without custom VJP."""
    q, k, v, w, valid = _inputs(T)
    jq, jk, jv, seg = _jax_args(q, k, v, valid)
    jw = jnp.asarray(w).reshape(B, T, H, D).transpose(0, 2, 1, 3)

    def f(a, b, c):
        out = mha_reference_no_custom_vjp(a, b, c, None, segment_ids=seg,
                                          causal=True,
                                          sm_scale=1.0 / np.sqrt(D))
        return (out * jw).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)

    op = CausalAttention()
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    (op(tq, tk, tv, _t(valid)) * _t(w)).sum().backward()
    for got, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(),
                                   np.asarray(ref).transpose(0, 2, 1, 3),
                                   rtol=1e-4, atol=1e-5)
    assert op.launches == {"fwd": 0, "dkv": 0, "dq": 0}   # CPU: no kernel


@pytest.mark.parametrize("T", SIZES)
def test_function_matches_torch_op_attention(T):
    """Packed (B, T, 3C) projection views through the op == autograd through
    CausalSelfAttention's torch-op path with the training mask, outputs and
    gradients, on a module with the same weights."""
    q, k, v, w, valid = _inputs(T)
    x = np.random.default_rng(T).normal(size=(B, T, H * D)).astype(np.float32)
    attn = mingpt.CausalSelfAttention(H * D, H)
    gen = torch.Generator().manual_seed(T)
    with torch.no_grad():
        for p in attn.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    mask = (torch.ones(T, T, dtype=torch.bool).tril()[None, None]
            & _t(valid)[:, None, None, :])
    outs, grads = [], []
    for flash in (None, CausalAttention()):
        tx = _t(x).requires_grad_()
        y, _ = attn(tx, mask, _t(valid), flash)
        (y * _t(w)).sum().backward()
        outs.append(y.detach().numpy())
        grads.append([tx.grad.numpy()] + [p.grad.numpy().copy()
                                          for p in attn.parameters()])
        attn.zero_grad()
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-5)
    for got, want in zip(grads[1], grads[0]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T", SIZES)
def test_plain_forward_matches_jax_attend(T):
    """attention_plain == the JAX module's _attend with the training mask
    (finite NEG_INF masking): every row has a valid key, so they agree."""
    q, k, v, _, valid = _inputs(T)
    mask = (np.tril(np.ones((T, T), bool))[None, None]
            & valid[:, None, None, :])
    jattn = JCausalSelfAttention(n_embd=H * D, n_head=H)
    want = jattn.apply({}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), True,
                       method=JCausalSelfAttention._attend)
    o, _ = attention_plain(_t(q), _t(k), _t(v), _t(valid))
    np.testing.assert_allclose(o.reshape(B, T, H * D).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_backward_plain_matches_autograd_of_plain_forward():
    """The written-out backward formulas == autograd through the plain
    forward (the same function, differentiated by torch)."""
    q, k, v, w, valid = _inputs(77)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o, lse = attention_plain(tq, tk, tv, _t(valid))
    d_out = _t(w).reshape(o.shape)
    want = torch.autograd.grad((o * d_out).sum(), (tq, tk, tv))
    got = attention_backward_plain(tq.detach(), tk.detach(), tv.detach(),
                                   _t(valid), o.detach(), lse.detach(), d_out)
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("T", SIZES)
def test_bf16_inputs_match_f32_at_bf16_tolerance(T):
    """bf16 q, k, v: products and softmax stay f32, so the output is the f32
    result of the rounded inputs to one bf16 rounding (2^-7 relative).  The
    gradients also see a rounded output and a rounded upstream gradient, and
    sum those errors: they hold 2^-7 of the tensor's largest value."""
    q, k, v, w, valid = _inputs(T)
    op = CausalAttention()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = (_t(x).to(torch.bfloat16).to(dtype).requires_grad_()
                      for x in (q, k, v))
        y = op(tq, tk, tv, _t(valid))
        assert y.dtype == dtype
        (y.float() * _t(w)).sum().backward()
        res[dtype] = [y.detach().float()] + [t.grad.float()
                                             for t in (tq, tk, tv)]
    for got, want in zip(res[torch.bfloat16], res[torch.float32]):
        torch.testing.assert_close(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * float(want.abs().max()))


def test_row_without_valid_key_gets_zeros():
    q, k, v, _, _ = _inputs(8)
    valid = np.ones((B, 8), bool)
    valid[0, :3] = False                       # queries 0..2 of row 0 see none
    o, lse = attention_plain(_t(q), _t(k), _t(v), _t(valid))
    assert torch.isfinite(o).all()
    assert (o[0, :3] == 0).all() and torch.isinf(lse[0, :, :3]).all()
    assert (o[0, 3:] != 0).any()


@pytest.mark.parametrize("case", ["rank", "dtype", "head_dim", "key_valid",
                                  "strides", "mismatch"])
def test_wrapper_refuses_what_the_kernels_do_not_take(case):
    q, k, v, _, valid = (_t(x) for x in _inputs(8))
    op = CausalAttention()
    if case == "rank":
        args = (q[0], k[0], v[0], None)
    elif case == "dtype":
        args = (q.double(), k.double(), v.double(), valid)
    elif case == "head_dim":
        args = (q[..., :32], k[..., :32], v[..., :32], valid)
    elif case == "key_valid":
        args = (q, k, v, valid.float())
    elif case == "strides":
        args = (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid)
    else:
        args = (q, k[:, :4], v, valid)
    with pytest.raises(ValueError):
        op(*args)
    assert op.launches == {"fwd": 0, "dkv": 0, "dq": 0}
