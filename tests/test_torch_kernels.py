"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and
skip elsewhere.  The file imports neither JAX nor the JAX package, so it
also runs on a machine with PyTorch alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""
import pytest
import torch

from shapeformer_tpu_torch.ops import scatter
from shapeformer_tpu_torch.ops.attention import (
    CausalAttention, attention_backward_plain, attention_plain)
from shapeformer_tpu_torch.ops.segment_pool import (
    SegmentPool, segment_pool_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_pool_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel == its plain version on the card: max exact, mean at
    rtol 1e-5 in f32 (another summation order) and one bf16 step in bf16;
    each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = SegmentPool()
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-6))
    for B, N, cells in ((1, 16384, 64 ** 3), (4, 16384, 64 ** 3),
                        (1, 1000, 17), (1, 4097, 1)):
        ids = torch.randint(0, cells, (B, N), device="cuda", generator=gen)
        plan = scatter.pool_plan(ids)
        c = torch.randn(B, N, 32, device="cuda", generator=gen).to(dtype)
        cs = torch.gather(c, 1, plan["perm"][..., None].expand(-1, -1, 32))
        cs = cs.contiguous()
        for mode in ("max", "mean"):
            got = pool(cs, plan["offsets"], mode)
            want = segment_pool_plain(cs, plan["offsets"], mode)
            torch.cuda.synchronize()
            if mode == "max":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, **tol)
    assert pool.launches == 8


@pytest.mark.cuda
def test_segment_pool_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    pool = SegmentPool()
    plan = scatter.pool_plan(torch.zeros((1, 64), dtype=torch.long,
                                         device="cuda"))
    c = torch.randn(1, 64, 32, device="cuda")
    with pytest.raises(ValueError):
        pool(c.double(), plan["offsets"], "max")
    with pytest.raises(ValueError):
        pool(c.transpose(1, 2), plan["offsets"], "max")
    with pytest.raises(ValueError):
        pool(c, plan["offsets"].long(), "max")
    assert pool.launches == 0


def _attention_inputs(B, T, H, dtype, with_valid, gen):
    """Views of a packed (B, T, 3 * H * 64) projection, an upstream gradient
    and a key mask whose key 0 is valid and whose tail is padding."""
    qkv = torch.randn(B, T, 3 * H * 64, device="cuda", generator=gen).to(dtype)
    q, k, v = (x.view(B, T, H, 64) for x in qkv.split(H * 64, dim=-1))
    d_out = torch.randn(B, T, H, 64, device="cuda", generator=gen).to(dtype)
    valid = None
    if with_valid:
        valid = torch.rand(B, T, device="cuda", generator=gen) > 0.3
        valid[:, 0] = True
        valid[-1, T // 2:] = False
    return q, k, v, d_out, valid


def _attention_tol(dtype, want):
    """f32: another summation order (rtol 1e-4, atol 1e-5).  bf16: one
    rounding of the result, 2^-7 of the tensor's largest value."""
    if dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-5)
    return dict(rtol=2 ** -7, atol=2 ** -7 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 811, 4), (1, 43, 2), (2, 64, 1),
                                   (1, 130, 3)])
def test_attention_kernels_match_plain_on_card(shape, dtype, with_valid):
    """Forward, dQ (with delta) and dK/dV kernels == their plain versions at
    the training length T = 811 and at small ragged lengths; each launch
    counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    B, T, H = shape
    gen = torch.Generator(device="cuda").manual_seed(T)
    q, k, v, d_out, valid = _attention_inputs(B, T, H, dtype, with_valid, gen)
    op = CausalAttention()
    o, lse = op.forward(q, k, v, valid)
    o_want, lse_want = attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_want.float(),
                               **_attention_tol(dtype, o_want.float()))
    torch.testing.assert_close(lse, lse_want, rtol=1e-5, atol=1e-5)
    # backward from the plain forward's o and lse, so each kernel is held to
    # the same inputs as its plain version
    want = attention_backward_plain(q, k, v, valid, o_want, lse_want, d_out)
    dq, delta = op.backward_dq(q, k, v, valid, o_want, lse_want, d_out)
    dk, dv = op.backward_dkv(q, k, v, valid, d_out, lse_want, delta)
    torch.cuda.synchronize()
    delta_want = (d_out.float() * o_want.float()).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, delta_want, rtol=1e-4, atol=1e-4)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.float(), ref.float(),
                                   **_attention_tol(dtype, ref.float()))
    assert op.launches == {"fwd": 1, "dkv": 1, "dq": 1}


@pytest.mark.cuda
def test_attention_function_gradients_on_card():
    """The autograd.Function on the card, f32, small: gradients of a random
    projection of the output == autograd through the plain forward, and a
    central difference of the kernel's own forward along a random direction
    agrees with them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, w, valid = _attention_inputs(2, 43, 2, torch.float32, True, gen)
    op = CausalAttention()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (op(*leaves, valid) * w.flatten(2)).sum().backward()
    refs = [x.clone().requires_grad_() for x in (q, k, v)]
    (attention_plain(*refs, valid)[0] * w).sum().backward()
    for got, ref in zip(leaves, refs):
        torch.testing.assert_close(got.grad, ref.grad, rtol=1e-4, atol=1e-5)
    assert op.launches == {"fwd": 1, "dkv": 1, "dq": 1}
    dirs = [torch.randn(x.shape, device="cuda", generator=gen)
            for x in (q, k, v)]
    eps = 1e-2
    with torch.no_grad():
        plus = (op(*(x + eps * d for x, d in zip((q, k, v), dirs)), valid)
                * w.flatten(2)).double().sum()
        minus = (op(*(x - eps * d for x, d in zip((q, k, v), dirs)), valid)
                 * w.flatten(2)).double().sum()
    numeric = float(plus - minus) / (2 * eps)
    analytic = float(sum((x.grad.double() * d.double()).sum()
                         for x, d in zip(leaves, dirs)))
    assert abs(numeric - analytic) <= 1e-2 * max(abs(analytic), 1.0)


@pytest.mark.cuda
def test_attention_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, d_out, valid = _attention_inputs(1, 16, 2, torch.float32, True,
                                              gen)
    op = CausalAttention()
    with pytest.raises(ValueError):
        op(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError):
        op(q, k.contiguous(), v, valid)                 # other strides
    with pytest.raises(ValueError):
        op(q, k, v, valid.cpu())
    o, lse = attention_plain(q, k, v, valid)
    with pytest.raises(ValueError):
        op.backward_dq(q, k, v, valid, o, lse, d_out.transpose(1, 2))
    assert op.launches == {"fwd": 0, "dkv": 0, "dq": 0}
