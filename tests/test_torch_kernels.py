"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode) and
skip elsewhere.  The file imports neither JAX nor the JAX package, so it
also runs on a machine with PyTorch alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py
"""
import pytest
import torch

from shapeformer_tpu_torch.ops import scatter
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
