"""Causal softmax attention with key validity: the training forward's hand
CUDA kernels.

`CausalAttention` wraps csrc/attention.cu, the port of the three Pallas TPU
kernels behind shapeformer_tpu/models/shapeformer/transformer/mingpt.py::
_attend_flash (flash_attention forward, dK/dV backward, dQ backward).  For
batch row b, head h and query i, key j is attended iff j <= i and
key_valid[b, j]; queries are never masked.  The softmax and every sum are
f32; the scale is 1 / sqrt(D).

Layout: q, k, v are (B, T, H, D) with D = 64, f32 or bf16, and share one set
of strides with an innermost stride of 1: the kernels take the strides, so the
three views of a packed (B, T, 3 * H * D) projection go in without a copy.
Anything else raises.  The result is (B, T, H * D), as _attend_flash returns.

A query row without any attended key gets zeros, a log-sum-exp of -inf and
no gradient.  The training path never makes one: key 0 is always valid.

Beside the kernels sit their plain PyTorch versions, `attention_plain` and
`attention_backward_plain`: the CPU path, and the on-card reference.  A CUDA
tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .. import kernels

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _attended(T: int, key_valid: Optional[torch.Tensor], device
              ) -> torch.Tensor:
    """(1 or B, 1, T, T) bool: causal and key validity."""
    mask = torch.ones((T, T), dtype=torch.bool, device=device).tril()
    mask = mask[None, None]
    if key_valid is not None:
        mask = mask & key_valid[:, None, None, :]
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, key_valid):
    """f32 (B, H, T, T) scaled scores and the attended mask."""
    T, D = q.shape[1], q.shape[3]
    qh, kh = q.float().transpose(1, 2), k.float().transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    return s, _attended(T, key_valid, q.device)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, T, H, D), key_valid (B, T) bool or None -> (O (B, T, H, D)
    in the input dtype, L (B, H, T) f32 row log-sum-exp)."""
    s, mask = _scores(q, k, key_valid)
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    o = (p @ v.float().transpose(1, 2)).transpose(1, 2)
    return o.to(q.dtype).contiguous(), lse


def attention_backward_plain(q, k, v, key_valid, o, lse, d_out):
    """The backward formulas written out: from q, k, v, o, d_out (B, T, H, D)
    and lse (B, H, T) to (dq, dk, dv) in the input dtype."""
    s, mask = _scores(q, k, key_valid)
    scale = 1.0 / math.sqrt(q.shape[3])
    do = d_out.float().transpose(1, 2)                        # (B, H, T, D)
    delta = (do * o.float().transpose(1, 2)).sum(-1)          # (B, H, T)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.float().transpose(1, 2).transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dq = (ds @ k.float().transpose(1, 2)) * scale
    dk = (ds.transpose(-1, -2) @ q.float().transpose(1, 2)) * scale
    return tuple(t.transpose(1, 2).to(q.dtype).contiguous()
                 for t in (dq, dk, dv))


def _check(q, k, v, key_valid) -> None:
    if q.dim() != 4:
        raise ValueError(f"attention takes (B, T, H, D) tensors, got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention takes float32 or bfloat16, got {q.dtype}")
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"attention takes head width {HEAD_DIM}, got "
                         f"{q.shape[3]}")
    for name, t in (("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != q.stride()):
            raise ValueError(f"attention: {name} must have q's shape, dtype, "
                             f"device and strides")
    if q.stride(3) != 1:
        raise ValueError("attention needs an innermost stride of 1")
    if key_valid is not None and (
            key_valid.dtype != torch.bool or key_valid.device != q.device
            or tuple(key_valid.shape) != tuple(q.shape[:2])):
        raise ValueError("attention: key_valid must be a (B, T) bool tensor "
                         "on q's device")


class CausalAttention:
    """Callable attention op with its kernels' launch counts.

    `op(q, k, v, key_valid)` is differentiable.  CPU tensors take the plain
    versions, forward and backward; CUDA tensors launch the kernels on the
    current stream or raise.  `launches` counts kernel launches only, per
    kernel: 'fwd', 'dkv', 'dq'."""

    def __init__(self):
        self.launches = {"fwd": 0, "dkv": 0, "dq": 0}

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0

    def __call__(self, q, k, v, key_valid=None) -> torch.Tensor:
        """-> (B, T, H * D)."""
        return _Attention.apply(self, q, k, v, key_valid).flatten(2)

    # ------------------------------------------------------------ the kernels
    def forward(self, q, k, v, key_valid=None):
        """-> (O (B, T, H, D) contiguous, L (B, H, T) f32)."""
        _check(q, k, v, key_valid)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, key_valid)
        lib, common = _launch_args(q)
        B, T, H, _ = q.shape
        out = torch.empty((B, T, H, HEAD_DIM), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        kv = None if key_valid is None else key_valid.contiguous()
        _raise_on(lib, lib.attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv),
            out.data_ptr(), lse.data_ptr(), *common), "attention_fwd")
        self.launches["fwd"] += 1
        return out, lse

    def backward_dq(self, q, k, v, key_valid, o, lse, d_out):
        """-> (dq (B, T, H, D), delta (B, H, T) f32 = rowsum(d_out * o)); o
        and d_out contiguous (B, T, H, D).  CUDA only."""
        lib, common = _launch_args(q)
        _check_saved(q, (o, d_out), (lse,))
        dq = torch.empty_like(o)
        delta = torch.empty_like(lse)
        kv = None if key_valid is None else key_valid.contiguous()
        _raise_on(lib, lib.attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv), o.data_ptr(),
            d_out.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            *common), "attention_bwd_dq")
        self.launches["dq"] += 1
        return dq, delta

    def backward_dkv(self, q, k, v, key_valid, d_out, lse, delta):
        """-> (dk, dv) (B, T, H, D); delta from backward_dq.  CUDA only."""
        lib, common = _launch_args(q)
        _check_saved(q, (d_out,), (lse, delta))
        dk = torch.empty_like(d_out)
        dv = torch.empty_like(d_out)
        kv = None if key_valid is None else key_valid.contiguous()
        _raise_on(lib, lib.attention_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv),
            d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *common), "attention_bwd_dkv")
        self.launches["dkv"] += 1
        return dk, dv


class _Attention(torch.autograd.Function):
    """Forward saves q, k, v, o, lse; backward runs the two backward kernels
    on CUDA tensors and `attention_backward_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, op, q, k, v, key_valid):
        o, lse = op.forward(q, k, v, key_valid)
        ctx.op = op
        ctx.save_for_backward(q, k, v, o, lse, key_valid)
        return o

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, o, lse, key_valid = ctx.saved_tensors
        d_out = d_out.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = attention_backward_plain(q, k, v, key_valid, o, lse,
                                                  d_out)
        else:
            dq, delta = ctx.op.backward_dq(q, k, v, key_valid, o, lse, d_out)
            dk, dv = ctx.op.backward_dkv(q, k, v, key_valid, d_out, lse,
                                         delta)
        return None, dq, dk, dv, None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_saved(q, full, rows) -> None:
    """full: tensors like o and d_out; rows: per-row statistics."""
    B, T, H, D = q.shape
    for t in full:
        if (tuple(t.shape) != (B, T, H, D) or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError("attention backward needs contiguous (B, T, H, "
                             "D) tensors of q's dtype on q's device")
    for t in rows:
        if (tuple(t.shape) != (B, H, T) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError("attention backward needs contiguous (B, H, T) "
                             "float32 row statistics on q's device")


def _launch_args(q: torch.Tensor):
    """The library and the arguments every launch ends with."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernels run on CUDA tensors, got "
                         f"{q.device}")
    B, T, H, D = q.shape
    if B > 65535 or H > 65535:
        raise ValueError("attention: B and H index the launch grid and must "
                         "be below 65536")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return _library(), (B, T, H, q.stride(0), q.stride(1), q.stride(2),
                        1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.attention_error_string(err).decode())


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with its argument types set, made once."""
    lib = kernels.load("attention")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    tail = [i, i, i, i64, i64, i64, ctypes.c_float, i, p]
    lib.attention_fwd_launch.argtypes = [p] * 6 + tail
    lib.attention_bwd_dq_launch.argtypes = [p] * 9 + tail
    lib.attention_bwd_dkv_launch.argtypes = [p] * 9 + tail
    for fn in (lib.attention_fwd_launch, lib.attention_bwd_dq_launch,
               lib.attention_bwd_dkv_launch):
        fn.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [i]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib
