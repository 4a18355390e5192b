"""Segment pooling over cell-sorted points: the encoder's hand CUDA kernel.

`SegmentPool` wraps csrc/segment_pool.cu, the port of the Pallas TPU kernel
shapeformer_tpu/ops/pallas_scatter.py::segmented_scan.  The TPU kernel is an
inclusive segmented scan; ops/scatter.py::_pg_core runs it forward and in
reverse and combines the two into every point's segment max or mean.  The
CUDA kernel computes that combined value directly: each segment is reduced
once and the pooled row written back to each of its members.

Beside it sit the plain PyTorch versions: `segment_pool_plain` (same
signature as the kernel's wrapper; the CPU path and the on-card reference)
and `segmented_scan_plain` (the TPU kernel's own semantics, for the tests).
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

MODES = {"max": 0, "mean": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segment_pool_plain(cs: torch.Tensor, offsets: torch.Tensor,
                       mode: str = "max") -> torch.Tensor:
    """(B, N, C) sorted features, (S + 1,) int32 segment offsets over the
    B * N flattened rows -> (B, N, C): every row gets its segment's max or
    mean, accumulated in f32 and returned in the input dtype."""
    if mode not in MODES:
        raise ValueError(f"unknown pooling mode {mode!r}")
    B, N, C = cs.shape
    rows = B * N
    x = cs.reshape(rows, C).float()
    lengths = (offsets[1:] - offsets[:-1]).long()
    S = lengths.shape[0]
    seg_id = torch.repeat_interleave(
        torch.arange(S, device=cs.device), lengths, output_size=rows)
    if mode == "max":
        pooled = torch.full((S, C), float("-inf"), device=cs.device)
        pooled.scatter_reduce_(0, seg_id[:, None].expand(rows, C), x, "amax")
    else:
        pooled = torch.zeros((S, C), device=cs.device).index_add_(0, seg_id, x)
        pooled = pooled / lengths[:, None].float()
    return pooled[seg_id].reshape(B, N, C).to(cs.dtype)


def segmented_scan_plain(vals: torch.Tensor, seg_start: torch.Tensor,
                         mode: str = "max", reverse: bool = False
                         ) -> torch.Tensor:
    """Inclusive segmented scan along axis 1, the semantics of
    pallas_scatter.segmented_scan.  vals: (B, N, C); seg_start: (B, N) bool
    boundaries in scan direction (segment-END flags when reverse).  mode:
    'max' | 'sum'.  Sub-32-bit inputs scan in f32 and are cast back."""
    if mode not in ("max", "sum"):
        raise ValueError(f"unknown scan mode {mode!r}")
    out_dtype = vals.dtype
    x = vals.float()
    order = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    out = torch.empty_like(x)
    prev = None
    for i in order:
        cur = x[:, i]
        if prev is not None:
            joined = torch.maximum(prev, cur) if mode == "max" else prev + cur
            cur = torch.where(seg_start[:, i, None], cur, joined)
        out[:, i] = cur
        prev = cur
    return out.to(out_dtype)


class SegmentPool:
    """Callable wrapper of the segment_pool kernel with its launch count.

    A CPU tensor takes `segment_pool_plain`; a CUDA tensor launches the
    kernel on the current stream or raises.  `launches` counts kernel
    launches only."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cs: torch.Tensor, offsets: torch.Tensor,
                 mode: str = "max") -> torch.Tensor:
        if cs.device.type == "cpu":
            return segment_pool_plain(cs, offsets, mode)
        if cs.device.type != "cuda":
            raise ValueError(f"segment_pool: unsupported device {cs.device}")
        if mode not in MODES:
            raise ValueError(f"unknown pooling mode {mode!r}")
        if cs.dim() != 3 or cs.dtype not in _DTYPES:
            raise ValueError("segment_pool takes a (B, N, C) float32 or "
                             f"bfloat16 tensor, got {tuple(cs.shape)} "
                             f"{cs.dtype}")
        if not cs.is_contiguous():
            raise ValueError("segment_pool needs contiguous features")
        if (offsets.dtype != torch.int32 or offsets.dim() != 1
                or not offsets.is_contiguous()
                or offsets.device != cs.device or offsets.numel() < 2):
            raise ValueError("segment_pool needs (S + 1,) contiguous int32 "
                             "offsets on the features' device")
        B, N, C = cs.shape
        if B * N >= 2 ** 31:
            raise ValueError("segment_pool indexes rows with int32")
        lib = _library()
        out = torch.empty_like(cs)
        stream = torch.cuda.current_stream(cs.device).cuda_stream
        err = lib.segment_pool_launch(
            cs.data_ptr(), offsets.data_ptr(), offsets.numel() - 1, C,
            MODES[mode], _DTYPES[cs.dtype], out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("segment_pool launch failed: "
                               + lib.segment_pool_error_string(err).decode())
        self.launches += 1
        return out


def _library() -> ctypes.CDLL:
    lib = kernels.load("segment_pool")
    lib.segment_pool_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.segment_pool_launch.restype = ctypes.c_int
    lib.segment_pool_error_string.argtypes = [ctypes.c_int]
    lib.segment_pool_error_string.restype = ctypes.c_char_p
    return lib
