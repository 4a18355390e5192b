"""PyTorch + CUDA port of shapeformer_tpu for NVIDIA Hopper (H100).

The JAX package `shapeformer_tpu` is the reference; this package imports
nothing of it.  Layout mirrors the reference package where that helps a
reader (ops/, models/vqdif/, models/shapeformer/); grids keep its (B, X, Y,
Z, C) layout at public functions.  `serve.complete` is the completion entry
point and `systems.build_trainer` the training one.  On CUDA tensors the
encoder's segment pooling (csrc/segment_pool.cu) and the training forward's
attention (csrc/attention.cu, forward and backward) run hand-written CUDA
kernels.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without it raises: the port never falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available; pass "
                           "device='cpu' to run on the CPU")
    return device
