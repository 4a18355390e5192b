"""Shape completion entry point: partial cloud -> sampled completion tokens
-> decoded occupancy logits.

`complete` has the flow of shapeformer_tpu/callbacks/shapeformer_vis.py::
VisShapeFormer.compute_batch without rendering or meshing: tokenize the
partial cloud with the frozen VQDIF, sample `sample_n` candidates (the
first pinned to the argmax), turn the tokens back into 16^3 index grids and
decode decode_res^3 occupancy logits for every candidate.  It returns the
same dict keys.  `build_completer` makes the flagship models (or any other
option dicts) with seeded random weights; `load_jax_variables` carries
trained JAX variables over.

    sf = build_completer()                     # flagship, on the card
    out = complete(sf, xct, name="chair")      # xct: (1, N, 3) in [-1, 1]
"""
from __future__ import annotations

import math
import zlib
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from . import configs, resolve_device
from .convert import load_variables
from .models.shapeformer.shapeformer import ShapeFormer
from .models.vqdif.quantizer import Quantizer
from .models.vqdif.updown import GN, Conv3dNB
from .models.vqdif.vqdif import VQDIF
from .ops import sparse as sparse_ops


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights: linear and conv kernels N(0, 1/fan_in),
    embeddings, positional tables and the codebook N(0, 0.02^2), biases 0,
    norm scales 1."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d, Conv3dNB)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=g)
            elif isinstance(m, (nn.LayerNorm, GN)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, Quantizer):
                m.codebook.normal_(0.0, 0.02, generator=g)
        for name, p in module.named_parameters(recurse=False):
            if name in ("pos_emb", "cond_pos_emb"):
                p.normal_(0.0, 0.02, generator=g)
    return module


def build_completer(device="cuda", seed: int = 0,
                    vqdif_opt: Optional[dict] = None,
                    shapeformer_opt: Optional[dict] = None) -> ShapeFormer:
    """The completion models (flagship options by default) on `device`,
    with seeded random weights, in eval mode."""
    device = resolve_device(device)
    with torch.device(device):
        vqdif = VQDIF(**(vqdif_opt or configs.VQDIF_RES16))
        sf = ShapeFormer(**(shapeformer_opt or configs.SHAPEFORMER_SCALE))
    init_weights(vqdif, seed)
    init_weights(sf.transformer, seed + 1)
    vqdif.eval()
    sf.transformer.eval()
    sf.representer.set_vqdif(vqdif)
    return sf


def load_jax_variables(sf: ShapeFormer, vqdif_variables: dict,
                       transformer_variables: dict) -> ShapeFormer:
    """Load JAX variable trees (numpy leaves) into a completer."""
    load_variables(sf.representer.vqdif, vqdif_variables)
    load_variables(sf.transformer, transformer_variables)
    return sf


def complete(sf: ShapeFormer, xct, name: str = "", *, sample_n: int = 4,
             top_k: int = 100, top_p: float = 0.4, temperature: float = 1.0,
             sample_max_step: int = 512, depth: int = 4,
             decode_res: int = 128,
             on_phase: Optional[Callable[..., None]] = None) -> dict:
    """Complete one (1, N, 3) partial cloud in [-1, 1].

    Runs on the device of the models.  The sampling generator is seeded
    from zlib.crc32(name), as compute_batch seeds its key.  Matmuls and
    convolutions run in full f32: both TF32 switches are set to False, so
    the quantizer's nearest-code choices are f32 choices.  on_phase(name,
    **info), when given, is called after each phase: 'tokenize', 'prefill',
    'ar_loop' (steps=...), 'decode'.  Returns samples / origin_samples
    (sample_n, L, 2), log_prob (sample_n,), c_ind (1, L_c, 2), empty_index,
    decoded_logits (sample_n, decode_res^3, 1) and batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = sf.representer
    device = rep.vqdif.quantizer.codebook.device
    xct = torch.as_tensor(np.asarray(xct, np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(
        zlib.crc32(name.encode()) % (2 ** 31))
    with torch.no_grad():
        c, _, _, others = rep.get_indices(xct)
        if on_phase is not None:
            on_phase("tokenize")
        out, raw, logp = sf.sample(
            c, gen, max_steps=sample_max_step, top_k=top_k, top_p=top_p,
            temperature=temperature, best_in_first=True, candidates=sample_n,
            on_phase=on_phase)
        dense = sparse_ops.sparse2dense(out, others["empty_index"], 2 ** depth)
        logits = rep.vqdif.decode_index_grid(dense, decode_res)["logits"]
        if on_phase is not None:
            on_phase("decode")
    return dict(samples=out, origin_samples=raw, log_prob=logp, c_ind=c,
                empty_index=int(others["empty_index"]),
                decoded_logits=logits, batch=dict(Xct=xct))
