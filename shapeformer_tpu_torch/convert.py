"""JAX package variables -> the port's state_dict.

Input: the nested dicts of numpy arrays of a flax variable tree, e.g.
{'params': ..., 'vq': ...}.  The port's submodules carry the flax module
names (encoder.block0.fc_0, stages_0_3.attn.qkv, ...), so a key is the
module path and only the leaves change:
  - Dense kernel (in, out)                 -> Linear weight (out, in);
  - Conv kernel (kx, ky, kz, Cin, Cout)    -> Conv3d weight (Cout, Cin, kx,
    ky, kz), for the port's channels-first permute of (B, X, Y, Z, C);
  - LayerNorm / GroupNorm scale            -> weight; bias -> bias;
  - Embed embedding                        -> weight;
  - 'vq' codebook                          -> the quantizer's codebook buffer
    (the EMA statistics N and z_avg are training state, not carried).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

_VQ_CARRIED = ("codebook",)


def _leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 5:
            return "weight", np.transpose(value, (4, 3, 0, 1, 2))
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    return name, value


def convert_variables(variables: dict) -> Dict[str, np.ndarray]:
    """Flax variable tree (numpy leaves) -> flat port state_dict entries
    (views of the inputs where a layout change allows)."""
    out = {}

    def walk(tree, path, collection):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,), collection)
                continue
            if collection == "vq":
                if key not in _VQ_CARRIED:
                    continue
                name, arr = key, value
            else:
                name, arr = _leaf(key, np.asarray(value))
            out[".".join(path + (name,))] = arr

    for collection, tree in variables.items():
        if collection not in ("params", "vq"):
            raise ValueError(f"unknown variable collection {collection!r}")
        walk(tree, (), collection)
    return out


def load_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Load converted JAX variables into `module` (strict: every key of the
    module must be present and no other)."""
    sd = {k: torch.from_numpy(v.copy())
          for k, v in convert_variables(variables).items()}
    module.load_state_dict(sd, strict=True)
    return module
