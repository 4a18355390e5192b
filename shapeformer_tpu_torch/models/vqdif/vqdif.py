"""VQDIF: point cloud -> VQ index grid -> implicit occupancy, inference path
(shapeformer_tpu/models/vqdif/vqdif.py).

Built from the same option dicts as the JAX package ({'class', 'kwargs'});
a class is looked up by its last dotted name among the port's modules.
Clouds come in [-1, 1] and are halved before the encoder, as the reference
does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...ops import sparse as sparse_ops
from .dec import LocalDecoder
from .enc import LocalPoolPointnet
from .quantizer import Quantizer

_COMPONENTS = {cls.__name__: cls
               for cls in (LocalPoolPointnet, LocalDecoder, Quantizer)}


def build_component(opt: Optional[dict]) -> Optional[nn.Module]:
    if opt is None or opt.get("class") is None:
        return None
    name = opt["class"].rsplit(".", 1)[-1]
    if name not in _COMPONENTS:
        raise ValueError(f"{opt['class']} has no counterpart in the port")
    return _COMPONENTS[name](**(opt.get("kwargs") or {}))


class VQDIF(nn.Module):
    def __init__(self, encoder_opt: Optional[dict] = None,
                 decoder_opt: Optional[dict] = None,
                 quantizer_opt: Optional[dict] = None, vq_beta: float = 1.0,
                 Xct_as_Xbd: bool = False, optim_opt: Optional[dict] = None,
                 ckpt_path: Optional[str] = None, opt: Optional[dict] = None):
        super().__init__()
        self.encoder = build_component(encoder_opt)
        self.decoder = build_component(decoder_opt)
        self.quantizer = build_component(quantizer_opt)

    def encode(self, Xbd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) in [-1, 1] -> (grid_feat, grid_mask)."""
        return self.encoder(Xbd / 2.0)

    def encode_quant(self, Xbd: torch.Tensor) -> dict:
        grid_feat, grid_mask = self.encode(Xbd)
        quant_feat, quant_ind = self.quantizer(grid_feat)
        return dict(quant_feat=quant_feat, quant_ind=quant_ind,
                    grid_mask=grid_mask)

    def quantize_cloud(self, cloud: torch.Tensor):
        """Encode + quantize; indices outside the occupancy mask become the
        batch mode (the 'empty' code).  Returns (quant_ind, mode, encoded)."""
        encoded = self.encode_quant(cloud)
        mode = sparse_ops.get_mode(encoded["quant_ind"],
                                   self.quantizer.vocab_size)
        quant_ind = torch.where(encoded["grid_mask"], encoded["quant_ind"],
                                mode)
        return quant_ind, mode, encoded

    def decode_index_grid(self, code_ind: torch.Tensor, out_res: int,
                          bbox=(-1.0, 1.0)) -> dict:
        """Logits on the regular out_res^3 lattice over bbox ('ij' scan
        order, as makeGrid): {'logits': (B, out_res^3, 1)}."""
        quant_feat = self.quantizer.get_code(code_ind)
        processed = self.decoder.process_grid(quant_feat)
        ax = torch.linspace(bbox[0], bbox[1], out_res,
                            device=code_ind.device) / 2.0
        return dict(logits=self.decoder.query_grid(processed, (ax, ax, ax)))
