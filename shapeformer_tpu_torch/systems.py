"""Training system of the conditional transformer: optimizer and step logic
around the pure model (shapeformer_tpu/systems.py::ShapeFormerSystem).

    system = build_trainer()                       # flagship, on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    metrics = system.train_step({"Xct": xct, "Xbd": xbd}, gen)

AdamW(0.9, 0.95), eps 1e-8, weight decay 0.01 on the Linear weights only
(the JAX package's `kernel` leaves; biases, LayerNorm, embeddings and the
positional tables do not decay), the StepLR schedule of `optim_opt` and
optional clipping by the global gradient norm.  The frozen VQDIF tokenizes
inside the loss, without gradients.  The optimizer is torch.optim.AdamW: the
JAX package takes optax's, no kernel of its own.  Building a system sets
both process-wide TF32 switches to False, as serve's entry does: matmuls and
convolutions run in full f32.
"""
from __future__ import annotations

import copy
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import configs, serve
from .models.shapeformer.shapeformer import ShapeFormer


def step_lr_schedule(lr: float, optim_opt: dict, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """StepLR as a function of the step: lr * gamma^(epoch // step_size) with
    epoch = step // steps_per_epoch; a constant without a scheduler."""
    sched = (optim_opt or {}).get("scheduler", "None")
    if sched == "StepLR":
        step_size = int(optim_opt["step_size"])
        gamma = float(optim_opt["gamma"])

        def fn(step: int) -> float:
            epoch = step // max(steps_per_epoch, 1)
            return lr * gamma ** (epoch // step_size)
        return fn
    if sched in ("None", None):
        return lambda step: lr
    raise NotImplementedError(f"Can not use scheduler:{sched}")


def decay_split(module: nn.Module
                ) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """(decayed, not decayed) parameters: exactly the Linear weights decay."""
    decayed = {id(m.weight) for m in module.modules()
               if isinstance(m, nn.Linear)}
    params = list(module.parameters())
    return ([p for p in params if id(p) in decayed],
            [p for p in params if id(p) not in decayed])


class ShapeFormerSystem:
    """Train and eval steps of a ShapeFormer whose representer holds its
    frozen VQDIF.  State: the transformer's parameters, the optimizer and
    the step count."""

    def __init__(self, model: ShapeFormer, steps_per_epoch: int = 1000,
                 gradient_clip_val: float = 0.0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        optim_opt = model.optim_opt or {"lr": 1e-5}
        lr = float(optim_opt.get("lr", 1e-5))
        self._lr = step_lr_schedule(lr, optim_opt, steps_per_epoch)
        self.gradient_clip_val = float(gradient_clip_val or 0.0)
        decayed, plain = decay_split(model.transformer)
        self.optimizer = torch.optim.AdamW(
            [dict(params=decayed, weight_decay=0.01),
             dict(params=plain, weight_decay=0.0)],
            lr=lr, betas=(0.9, 0.95), eps=1e-8)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.model.transformer.pos_emb.device

    def device_batch(self, batch: dict) -> dict:
        """The batch's arrays as tensors on the model's device."""
        return {k: torch.as_tensor(np.asarray(v, np.float32)
                                   if isinstance(v, np.ndarray) else v,
                                   device=self.device)
                for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    def apply_gradients(self) -> float:
        """One optimizer update from the gradients the parameters hold:
        clipping, the schedule's rate for this step, AdamW.  Returns the
        learning rate it used."""
        if self.gradient_clip_val > 0:
            nn.utils.clip_grad_norm_(self.model.transformer.parameters(),
                                     self.gradient_clip_val)
        lr = self._lr(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr

    def train_step(self, batch: dict, generator: torch.Generator,
                   on_phase: Optional[Callable[[str], None]] = None) -> dict:
        """One update on a batch {Xct (B, N, 3), Xbd (B, M, 3)}.  Returns
        {loss (0-d tensor), lr}.  The gradients stay on the parameters until
        the next step.  on_phase(name), when given, is called after
        'tokenize', 'forward', 'backward' and 'optimizer'."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss(self.device_batch(batch), generator,
                               stage="train", on_phase=on_phase)
        if on_phase is not None:
            on_phase("forward")
        loss.backward()
        if on_phase is not None:
            on_phase("backward")
        lr = self.apply_gradients()
        if on_phase is not None:
            on_phase("optimizer")
        return dict(loss=loss.detach(), lr=lr)

    def eval_step(self, batch: dict) -> dict:
        """{loss} at stage 'val': no condition thinning, no dropout, no
        gradients."""
        with torch.no_grad():
            return dict(loss=self.model.loss(self.device_batch(batch),
                                             stage="val"))


def train_options(shapeformer_opt: Optional[dict] = None) -> dict:
    """ShapeFormer options for training with the attention kernels: the
    given options (flagship by default) with flash_attn on and the yaml's
    three dropouts (0.01 each) at 0.  The kernels have no dropout, and the
    JAX package too takes its kernel in training only with flash_attn on and
    attn_pdrop 0."""
    opt = copy.deepcopy(shapeformer_opt or configs.SHAPEFORMER_SCALE)
    opt["transformer_opt"]["kwargs"].update(
        flash_attn=True, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    return opt


def build_trainer(device="cuda", seed: int = 0,
                  vqdif_opt: Optional[dict] = None,
                  shapeformer_opt: Optional[dict] = None,
                  steps_per_epoch: int = 1000,
                  gradient_clip_val: float = 0.0) -> ShapeFormerSystem:
    """A ShapeFormerSystem on `device` with seeded random weights and a
    frozen seeded VQDIF.  shapeformer_opt defaults to train_options()."""
    sf = serve.build_completer(device, seed=seed, vqdif_opt=vqdif_opt,
                               shapeformer_opt=(shapeformer_opt
                                                or train_options()))
    for p in sf.representer.vqdif.parameters():
        p.requires_grad_(False)
    return ShapeFormerSystem(sf, steps_per_epoch, gradient_clip_val)
