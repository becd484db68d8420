"""The train step of the port: loss -> gradients -> AdamW, with remat and
gradient accumulation over microbatches, as the JAX package's
``training/trainer.py::make_train_step``.  JAX hands its step to jit;
the port runs it eagerly (the kernels it reaches on CUDA are the
training forward's: flash, the selective scan, and the f32-output
products, each with a gradient route).  ``jit_train_step``, the step on
sharded params and moments (``sharding.param_specs``,
``optimizer.zero1_specs``), is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as TR
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamW, AdamWState


def split_microbatches(batch, grad_accum: int):
    """``grad_accum`` microbatches of ``batch``, each a dict of slices:
    every input split on its leading (batch) axis, M-RoPE's (3, B, S)
    ``positions`` on axis 1, 0-d entries left whole -- JAX's split, whose
    microbatch i holds rows ``i * B / grad_accum`` onwards.  JAX picks
    axis 1 for any (3, ., .) input; the port picks it by the key, which
    differs only for a batch of 3 rows."""
    def part(key, x, i):
        if getattr(x, "ndim", 0) == 0:
            return x
        axis1 = key == "positions" and x.ndim == 3
        b = x.shape[1] if axis1 else x.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch of {b} rows is not divisible into "
                             f"{grad_accum} microbatches")
        mb = b // grad_accum
        return x[:, i * mb:(i + 1) * mb] if axis1 else x[i * mb:(i + 1) * mb]
    return [{k: part(k, x, i) for k, x in batch.items()}
            for i in range(grad_accum)]


def value_and_grad(model: Model, params, batch, *, remat: bool):
    """(loss, grads): the loss detached and its gradient for every param
    leaf, in the params' structure (zeros for a leaf the loss does not
    reach, as JAX gives)."""
    live = [p.detach().requires_grad_(True) for p in TR.leaves(params)]
    loss = model.loss(TR.unflatten_like(params, iter(live)), batch,
                      remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), TR.unflatten_like(params, iter(grads))


def make_train_step(model: Model, opt: AdamW, *, remat: bool = True,
                    grad_accum: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm", "lr"})``.  With ``grad_accum`` > 1
    the batch is split into microbatches (``split_microbatches``); their
    losses and f32 gradients are summed in order, then divided by
    ``grad_accum``, and one AdamW update follows: peak activation memory
    is a microbatch's.  Metrics stay on the device."""

    def train_step(params, opt_state: AdamWState, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(model, params, batch, remat=remat)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = TR.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in split_microbatches(batch, grad_accum):
                l, g = value_and_grad(model, params, mb, remat=remat)
                loss = loss + l
                grads = TR.tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = TR.tree_map(lambda g: g / grad_accum, grads)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step
