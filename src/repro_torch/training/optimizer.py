"""AdamW of the port, as the JAX package's ``training/optimizer.py``: a
warmup + cosine schedule evaluated at ``step + 1``, a global-norm
gradient clip, f32 moments, decoupled weight decay on every leaf.

Functional, like JAX's: ``update(grads, state, params)`` returns new
params and state and leaves its arguments as they were.  The arithmetic
is JAX's in f32 under ``torch.no_grad()``, each step a ``torch._foreach_*``
op over a run of leaves (``_groups``: the f32 temporaries stay at a
run's size); each new param is cast back to its param's dtype (there is
no f32 master copy, as in JAX).  That is about fifteen passes over the
leaves where a fused AdamW kernel would make one.
Plain PyTorch: JAX's update is jnp, no Pallas kernel.  ``zero1_specs``
gives the moments' ZeRO-1 specs, equal to JAX's; the sharded step
(``trainer.sharded_train_step``) runs ``update`` on each rank's shards,
with the global norm's sum of squares taken over the mesh (``sq_sum``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import tree as TR
from repro_torch.sharding.rules import P, map_with_shapes, stacked_shapes


def _f32(tensors):
    """``tensors`` in f32 (f32 ones as they are)."""
    return [t.to(torch.float32) for t in tensors]


def _groups(leaves, cap=1 << 28):
    """Runs of consecutive leaf indices of at most ``cap`` elements each
    (a larger leaf alone): the update's f32 temporaries are a run's."""
    runs, run, n = [], [], 0
    for i, t in enumerate(leaves):
        if run and n + t.numel() > cap:
            runs.append(run)
            run, n = [], 0
        run.append(i)
        n += t.numel()
    return runs + [run] if run else runs


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32: updates taken
    m: Any                    # f32, the params' structure
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    def schedule(self, step):
        """The learning rate at ``step`` (an int or a 0-d tensor), as an
        f32 tensor: linear warmup over ``warmup_steps``, then a cosine
        from ``lr`` down to ``min_lr_frac * lr`` at ``total_steps``."""
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = TR.leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=TR.tree_map(zeros, params),
                          v=TR.tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *, sq_sum=None):
        """One AdamW step.  Returns (new params, new state, {"grad_norm":
        the raw global norm before the clip, "lr"}), all on the device
        (no host sync).

        sq_sum: on shards, a function of the leaves' squared norms (in
        leaf order) that returns the global sum of squares (each leaf's
        summed over the mesh axes it is sharded on); None: their sum."""
        step = state.step + 1
        leaves = [TR.leaves(t) for t in (grads, state.m, state.v, params)]
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                 for g in leaves[0]]
        squares = [n.square() for n in norms]
        gn = torch.sqrt(sum(squares) if sq_sum is None else sq_sum(squares))
        scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
        lr = self.schedule(step)
        stepf = step.to(torch.float32)
        b1c = 1 - self.b1 ** stepf
        b2c = 1 - self.b2 ** stepf
        cols = ([], [], [])
        for idx in _groups(leaves[3]):
            out = self._step_leaves(*([t[i] for i in idx] for t in leaves),
                                    scale, lr, b1c, b2c)
            for col, part in zip(cols, out):
                col.extend(part)
        new_p, new_m, new_v = (TR.unflatten_like(params, iter(col))
                               for col in cols)
        return new_p, AdamWState(step=step, m=new_m, v=new_v), \
            {"grad_norm": gn, "lr": lr}

    def _step_leaves(self, g, m, v, p, scale, lr, b1c, b2c):
        """JAX's per-leaf arithmetic in f32 on lists of leaves, each line
        one multi-tensor op over them, out of place (the arguments stay as
        they were).  Returns (new params, m, v)."""
        g = torch._foreach_mul(_f32(g), scale)
        m = torch._foreach_mul(m, self.b1)
        torch._foreach_add_(m, g, alpha=1 - self.b1)
        v = torch._foreach_mul(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.b2)
        del g
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        delta = torch._foreach_div(m, b1c)
        torch._foreach_div_(delta, den)
        del den
        p32 = _f32(p)
        torch._foreach_add_(delta, p32, alpha=self.weight_decay)
        torch._foreach_mul_(delta, -lr)
        torch._foreach_add_(delta, p32)       # p - lr * delta
        return [n.to(t.dtype) for n, t in zip(delta, p)], m, v


def zero1_specs(param_specs, params, mesh) -> Any:
    """Optimizer-moment specs (ZeRO-1): each parameter spec plus 'data' on
    the first dim that is unsharded and divisible by the data axis, as
    JAX's.  ``param_specs`` is ``sharding.param_specs(params, mesh)``, in
    JAX's stacked layout: on a stack's (G, ...) shape the first such dim
    can be the group axis (every moment of a block of whole groups on one
    data rank)."""
    if "data" not in mesh.axis_names:
        return param_specs
    dsz = mesh.shape["data"]

    def f(spec, shape):
        entries = list(spec) + [None] * (len(shape) - len(spec))
        used = {n for e in entries if e is not None
                for n in (e if isinstance(e, tuple) else (e,))}
        if "data" in used:          # FSDP already spreads over data
            return P(*entries)
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % dsz == 0 and dim >= dsz:
                entries[i] = "data"
                break
        return P(*entries)
    return map_with_shapes(f, param_specs, stacked_shapes(params))
