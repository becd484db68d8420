"""The train step of the port: loss -> gradients -> AdamW, with remat and
gradient accumulation over microbatches, as the JAX package's
``training/trainer.py::make_train_step``.  JAX hands its step to jit;
the port runs it eagerly (the kernels it reaches on CUDA are the
training forward's: flash, the selective scan, and the f32-output
products, each with a gradient route).

``sharded_train_step`` is the counterpart of JAX's ``jit_train_step``
(the step on params and moments placed by ``sharding.param_specs`` and
``optimizer.zero1_specs``): one process a mesh rank, params and moments
DTensors, every kernel on the rank's local shards, and the collectives
explicit (``sharding.collectives``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree as TR
from repro_torch.models.model import Model
from repro_torch.sharding.collectives import Parallel, data_dim, entry_axes
from repro_torch.sharding.execute import (axes_view, flat, rewrap, unflat,
                                          zeros_tree)
from repro_torch.sharding.rules import placements
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

    # what ``sharded_train_step`` reads
    train_step.model, train_step.opt = model, opt
    train_step.remat, train_step.grad_accum = remat, grad_accum
    return train_step


def _spec_axes(spec):
    return {a for e in spec for a in entry_axes(e)}


def init_sharded(opt: AdamW, params, opt_specs, dmesh) -> AdamWState:
    """AdamW's initial state for sharded params (a DTensor tree in JAX's
    stacked layout): step 0 and f32 zero moments placed by ``opt_specs``,
    each rank making its own shards only."""
    leaf = TR.leaves(params)[0]
    device = leaf.to_local().device
    shapes = TR.tree_map(lambda t: tuple(t.shape), params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=zeros_tree(opt_specs, shapes, dmesh, device=device),
        v=zeros_tree(opt_specs, shapes, dmesh, device=device))


def _model_params(live, pspec, stacks):
    """The port's param tree over this rank's shards: each stack's group
    g a dict of views ``leaf[g]``, except a leaf whose spec puts a data
    axis on the group axis (FSDP's fallback), which every group gets
    whole (its block of groups; ``Parallel.gather_group`` gathers it and
    takes group g)."""
    top, stk = {}, {}
    for path, t in live.items():
        if path[0] in stacks:
            stk.setdefault(path[0], {})[path[1:]] = t
        else:
            top[path] = t
    out = unflat(top)
    for name, leaves in stk.items():
        whole = {p for p in leaves
                 if (data_dim(pspec[(name,) + p]) or (None,))[0] == 0}
        n = next(t.shape[0] for p, t in leaves.items() if p not in whole)
        out[name] = [unflat({p: t if p in whole else t[g]
                             for p, t in leaves.items()})
                     for g in range(n)]
    return out


def sharded_train_step(train_step, dmesh, param_specs, opt_specs,
                       batch_specs) -> Callable:
    """The step of ``make_train_step`` on sharded params and moments: the
    counterpart of JAX's ``jit_train_step(train_step, mesh,
    param_shardings, opt_shardings, batch_shardings)``.

    Returns ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``: params a DTensor tree in JAX's stacked
    layout placed by ``param_specs`` (``sharding.shard_tree``), opt_state
    an ``AdamWState`` whose moments are placed by ``opt_specs``
    (``zero1_specs``, or ``param_specs`` for no ZeRO-1;
    ``init_sharded``), batch this rank's rows
    (``sharding.shard_batch(batch, dmesh, grad_accum)`` or
    ``SyntheticLM(..., mesh=, grad_accum=)``); ``batch_specs``
    (``input_specs_tree``) must split the batch over every data axis of
    the mesh.  Each rank runs ``split_microbatches`` unchanged on its
    rows, which with ``grad_accum`` > 1 are its block of every global
    microbatch in turn: its microbatch i is its block of JAX's
    microbatch i, so each microbatch's masked mean counts JAX's tokens.
    The metrics are the global ones, equal on every rank.

    A step: the model (``Model(par=Parallel(...))``) runs on the local
    shards, all-gathering FSDP leaves a group at a time, and gives the
    gradient of this rank's share of the global loss; then each leaf's
    gradient is summed over the data axes: already, by the FSDP gather's
    reduce-scatter, for a leaf sharded over data; reduce-scattered into
    the moments' shard where ZeRO-1 shards the moments and not the param;
    all-reduced otherwise.  The clip's global norm sums each leaf's
    squares over the axes its gradient is sharded on, never over an axis
    it is replicated on.  AdamW runs on the local shards (``foreach``);
    a ZeRO-1 leaf's updated shard is all-gathered back to the param's
    placement.

    The step is ``step.apply(params, opt_state,
    *step.value_and_grad(params, batch))``: ``value_and_grad`` gives (the
    global loss, the gradients summed over the data axes as DTensors
    placed like the moments), ``apply`` the update."""
    model, opt = train_step.model, train_step.opt
    remat, grad_accum = train_step.remat, train_step.grad_accum
    mesh = axes_view(dmesh)
    par = Parallel(dmesh, param_specs)
    data_axes = par.data_axes
    split = entry_axes(batch_specs["labels"][0])
    missing = [a for a in par.live_axes(data_axes) if a not in split]
    if missing:
        raise ValueError(f"the batch must split over every data axis of "
                         f"the mesh; it does not over {missing}")
    pmodel = dataclasses.replace(model, par=par)
    pspec, ospec = flat(param_specs), flat(opt_specs)
    order = sorted(pspec)
    plan = {}
    for path in order:
        ps, os_ = pspec[path], ospec[path]
        p_ax, m_ax = _spec_axes(ps), _spec_axes(os_)
        plan[path] = dict(
            reduce=tuple(a for a in data_axes if a not in p_ax | m_ax),
            zero=data_dim(os_, tuple(a for a in data_axes
                                     if a not in p_ax)),
            norm=par.live_axes(tuple(a for a in mesh.axis_names
                                      if a in m_ax)))

    def grads_of(live, batch):
        leaves = [live[k] for k in order]
        loss = pmodel.loss(_model_params(live, pspec, ("stack",
                                                       "enc_stack")),
                           batch, remat=remat)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, gs)]

    def sq_sum(squares):
        sets = {}
        for path, sq in zip(order, squares):
            sets.setdefault(plan[path]["norm"], []).append(sq)
        keys = list(sets)
        vec = torch.stack([torch.stack(sets[k]).sum() for k in keys])
        for a in par.live_axes(mesh.axis_names):
            flags = [a in k for k in keys]
            if any(flags):
                mask = torch.tensor(flags, device=vec.device)
                vec = torch.where(mask, par.all_reduce(vec * mask, a), vec)
        return vec.sum()

    def value_and_grad(params, batch):
        """(the global loss, the gradients summed over the data axes, as
        DTensors placed like the moments), without an update."""
        from torch.distributed.tensor import DTensor
        fp = flat(params)
        live = {k: fp[k].to_local().detach().requires_grad_(True)
                for k in order}
        if grad_accum == 1:
            loss, grads = grads_of(live, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = [torch.zeros(live[k].shape, dtype=torch.float32,
                                 device=live[k].device) for k in order]
            for mb in split_microbatches(batch, grad_accum):
                l, g = grads_of(live, mb)
                loss = loss + l
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / grad_accum
            grads = [g / grad_accum for g in grads]
        out = {}
        with torch.no_grad():
            for k, g in zip(order, grads):
                pl = plan[k]
                if pl["reduce"]:
                    g = par.all_reduce(g, pl["reduce"])
                if pl["zero"]:
                    g = par.scatter_plain(g, *pl["zero"])
                out[k] = DTensor.from_local(g, dmesh,
                                            placements(ospec[k], mesh),
                                            run_check=False)
        return loss, unflat(out)

    @torch.no_grad()
    def apply(params, opt_state: AdamWState, loss, grads):
        """The AdamW update of ``value_and_grad``'s (loss, grads): on the
        moments' shards (a ZeRO-1 leaf's param cut to its data rank's
        block, the updated block all-gathered back)."""
        fp, fm, fv, fg = (flat(t) for t in (params, opt_state.m,
                                            opt_state.v, grads))
        p_loc = {}
        for k in order:
            p = fp[k].to_local()
            if plan[k]["zero"]:
                d, axes = plan[k]["zero"]
                size = p.shape[d] // par.size(axes)
                p = p.narrow(d, par.coord(axes) * size, size)
            p_loc[k] = p
        state = AdamWState(step=opt_state.step,
                           m={k: fm[k].to_local() for k in order},
                           v={k: fv[k].to_local() for k in order})
        new_p, new_s, om = opt.update({k: fg[k].to_local() for k in order},
                                      state, p_loc, sq_sum=sq_sum)
        out_p, out_m, out_v = {}, {}, {}
        for k in order:
            p = new_p[k]
            if plan[k]["zero"]:
                p = par.gather_plain(p, *plan[k]["zero"]).contiguous()
            out_p[k] = rewrap(p, fp[k])
            out_m[k] = rewrap(new_s.m[k], fm[k])
            out_v[k] = rewrap(new_s.v[k], fv[k])
        return (unflat(out_p),
                AdamWState(step=new_s.step, m=unflat(out_m),
                           v=unflat(out_v)),
                {"loss": loss, **om})

    def step(params, opt_state: AdamWState, batch):
        return apply(params, opt_state, *value_and_grad(params, batch))

    step.value_and_grad, step.apply = value_and_grad, apply
    return step
