"""Executing the sharding specs: DTensor trees on a ``DeviceMesh``.

The specs (``rules.param_specs``, ``training.zero1_specs``) are in JAX's
stacked layout, so a sharded tree is too: each ``stack``/``enc_stack``
is one dict of (G, ...) leaves, as the JAX package holds its params, and
a group-axis entry in a spec shards whole groups (rank r of that axis
owns a contiguous block of them).  ``shard_tree`` builds such a tree of
DTensors from the port's params (its stacks lists of per-group dicts) or
from a stacked tree; ``gather_tree`` gathers it back to full tensors in
the port's layout.  A leaf's placements are ``rules.placements(spec)``.

``shard_tree`` needs no communication: every rank holds the same full
tensors (made from one seed, or read from one checkpoint) and keeps its
own shard (``distribute_tensor(..., src_data_rank=None)``).
``gather_tree`` gathers through ``collectives.Parallel``, the one door to
the process groups.

``plan_rank_tree`` is the plan runner's counterpart (one process a rank
of a ("stage", "data", "model") mesh): plain tensors, this rank's stage
only, each leaf its ``model`` shard.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.bridge import STACKS
from repro_torch.sharding.collectives import entry_axes
from repro_torch.sharding.rules import (batch_axes_for, param_specs,
                                        placements)


def axes_view(dmesh):
    """A ``DeviceMesh`` as the rules read a mesh: ``axis_names`` and
    ``shape[axis]``."""
    names = tuple(dmesh.mesh_dim_names)
    return SimpleNamespace(axis_names=names,
                           shape={a: dmesh.size(i)
                                  for i, a in enumerate(names)})


def _stack_groups(groups: List[Dict[str, Any]]):
    if isinstance(groups[0], dict):
        return {k: _stack_groups([g[k] for g in groups]) for k in groups[0]}
    return torch.stack(list(groups))


def stacked(tree):
    """The port's params (or any tree with ``stack`` lists) in JAX's
    stacked layout: each stack's groups as one dict of (G, ...) leaves.
    A tree already stacked is returned as it is."""
    if TR.is_namedtuple(tree):
        return type(tree)(*(stacked(x) for x in tree))
    if not isinstance(tree, dict):
        return tree
    return {k: (_stack_groups(v) if k in STACKS and isinstance(v, list)
                else stacked(v)) for k, v in tree.items()}


def _unstack(node, g):
    if isinstance(node, dict):
        return {k: _unstack(v, g) for k, v in node.items()}
    return node[g]


def unstacked(tree):
    """JAX's stacked layout back to the port's: each stack dict of (G,
    ...) leaves as a list of G per-group dicts (views)."""
    if TR.is_namedtuple(tree):
        return type(tree)(*(unstacked(x) for x in tree))
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in STACKS and isinstance(v, dict):
            n = TR.leaves(v)[0].shape[0]
            out[k] = [_unstack(v, g) for g in range(n)]
        else:
            out[k] = unstacked(v)
    return out


def flat(tree, path=()) -> Dict[Tuple[str, ...], Any]:
    """A dict tree as {path: leaf}, paths in sorted order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], path + (k,)))
        return out
    return {path: tree}


def unflat(items: Dict[Tuple[str, ...], Any]):
    """The inverse of ``flat``."""
    out: Dict[str, Any] = {}
    for path, leaf in items.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_leaf(t, spec, dmesh):
    """One full tensor as a DTensor placed by ``spec``: this rank keeps
    its own shard of it (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, dmesh, placements(spec, axes_view(dmesh)),
                             src_data_rank=None)


def shard_tree(tree, specs, dmesh):
    """DTensors placed by ``specs`` (JAX's stacked layout) on ``dmesh``,
    from full tensors in the port's layout or the stacked one.  Returns
    the stacked layout."""
    return _map2(lambda t, s: shard_leaf(t, s, dmesh), stacked(tree), specs)


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """A leaf's shard shape under ``spec``: each sharded dim divided by
    the product of its axes' sizes (the rules shard divisible dims only)."""
    out = list(shape)
    for d, e in enumerate(spec):
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            out[d] //= mesh.shape[a]
    return tuple(out)


def zeros_tree(specs, shapes, dmesh, dtype=torch.float32, device=None):
    """DTensors of zeros placed by ``specs``, of the global ``shapes`` (a
    tree of shapes in the same stacked layout): each rank makes its shard
    only."""
    from torch.distributed.tensor import DTensor
    mesh = axes_view(dmesh)

    def leaf(shape, spec):
        local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype,
                            device=device)
        return DTensor.from_local(local, dmesh, placements(spec, mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_stride(shape))
    return _map2(lambda shp, spec: leaf(tuple(shp), spec), shapes, specs)


def _stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def rewrap(local, like):
    """``local`` as a DTensor with ``like``'s mesh, placements and global
    shape."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=_stride(like.shape))


def gather_leaf(t, par=None):
    """A DTensor's full tensor, gathered through ``collectives``; any
    other leaf as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t
    from repro_torch.sharding.collectives import Parallel
    par = par or Parallel(t.device_mesh)
    out = t.to_local()
    names = par.axis_names
    for i in reversed(range(len(names))):
        p = t.placements[i]
        if isinstance(p, Shard):
            out = par.gather_plain(out, p.dim, names[i])
    return out.contiguous()


def gather_tree(tree):
    """Every DTensor of ``tree`` (dicts, lists, NamedTuples) as its full
    tensor, and JAX's stacked stacks back in the port's layout.  A
    collective: every rank of the mesh calls it."""
    from torch.distributed.tensor import DTensor
    cache = {}

    def leaf(t):
        if not isinstance(t, DTensor):
            return t
        key = id(t.device_mesh)
        if key not in cache:
            from repro_torch.sharding.collectives import Parallel
            cache[key] = Parallel(t.device_mesh)
        return gather_leaf(t, cache[key])
    return unstacked(TR.tree_map(leaf, tree))


def batch_rows(batch_size: int, mesh, coords, grad_accum: int = 1):
    """The rows of a global batch that the rank at ``coords`` (axis name
    -> index) takes, as a list of slices: ``batch_axes_for``'s axes split
    the batch in blocks, the first axis outer, as ``input_specs_tree``
    shards it.  With ``grad_accum`` > 1, the rank's block of each of the
    ``grad_accum`` microbatches that ``split_microbatches`` cuts from the
    global batch, in order: one slice a microbatch."""
    axes = batch_axes_for(mesh, batch_size) or ()
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    mb = batch_size // grad_accum
    if batch_size % grad_accum or mb % n:
        raise ValueError(f"a batch of {batch_size} rows in {grad_accum} "
                         f"microbatches does not split over {n} data ranks")
    rows = mb // n
    return [slice(i * mb + idx * rows, i * mb + (idx + 1) * rows)
            for i in range(grad_accum)]


def shard_batch(batch, dmesh, grad_accum: int = 1):
    """This rank's rows of a global batch (a dict of arrays or tensors):
    each leaf's batch axis (axis 1 of M-RoPE's (3, B, S) ``positions``,
    axis 0 otherwise) cut as ``input_specs_tree`` shards it, or with
    ``grad_accum`` > 1 as ``batch_rows`` cuts every microbatch."""
    mesh = axes_view(dmesh)
    coords = {a: dmesh.get_local_rank(a) for a in mesh.axis_names}

    def cut(key, x):
        if getattr(x, "ndim", 0) == 0:
            return x
        axis = 1 if key == "positions" and x.ndim == 3 else 0
        parts = [x[:, s] if axis else x[s] for s in
                 batch_rows(x.shape[axis], mesh, coords, grad_accum)]
        if len(parts) == 1:
            return parts[0]
        if torch.is_tensor(x):
            return torch.cat(parts, axis)
        return np.concatenate(parts, axis)
    return {k: cut(k, x) for k, x in batch.items()}


# ---------------------------------------------------------------------------
# a plan mesh's rank: its stage's groups, its model shards
# ---------------------------------------------------------------------------

FIRST_STAGE = ("embed",)
LAST_STAGE = ("final_norm", "head")


def _take(node, spec, par, device, lead=0):
    """``node``'s shard on this rank: each dim that ``spec`` (past its
    ``lead`` entries: a stack's group axis) shards, narrowed to this
    rank's block over the entry's axes, copied onto ``device`` as a
    tensor of its own (no view keeps the full tensor alive)."""
    if isinstance(node, dict):
        return {k: _take(v, spec[k], par, device, lead)
                for k, v in node.items()}
    t = node
    for d, e in enumerate(spec[lead:]):
        axes = entry_axes(e)
        if axes:
            n = t.shape[d] // par.size(axes)
            t = t.narrow(d, par.coord(axes) * n, n)
    return t.to(device=device, memory_format=torch.contiguous_format,
                copy=True)


def plan_rank_tree(params, plan, par, specs=None):
    """This rank's tree for ``plan`` run one process a rank over the plan
    mesh of ``par`` (a ``collectives.Parallel`` on ("stage", "data",
    "model")), on its device: the stage's groups as ``plan_stage_params``
    gathers them (``plan.max_groups`` entries, a padded entry the same
    dict as its stage's last group, masked out by the runner), each leaf
    this rank's shard under ``specs`` (default: ``par.specs``, else
    ``param_specs`` on the plan mesh, JAX's ``param_shardings`` there);
    the embedding on stage 0 only; the final norm and the head on the
    last stage only (the embedding's shard there when the head is tied
    to it).  ``params``: the port's layout (a list of groups under
    ``stack``), on any device.

    Specs with FSDP's data axis (``param_specs(..., fsdp=True)``; the
    runner's ``par`` must carry the same specs, which ``run_stack``'s
    gathers read): a leaf is cut over data on the dim its spec names; a
    stack leaf whose spec shards the group axis comes as the rank's
    block of whole groups of the full stack (every group entry the same
    tensor), out of which ``Parallel.gather_group`` takes the model's
    group (``run_stack(group_ids=)``)."""
    if specs is None:
        specs = par.specs if par.specs is not None \
            else param_specs(params, axes_view(par.dmesh))
    s, last = par.rank("stage"), plan.n_stages - 1
    device = par.device
    taken: Dict[int, Any] = {}
    blocks = _group_axis_blocks(params["stack"], specs["stack"], par, device)
    stack = []
    for g in plan.group_index_matrix()[s]:
        g = int(g)
        if g not in taken:
            taken[g] = _overlay(_take(params["stack"][g], specs["stack"],
                                      par, device, lead=1), blocks)
        stack.append(taken[g])
    keys = (FIRST_STAGE if s == 0 else ()) + (LAST_STAGE if s == last
                                               else ())
    if s == last and "head" not in params:
        keys += ("embed",)
    out = {k: _take(params[k], specs[k], par, device)
           for k in dict.fromkeys(keys) if k in params}
    out["stack"] = stack
    return out


def _group_axis_blocks(groups, spec, par, device, path=()):
    """{path: the rank's block of whole groups} for each stack leaf whose
    spec shards the group axis (dim 0 of JAX's stacked layout)."""
    if isinstance(spec, dict):
        out = {}
        for k, v in spec.items():
            out.update(_group_axis_blocks(groups, v, par, device,
                                          path + (k,)))
        return out
    axes = entry_axes(spec[0])
    if not axes:
        return {}

    def leaf(g):
        node = g
        for k in path:
            node = node[k]
        return node
    full = torch.stack([leaf(g) for g in groups])
    return {path: _take(full, spec, par, device)}


def _overlay(tree, blocks, path=()):
    """``tree`` with the leaf at each path of ``blocks`` replaced by it."""
    if isinstance(tree, dict):
        return {k: _overlay(v, blocks, path + (k,)) for k, v in tree.items()}
    return blocks.get(path, tree)
