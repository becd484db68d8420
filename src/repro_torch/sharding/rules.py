"""Logical-axis sharding rules of the port: param and input trees ->
partition specs, spec for spec the JAX package's ``sharding/rules.py``.

Megatron-style TP over the ``model`` axis, DP over ("pod", "data"):
  * attention: wq/wk/wv column-parallel, wo row-parallel;
  * MLP: wi/wg column-parallel, wo row-parallel;
  * MoE: TP within each expert by default; ``expert_parallel=True``
    shards the experts over ``model`` (EP);
  * embeddings vocab-sharded when divisible (else replicated: granite's
    vocab 49155 is indivisible by 16);
  * KV caches: the sequence (W) sharded over ``model``, the batch over the
    data axes.

The rules read a mesh's ``axis_names`` and ``shape[axis]`` only, so they
take the port's ``launch.mesh.Mesh`` or any object with those two.  A
``PartitionSpec`` is a tuple with one entry a tensor dim: None, an axis
name, or a tuple of axis names (normalized as JAX normalizes it: one name
alone, an empty tuple None).

Stacks.  JAX stacks each stack leaf on a leading group axis, (G, ...);
the port keeps ``stack`` (and whisper's ``enc_stack``) as a list of
per-group dicts.  The rules see JAX's stacked shape (``stacked_shapes``),
so every spec equals JAX's, and a stack's specs are ONE tree for all its
groups in that stacked layout: entry 0 is the group axis, entries 1.. the
dims of each group's tensor.  JAX can shard the group axis:
``_fsdp_extend`` falls back to dim 0 of a stacked 2-d (G, d) leaf, and
``zero1_specs`` shards dim 0 when the data axis divides G: each rank of
that axis then owns a contiguous block of whole groups.  ``placements``
gives the DTensor placements of one spec; ``execute`` builds the DTensor
trees and ``training.sharded_train_step`` runs a step on them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.bridge import STACKS

BATCH_AXES = ("pod", "data")


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a
    tuple of axis names (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``, without devices)."""
    mesh: Any
    spec: PartitionSpec


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, keeping the structure; a
    tuple (a shape, a spec) is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def map_with_shapes(fn, specs, shapes):
    """``fn(spec, shape)`` over a spec tree and the matching shape tree
    (``stacked_shapes``)."""
    if isinstance(specs, dict):
        return {k: map_with_shapes(fn, v, shapes[k])
                for k, v in specs.items()}
    return fn(specs, shapes)


def stacked_shapes(params):
    """The shapes of the port's params in JAX's layout: each stack's
    per-group leaves as one (G, ...) shape (every group has the same
    shapes), every other leaf's own shape."""
    out = {k: _map_with_path(lambda _, t: _shape(t), v)
           for k, v in params.items() if k not in STACKS}
    for name in STACKS:
        if name in params:
            groups = params[name]
            out[name] = _map_with_path(lambda _, t: (len(groups),)
                                       + _shape(t), groups[0])
    return out


def batch_axes_for(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of ('pod', 'data') whose product divides batch."""
    axes = [a for a in BATCH_AXES if a in mesh.axis_names]
    out = []
    prod = 1
    for a in axes:
        sz = mesh.shape[a]
        if batch % (prod * sz) == 0:
            out.append(a)
            prod *= sz
    return tuple(out) if out else None


def _maybe(mesh, axis: str, dim: int) -> Optional[str]:
    """Shard ``dim`` over ``axis`` only if present and divisible."""
    if axis in mesh.axis_names and dim % mesh.shape[axis] == 0:
        return axis
    return None


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_spec(names: Tuple[str, ...], shape: Tuple[int, ...], mesh, *,
                expert_parallel: bool = False) -> P:
    """Spec from the param path and its (stacked) shape.  Leaves under
    'stack'/'enc_stack' have a leading group axis."""
    leading = 1 if any(n in STACKS for n in names) else 0
    nd = len(shape)
    last = names[-1]
    mdl = "model" if "model" in mesh.axis_names else None

    def spec(*tail):
        full = [None] * leading + list(tail)
        full += [None] * (nd - len(full))
        return P(*full[:nd])

    if mdl is None:
        return P(*([None] * nd))

    in_moe = "ffn" in names and nd - leading == 3  # (E, d, f) expert weights

    if last in ("wq", "wk", "wv", "wi", "wg", "up", "up_proj", "in_proj",
                "dt_proj", "w_x"):
        if in_moe:
            if expert_parallel:
                return spec(_maybe(mesh, "model", shape[leading]), None,
                            None)
            return spec(None, None, _maybe(mesh, "model", shape[-1]))
        return spec(None, _maybe(mesh, "model", shape[-1]))
    if last in ("wo", "down", "down_proj", "out_proj", "x_proj"):
        if in_moe:
            if expert_parallel:
                return spec(_maybe(mesh, "model", shape[leading]), None,
                            None)
            return spec(None, _maybe(mesh, "model", shape[-2]), None)
        return spec(_maybe(mesh, "model", shape[leading]), None)
    if last == "w_h":                           # slstm (H, hd, 4hd)
        return spec(_maybe(mesh, "model", shape[leading]), None, None)
    if last in ("conv_w",):                     # (k, d_inner)
        return spec(None, _maybe(mesh, "model", shape[-1]))
    if last in ("conv_b", "dt_bias", "D"):      # (d_inner,)
        return spec(_maybe(mesh, "model", shape[-1]))
    if last == "A_log":                         # (d_inner, n)
        return spec(_maybe(mesh, "model", shape[leading]), None)
    if last == "table":                         # (V, D) vocab-sharded
        return P(_maybe(mesh, "model", shape[0]), None)
    if last == "w" and "head" in names:         # (D, V)
        return P(None, _maybe(mesh, "model", shape[-1]))
    if last == "router":
        return spec(None, None)
    # norms, biases, gates, pos embeddings: replicated
    return P(*([None] * nd))


def _fsdp_extend(spec: P, shape: Tuple[int, ...], mesh,
                 axes=("data",)) -> P:
    """FSDP: additionally shard the weight over the data axis on the first
    unsharded, divisible, non-scan dim (dim 0 of a stacked leaf is the
    group axis: prefer dims >= 1, and fall back to dim 0 only for a 2-d
    leaf)."""
    for ax in axes:
        if ax not in mesh.axis_names:
            return spec
    sz = int(np.prod([mesh.shape[a] for a in axes]))
    nd = len(shape)
    entries = list(spec) + [None] * (nd - len(spec))
    order = list(range(1, nd)) + ([0] if nd == 2 else [])
    for i in order:
        if entries[i] is None and shape[i] % sz == 0 and shape[i] >= sz:
            entries[i] = axes[0] if len(axes) == 1 else tuple(axes)
            return P(*entries)
    return spec


def param_specs(params, mesh, *, expert_parallel: bool = False,
                fsdp: bool = False):
    """Specs of the port's params, in JAX's layout (a stack's one spec
    tree in the stacked (G, ...) layout, see the module docstring)."""
    def f(path, shape):
        spec = _param_spec(path, shape, mesh,
                           expert_parallel=expert_parallel)
        if fsdp and len(shape) >= 2:
            spec = _fsdp_extend(spec, shape, mesh)
        return spec
    return _map_with_path(f, stacked_shapes(params))


def param_shardings(params, mesh, *, expert_parallel: bool = False,
                    fsdp: bool = False):
    """``param_specs`` as ``NamedSharding(mesh, spec)`` leaves."""
    return _map_with_path(
        lambda _, s: NamedSharding(mesh, s),
        param_specs(params, mesh, expert_parallel=expert_parallel,
                    fsdp=fsdp))


# ---------------------------------------------------------------------------
# input rules
# ---------------------------------------------------------------------------

def input_specs_tree(batch_tree, mesh, *, seq_axis_for_cache=True):
    """Specs for a model-input tree (tokens/labels/embeds/positions/
    cache/cache_index) from each leaf's path and rank."""
    def f(names, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if "cache" in names:
            return _cache_spec(names, shape, mesh)
        if names and names[0] == "positions":
            bspec = batch_axes_for(mesh, shape[1])
            return P(None, bspec, None)
        if nd == 0:
            return P()
        bspec = batch_axes_for(mesh, shape[0])
        return P(*([bspec] + [None] * (nd - 1)))
    return _map_with_path(f, batch_tree)


def _cache_spec(names, shape, mesh) -> P:
    """Cache leaves are (G, B, ...).  KV caches (G, B, W, Hk, hd): shard W
    over model (and data when the batch does not use it).  Recurrent
    states (G, B, ...): shard the largest trailing dim over model if
    divisible."""
    nd = len(shape)
    bspec = batch_axes_for(mesh, shape[1])
    if "kv" in names or "cross_kv" in names:       # (G, B, W, Hk, hd)
        W = shape[2]
        seq_axes = []
        if bspec is None:
            for a in ("data",):
                if a in mesh.axis_names and W % mesh.shape[a] == 0:
                    seq_axes.append(a)
        if "model" in mesh.axis_names and W % mesh.shape["model"] == 0:
            seq_axes.append("model")
        sspec = tuple(seq_axes) if seq_axes else None
        return P(None, bspec, sspec, None, None)
    if nd >= 3:
        dims = list(shape[2:])
        tgt = int(np.argmax(dims)) + 2
        ax = _maybe(mesh, "model", shape[tgt])
        spec = [None, bspec] + [None] * (nd - 2)
        spec[tgt] = ax
        return P(*spec)
    return P(None, bspec)


def input_shardings_tree(batch_tree, mesh):
    """``input_specs_tree`` as ``NamedSharding(mesh, spec)`` leaves."""
    return _map_with_path(lambda _, s: NamedSharding(mesh, s),
                          input_specs_tree(batch_tree, mesh))


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: P, mesh):
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``mesh``: one a mesh dim, ``Shard(d)`` where the spec names that axis
    at tensor dim d (an entry of two axes shards dim d over both),
    ``Replicate()`` elsewhere.  Pure: no process group is needed."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    seen = set()
    for dim, e in enumerate(spec):
        for ax in (() if e is None else e if isinstance(e, tuple)
                   else (e,)):
            if ax not in mesh.axis_names or ax in seen:
                raise ValueError(f"{spec}: axis {ax!r} is not on the mesh "
                                 f"{tuple(mesh.axis_names)} or is named "
                                 f"twice")
            seen.add(ax)
            out[mesh.axis_names.index(ax)] = Shard(dim)
    return out
