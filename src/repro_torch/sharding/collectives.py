"""Collectives over named mesh axes: the one place the port's sharded
training and its plan runner (one process a rank) reach a process group.

``Parallel`` wraps a ``torch.distributed.device_mesh.DeviceMesh`` whose
dims carry JAX's axis names ("pod", "data", "model").  Every layer, the
loss, the optimizer, the checkpoint and the data rows reach the mesh's
process groups only through its methods, so that ``stats()`` counts the
collectives of a step and their bytes in one place.

Autograd-aware, Megatron's pair and its gather/scatter twins:
  * ``f(x, axes)``: identity forward, all-reduce backward -- a replicated
    activation entering a region where each rank computes a part;
  * ``g(x, axes)``: all-reduce forward, identity backward -- the partial
    sums of a row-parallel product (or a per-rank share of the loss);
  * ``all_gather(x, dim, axes)``: forward gathers the shards along
    ``dim``, backward reduce-scatters the gradient back (each rank's use
    of the gathered tensor is a part of the whole);
  * ``gather_replicated(x, dim, axes)``: the same forward, for a tensor
    that every rank then uses whole in the same replicated compute: each
    rank's gradient of it is already the whole one, so the backward
    keeps this rank's block of it and sums nothing (the summing backward
    would count it ``size(axes)`` times);
  * ``reduce_scatter(x, dim, axes)``: the transpose of ``all_gather``.
Plain (no gradient): ``all_reduce`` (sum or max), ``gather_plain``,
``scatter_plain``; and the module's ``barrier``.  Point to point along
a plan mesh's "stage" axis (JAX's ``ppermute`` over "stage" in the
pipeline executor): ``send(t, shift)`` and ``recv(shape, dtype, shift)``
move a tensor to the rank ``shift`` stages on with the same data and
model coordinates; ``stats()`` counts them as ``send`` with their bytes.

``axes`` is one axis name or a tuple of them; axes of size 1 are skipped
(no collective is counted for them), and a collective over several axes
runs one axis at a time: an all-gather innermost axis first, so a dim
sharded over ("pod", "data") comes back in JAX's order (pod-major).

Transport: the process group's own, on the tensors' device.  NCCL takes
every collective on CUDA tensors; so does gloo (it copies them through
host memory itself), which is what ranks sharing a card run on: the
card's probe found gloo taking all eight collectives it was offered on
CUDA tensors (``chip_smoke.py`` phase 10, PERF.md), so nothing here
stages a buffer or picks a transport, and nothing falls back on an
error.  Gloo's ``send``/``recv`` (and ``isend``/``irecv``,
``batch_isend_irecv``) do NOT take CUDA tensors: on the card's probe
(``chip_smoke.py --probe-p2p``, PERF.md) they handed the device pointer
to the TCP transport, which failed ("Bad address") and aborted the
process.  So a stage link is a broadcast from the sender over a process
group of the two ranks (``Parallel`` makes one for every two ranks on a
line of the "stage" axis): the one transport, on gloo and NCCL alike,
CPU or CUDA.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

BATCH_AXES = ("pod", "data")

_STATS: Dict[str, object] = {}


def reset_stats():
    """Zero the counters: collectives and bytes, in all and by op."""
    _STATS.clear()
    _STATS.update(ops=0, bytes=0, by_op={})


def stats() -> Dict[str, object]:
    """A copy of the counters since the last ``reset_stats``.  Bytes are
    each call's payload on this rank: the input of an all-reduce or a
    reduce-scatter, the output of an all-gather."""
    return {**_STATS, "by_op": {k: dict(v) for k, v in
                                _STATS["by_op"].items()}}


reset_stats()


def _count(op: str, nbytes: int):
    _STATS["ops"] += 1
    _STATS["bytes"] += nbytes
    row = _STATS["by_op"].setdefault(op, {"ops": 0, "bytes": 0})
    row["ops"] += 1
    row["bytes"] += nbytes


def barrier():
    """Every rank of the process group waits for the others."""
    dist.barrier()


def is_writer() -> bool:
    """Whether this process writes what ranks share (rank 0, or the only
    process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_front(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.movedim(dim, 0).contiguous()


Axes = Union[str, Sequence[str]]


class Parallel:
    """A device mesh's named axes, their process groups, and this rank's
    place on them.

    ``param_specs`` (optional): the params' specs in JAX's stacked layout
    (``sharding.param_specs``); the model reads them to all-gather the
    FSDP-sharded leaves before use (``gathered``, ``gather_group``).
    The batch is split over every batch axis of the mesh
    (``data_axes``); "stage" is none.  On a mesh whose "stage" axis has
    more than one rank, building a ``Parallel`` is a collective: it makes
    the stage links' process groups, so every rank builds it, at the
    same point."""

    def __init__(self, dmesh, param_specs=None):
        self.dmesh = dmesh
        self.axis_names = tuple(dmesh.mesh_dim_names)
        self.shape = {a: dmesh.size(i) for i, a in enumerate(self.axis_names)}
        self.specs = param_specs
        self.data_axes = tuple(a for a in BATCH_AXES if a in self.axis_names)
        self.tp = self.shape.get("model", 1)
        self.dp = math.prod(self.shape[a] for a in self.data_axes)
        self.model_rank = self.rank("model")
        self.data_rank = self.coord(self.data_axes)
        self._make_pairs()

    # ------------------------------------------------------------ the mesh
    def rank(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 for an axis not on the mesh)."""
        if axis not in self.axis_names:
            return 0
        return self.dmesh.get_local_rank(axis)

    def coord(self, axes: Axes) -> int:
        """This rank's flat index over ``axes``, the first axis outer."""
        idx = 0
        for a in _norm(axes):
            idx = idx * self.shape.get(a, 1) + self.rank(a)
        return idx

    def size(self, axes: Axes) -> int:
        return math.prod(self.shape.get(a, 1) for a in _norm(axes))

    def live_axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` that are on the mesh with more than one rank."""
        return tuple(a for a in _norm(axes) if self.shape.get(a, 1) > 1)

    def group(self, axis: str):
        return self.dmesh.get_group(axis)

    @property
    def device(self) -> torch.device:
        """This rank's device: its current CUDA card on a CUDA mesh (set
        by ``launch.mesh.init_distributed``), else the CPU."""
        if self.dmesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.dmesh.device_type)

    # ------------------------------------------------- raw, one axis each
    def _all_reduce(self, t, axis, op="sum"):
        """All-reduce ``t`` in place over one axis."""
        dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                               else dist.ReduceOp.SUM),
                        group=self.group(axis))
        _count("all_reduce", t.numel() * t.element_size())
        return t

    def _all_gather(self, t, dim, axis, name="all_gather"):
        src = _to_front(t, dim)
        out = torch.empty((self.shape[axis] * src.shape[0],) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.group(axis))
        _count(name, out.numel() * out.element_size())
        return out.movedim(0, dim)

    def _reduce_scatter(self, t, dim, axis):
        n = self.shape[axis]
        src = _to_front(t, dim)
        if src.shape[0] % n:
            raise ValueError(f"reduce-scatter of {src.shape[0]} rows over "
                             f"{axis}={n}")
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=self.group(axis))
        _count("reduce_scatter", src.numel() * src.element_size())
        return out.movedim(0, dim)

    # ------------------------------------------------- plain collectives
    def all_reduce(self, t, axes: Axes, op: str = "sum"):
        """A reduced copy of ``t`` over ``axes`` (no gradient)."""
        out = t.detach().clone(memory_format=torch.contiguous_format)
        for a in self.live_axes(axes):
            self._all_reduce(out, a, op)
        return out

    def gather_plain(self, t, dim: int, axes: Axes, name="all_gather"):
        """``t``'s shards along ``dim`` over ``axes``, gathered (no
        gradient); counted under ``name``."""
        out = t.detach()
        for a in reversed(self.live_axes(axes)):
            out = self._all_gather(out, dim, a, name)
        return out

    def scatter_plain(self, t, dim: int, axes: Axes):
        """``t`` summed over ``axes`` and this rank's shard of it along
        ``dim`` (no gradient)."""
        out = t.detach()
        for a in self.live_axes(axes):
            out = self._reduce_scatter(out, dim, a)
        return out

    # ------------------------------------------------- point to point
    def _make_pairs(self):
        """A process group for every two ranks on one line of the "stage"
        axis (the other coordinates equal): the links ``send``/``recv``
        run over.  Every rank makes every group, in one order, as
        ``new_group`` asks."""
        self._pairs = {}
        n = self.shape.get("stage", 1)
        if n < 2:
            return
        lines = self.dmesh.mesh.movedim(self.axis_names.index("stage"),
                                        -1).reshape(-1, n).tolist()
        for line in lines:
            for i in range(n):
                for j in range(i + 1, n):
                    self._pairs[(line[i], line[j])] = dist.new_group(
                        [line[i], line[j]])

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's mesh coordinates with ``coords``
        (axis name -> index) put in their place."""
        c = list(self.dmesh.get_coordinate())
        for a, i in coords.items():
            c[self.axis_names.index(a)] = i
        return int(self.dmesh.mesh[tuple(c)])

    def _pair(self, a: int, b: int):
        return self._pairs[(min(a, b), max(a, b))]

    def send(self, t, shift: int = 1):
        """Send ``t`` to the rank ``shift`` steps along "stage" with this
        rank's data and model coordinates (one pair of JAX's ``ppermute``
        over "stage"): a broadcast from this rank over the two ranks' link
        group; it blocks until the transport has taken ``t``.  Counted as a
        ``send`` of its bytes."""
        me = dist.get_rank()
        peer = self.rank_at(stage=self.rank("stage") + shift)
        dist.broadcast(t.contiguous(), me, group=self._pair(me, peer))
        _count("send", t.numel() * t.element_size())

    def recv(self, shape, dtype, shift: int = 1):
        """What the rank ``shift`` steps back along "stage" sends with
        ``send(..., shift)``: a new tensor of ``shape`` and ``dtype`` on
        this rank's device."""
        src = self.rank_at(stage=self.rank("stage") - shift)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        dist.broadcast(out, src, group=self._pair(dist.get_rank(), src))
        return out

    # ------------------------------------------------ autograd collectives
    def f(self, x, axes: Axes):
        axes = self.live_axes(axes)
        return _F.apply(x, self, axes) if axes else x

    def g(self, x, axes: Axes):
        axes = self.live_axes(axes)
        return _G.apply(x, self, axes) if axes else x

    def all_gather(self, x, dim: int, axes: Axes):
        axes = self.live_axes(axes)
        return _Gather.apply(x, self, dim % x.dim(), axes) if axes else x

    def reduce_scatter(self, x, dim: int, axes: Axes):
        axes = self.live_axes(axes)
        return _Scatter.apply(x, self, dim % x.dim(), axes) if axes else x

    def gather_replicated(self, x, dim: int, axes: Axes):
        """``x``'s shards along ``dim`` gathered over ``axes`` for compute
        that every rank runs whole and alike: the backward keeps this
        rank's block of the gradient and sums nothing.  Counted as
        ``all_gather_replicated``."""
        axes = self.live_axes(axes)
        return _GatherReplicated.apply(x, self, dim % x.dim(), axes) \
            if axes else x

    # ---------------------------------------------------------- FSDP
    def spec_of(self, path: Sequence[str]):
        node = self.specs
        for k in path:
            node = node[k]
        return node

    def gathered(self, path: Sequence[str], t):
        """A top-level leaf at ``path`` (say ("embed", "table")) gathered
        over the data axes its spec shards it on (FSDP); as it is
        otherwise."""
        if self.specs is None:
            return t
        hit = data_dim(self.spec_of(path))
        return t if hit is None else self.all_gather(t, hit[0], hit[1])

    def gather_group(self, gp, g: int, stack: str = "stack"):
        """Group ``g``'s block params with every FSDP-sharded leaf
        gathered over the data axes.  The stack's specs are in the stacked
        (G, ...) layout: a data entry at dim d > 0 is dim d - 1 of the
        group's leaf; at dim 0 (the group axis) the leaf passed in is the
        rank's block of whole groups, gathered whole, and group ``g``
        taken from it."""
        if self.specs is None:
            return gp
        return _gather_tree(self, gp, self.specs[stack], g)


def _gather_tree(par, node, spec, g):
    if isinstance(node, dict):
        return {k: _gather_tree(par, v, spec[k], g) for k, v in node.items()}
    hit = data_dim(spec)
    if hit is None:
        return node
    d, axes = hit
    if d == 0:
        return par.all_gather(node, 0, axes)[g]
    return par.all_gather(node, d - 1, axes)


def _norm(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (None: none)."""
    return () if entry is None else _norm(entry)


def data_dim(spec, axes=BATCH_AXES):
    """(tensor dim, its axes among ``axes``) of the first entry of
    ``spec`` that names one of ``axes``, or None."""
    for d, e in enumerate(spec):
        hit = tuple(a for a in entry_axes(e) if a in axes)
        if hit:
            return d, hit
    return None


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axes):
        ctx.par, ctx.axes = par, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.par.all_reduce(grad, ctx.axes), None, None


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axes):
        return par.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dim, axes):
        ctx.par, ctx.dim, ctx.axes = par, dim, axes
        return par.gather_plain(x, dim, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.par.scatter_plain(grad, ctx.dim, ctx.axes), None, None, \
            None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dim, axes):
        ctx.par, ctx.dim, ctx.axes = par, dim, axes
        return par.gather_plain(x, dim, axes, "all_gather_replicated")

    @staticmethod
    def backward(ctx, grad):
        # this rank's block, the first axis outer as the gather lays it
        par, dim, axes = ctx.par, ctx.dim, ctx.axes
        n = grad.shape[dim] // par.size(axes)
        return grad.narrow(dim, par.coord(axes) * n, n).contiguous(), \
            None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dim, axes):
        ctx.par, ctx.dim, ctx.axes = par, dim, axes
        return par.scatter_plain(x, dim, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.par.gather_plain(grad, ctx.dim, ctx.axes), None, None, \
            None
