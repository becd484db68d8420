"""Device meshes of the port, the counterpart of the JAX package's
``launch/mesh.py``.

A ``Mesh`` is an ndarray of ``torch.device`` (object dtype) with one name
an axis: ``axis_names``, and ``shape`` mapping each name to its size, as
JAX's ``Mesh`` gives them (the sharding rules read nothing else).  The
builders are JAX's:

  * ``make_production_mesh``: (16, 16) over ("data", "model"), 256
    devices; multi-pod (2, 16, 16) over ("pod", "data", "model"), 512;
  * ``make_pipeline_mesh``: an SSR ``stage`` axis carved out of the data
    axis of the production mesh;
  * ``make_plan_mesh``: the stage-major ("stage", "data", "model") mesh of
    an ``ExecutionPlan``;
  * ``make_host_mesh``: the local devices as a small mesh.

Each takes an explicit ``devices`` list, which defaults to every local
CUDA device (``local_devices("cuda")``); the CPU is used only when the
caller passes it.  Entries may repeat: ``[cuda:0] * 2`` is two mesh slots
that share one card.  A builder given too few devices raises; it never
fakes them.  JAX's ``use_mesh`` (an ambient mesh) has no counterpart:
the mesh, or its ``DeviceMesh``, is passed explicitly.

Two ways to run a mesh.  The pipeline executor (``pipeline.executor``)
either is ONE process that drives every slot, or runs one process a
mesh rank, as sharded training does and as ``torchrun`` starts them:
``init_distributed`` joins the process group (rank r on the device at
the r-th flat position of ``mesh.devices``) and ``device_mesh`` gives
the ``torch.distributed.device_mesh.DeviceMesh`` with the mesh's axis
names and shape (a plan mesh's: "stage", "data", "model", on which
``sharding.Parallel`` sees ``tp`` = the model axis and ``dp`` = the data
axis; "stage" is no batch axis).  The backend is NCCL for CUDA ranks on
distinct cards, gloo for CPU ranks and for ranks that share a card
(NCCL refuses two ranks on one GPU); nothing falls back from one to the
other.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


class Mesh:
    """Devices laid out on named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device array needs as many "
                             f"axis names, got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self):
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {len(self.distinct_devices())} distinct)"


def local_devices(kind: str = "cuda"):
    """Every local device of ``kind``: each CUDA card, or the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"kind={kind!r} must be 'cuda' or 'cpu'")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices):
    return list(devices) if devices is not None else local_devices("cuda")


def _make_mesh(shape, axes, devices):
    devs = _devices(devices)
    n = int(np.prod(shape))
    if len(devs) < n:
        raise ValueError(f"a {shape} mesh over {axes} needs {n} devices, "
                         f"got {len(devs)}")
    arr = np.asarray([torch.device(d) for d in devs[:n]], dtype=object)
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, devices)


def make_pipeline_mesh(n_stages: int, *, model: int = 16, total: int = 256,
                       multi_pod: bool = False, devices=None) -> Mesh:
    """SSR spatial/hybrid mesh: ("stage", "data", "model").  The stage axis
    is carved out of the data axis of the production mesh."""
    if multi_pod:
        total = 512
    data = total // (n_stages * model)
    if data < 1 or n_stages * data * model != total:
        raise ValueError(
            f"make_pipeline_mesh: n_stages={n_stages} x model={model} does "
            f"not evenly divide the {total}-device budget (would silently "
            f"mis-factor the mesh); pick n_stages from the divisors of "
            f"{total // model}")
    return _make_mesh((n_stages, data, model), ("stage", "data", "model"),
                      devices)


def make_plan_mesh(plan, devices=None) -> Mesh:
    """Stage-major mesh for an ``ExecutionPlan``: ("stage", data, model)
    with a *uniform* slot width per stage (a rectangular device mesh cannot
    give stages different widths: the plan records the replicate-padding
    waste of stages that asked for less, see ``StagePlan.replica_waste``).

    The slot width is ``len(devices) // n_stages`` capped at the plan's own
    ``stage_width``; leftover devices (a budget the stage count does not
    divide) are left out of the mesh.  The (data, model) split is the
    plan's common factorization (gcd of the stages' tp)."""
    devs = _devices(devices)
    S = plan.n_stages
    if len(devs) < S:
        raise ValueError(
            f"make_plan_mesh: the plan has {S} stages but only "
            f"{len(devs)} device(s) are available — every stage needs its "
            f"own mesh slot")
    width = max(len(devs) // S, 1)
    if plan.stage_width and plan.stage_width <= width:
        width = plan.stage_width
    data, model = plan.mesh_factors(width)
    return _make_mesh((S, data, model), ("stage", "data", "model"), devs)


def make_host_mesh(axes=("data", "model"), devices=None) -> Mesh:
    """The given (default: every local CUDA) devices as a small mesh, all
    on the first axis."""
    devs = _devices(devices)
    if not devs:
        raise ValueError("make_host_mesh: no devices")
    shape = (len(devs),) + (1,) * (len(axes) - 1)
    return _make_mesh(shape, tuple(axes), devs)


def backend_for(mesh: Mesh) -> str:
    """NCCL when every slot is a distinct CUDA card, gloo otherwise (CPU
    ranks, or CUDA ranks that share a card)."""
    devs = list(mesh.devices.flat)
    cuda = all(torch.device(d).type == "cuda" for d in devs)
    return "nccl" if cuda and len(set(devs)) == len(devs) else "gloo"


def init_distributed(mesh: Mesh, rank: int, world_size: int, *,
                     init_method: str = "env://"):
    """Join the process group as mesh rank ``rank`` of ``world_size``
    (which must be the mesh's size), on ``backend_for(mesh)`` over
    ``init_method`` (``env://`` reads ``MASTER_ADDR``/``MASTER_PORT`` as
    ``torchrun`` sets them; ``file://PATH`` or ``tcp://localhost:PORT``
    otherwise).  Sets this rank's CUDA device.  Returns the rank's
    ``torch.device``."""
    import torch.distributed as dist
    n = mesh.devices.size
    if world_size != n:
        raise ValueError(f"a mesh of {n} slots needs {n} ranks, got "
                         f"world_size={world_size}")
    dev = torch.device(mesh.devices.flat[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(mesh), init_method=init_method,
                            rank=rank, world_size=world_size)
    return dev


def device_mesh(mesh: Mesh):
    """The ``DeviceMesh`` of ``mesh`` over the live process group: rank r
    at the r-th flat position, with the mesh's ``axis_names`` and
    shape."""
    from torch.distributed.device_mesh import DeviceMesh
    kind = torch.device(mesh.devices.flat[0]).type
    ranks = torch.arange(mesh.devices.size).reshape(mesh.devices.shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=mesh.axis_names)
