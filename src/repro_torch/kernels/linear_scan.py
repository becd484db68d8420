"""Gated linear recurrence: the hand-written Hopper kernel and its door.

``linear_scan(a, b, h0=None)`` computes every state of
``h_t = a_t * h_{t-1} + b_t`` over (N, S, F) with an f32 carry from
``h0`` (N, F) (zeros when None), as the JAX kernel of the same name
does.  On CPU tensors it runs the plain version
(``ref.linear_scan_ref``); on CUDA tensors it launches
``csrc/linear_scan.cu`` or raises -- there is no fallback.  It has no
backward: asked for a gradient on a non-CPU input, it raises
(``_build.refuse_grad``).  The model
reaches it through mamba (``models/ssm.py``): every decode step at S = 1
with the slot's state as ``h0`` (prefill, S > 1, takes the fused
selective scan, ``kernels/selective_scan.py``).

The kernel has two paths, picked by ``scan_plan`` from shapes and
alignment alone (a dispatch by shape, not a fallback): ``vector`` gives
each thread 4 neighbouring features in 16-byte loads and stores and
needs F a multiple of 4 and every operand on a 16-byte boundary;
``scalar`` (one thread a feature) takes every other shape.
``linear_scan.last_plan`` records the plan of the last CUDA launch.

Shape contract on CUDA: a and b contiguous float32 of one shape
(N, S, F) with N <= 65,535; h0 None or contiguous float32 (N, F); all on
one device.  Any S and F: the TPU kernel's block-size divisibility rules
are its tiling, not this kernel's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

MAX_ROWS = 65_535          # grid.y
VEC_THREADS = 128          # a block of the vector path (csrc: launch bound)
SCALAR_THREADS = 256


def scan_plan(f, aligned=True):
    """``(path, threads, blocks)`` of a CUDA launch along F (the grid's
    second axis is N), from the feature count and alignment alone
    (``aligned``: every operand starts on a 16-byte boundary): the vector
    path's threads own 4 features each, the scalar path's one."""
    if f % 4 == 0 and aligned:
        return "vector", VEC_THREADS, -(-(f // 4) // VEC_THREADS)
    return "scalar", SCALAR_THREADS, -(-f // SCALAR_THREADS)


def check_linear_scan_contract(a, b, h0=None):
    """Raise ValueError outside the CUDA kernel's contract; returns
    (N, S, F)."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a/b must share one (N, S, F) shape, got "
                         f"{tuple(a.shape)}/{tuple(b.shape)}")
    n, s, f = a.shape
    if n > MAX_ROWS:
        raise ValueError(f"N={n} rows exceed the kernel's {MAX_ROWS}")
    tensors = (a, b) if h0 is None else (a, b, h0)
    if h0 is not None and h0.shape != (n, f):
        raise ValueError(f"h0 must be ({n}, {f}), got {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the scan kernel takes float32 a, b and h0")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("linear scan operands must be contiguous")
    if any(t.device != a.device for t in tensors):
        raise ValueError("linear scan operands must share one device")
    return n, s, f


def linear_scan(a, b, h0=None):
    """a, b: (N, S, F); h0: (N, F) or None.  Returns h_all (N, S, F)."""
    if a.device.type == "cpu":
        return R.linear_scan_ref(a, b, h0)
    _build.refuse_grad("linear_scan", (a, b, h0))
    if a.device.type != "cuda":
        raise ValueError(f"no linear scan kernel for {a.device}")
    n, s, f = check_linear_scan_contract(a, b, h0)
    lib = _build.load_library()
    out = torch.empty_like(a)
    operands = (a, b, out) if h0 is None else (a, b, out, h0)
    plan = scan_plan(f, all(t.data_ptr() % 16 == 0 for t in operands))
    path, threads, blocks = plan
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_linear_scan(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), n, s, f, int(path == "vector"), threads, blocks,
            stream)
    _build.check(err, "linear_scan")
    linear_scan.launches += 1
    linear_scan.last_plan = plan
    return out


linear_scan.launches = 0
linear_scan.last_plan = None
