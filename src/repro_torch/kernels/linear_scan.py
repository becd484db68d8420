"""Gated linear recurrence: the hand-written Hopper kernel and its door.

``linear_scan(a, b, h0=None)`` computes every state of
``h_t = a_t * h_{t-1} + b_t`` over (N, S, F) with an f32 carry from
``h0`` (N, F) (zeros when None), as the JAX kernel of the same name
does.  On CPU tensors it runs the plain version
(``ref.linear_scan_ref``); on CUDA tensors it launches
``csrc/linear_scan.cu`` or raises -- there is no fallback.  The model
reaches it through mamba (``models/ssm.py``): every decode step at S = 1
with the slot's state as ``h0``, and every prefill at the prompt's
length.

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
    if a.device.type != "cuda":
        raise ValueError(f"no linear scan kernel for {a.device}")
    n, s, f = check_linear_scan_contract(a, b, h0)
    lib = _build.load_library()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_linear_scan(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), n, s, f, stream)
    _build.check(err, "linear_scan")
    linear_scan.launches += 1
    return out


linear_scan.launches = 0
