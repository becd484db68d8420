"""Mamba's fused selective scan: the hand-written Hopper kernel and its door.

``mamba_scan_fused(delta, xi, bm, cm, a_mat, h0=None)`` computes, for
every step t, ``h_t = exp(delta_t A) h_{t-1} + (delta_t x_t) B_t`` over
the (N, d_inner, d_state) state from ``h0`` (zeros when None) and
``y_t = C_t . h_t``, returning (y (N, S, d_inner), h_last (N, d_inner,
d_state)), as the JAX package's ``models/ssm.py::mamba_scan_fused`` does
(its default mamba prefill; it has no Pallas kernel).  On CPU tensors it
runs the plain version (``ref.mamba_scan_fused_ref``); on CUDA tensors it
launches ``csrc/selective_scan.cu`` or raises -- there is no fallback.
Neither forms a (N, S, d_inner, d_state) tensor.  The model reaches it
through ``models/ssm.py::apply_mamba`` at S > 1 (prefill).

Gradients.  JAX's function is jnp, differentiated by JAX, and has no
kernel or backward of its own, so none is ported: ``_SelectiveScan``, a
``torch.autograd.Function``, runs the kernel forward and recomputes the
scan in its backward through ``ref.mamba_scan_fused_ref``,
differentiating that loop for the gradients of delta, xi, bm, cm, a_mat
and h0.  Every CUDA call goes through it; under ``torch.no_grad()`` it
records nothing and is the same launch.  A selective-scan backward
kernel is later work.

``selective_scan_plan`` picks, from shapes and alignment alone, how many
threads share a channel's states (``lanes``) and how many states each
holds, and whether the kernel stages its chunks in 16-byte or 4-byte
copies.  ``mamba_scan_fused.last_plan`` records the plan of the last CUDA
launch.

Shape contract on CUDA: delta and xi (N, S, D), bm and cm (N, S, n),
a_mat (D, n), h0 None or (N, D, n); all contiguous float32 on one device,
with S >= 1, D >= 1, 1 <= n <= 32 and N <= 65,535.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

MAX_ROWS = 65_535          # grid.y
MAX_STATE = 32
THREADS = 128              # a block (csrc: kThreads)
STATES = 4                 # states a thread at most


def selective_scan_plan(d, n, aligned=True):
    """``(copies, lanes, states, blocks)`` of a CUDA launch: ``states``
    of a channel's n states a thread (n rounded up to a power of two, at
    most ``STATES``), ``lanes`` threads a channel (a power of two covering
    n), ``blocks`` of 128 / lanes channels along D; ``copies`` is "vector"
    (16-byte staging: D and n multiples of 4, ``aligned`` operands) or
    "scalar"."""
    states = min(STATES, 1 << (n - 1).bit_length())
    lanes = 1 << (-(-n // states) - 1).bit_length()
    vec = aligned and d % 4 == 0 and n % 4 == 0
    return (("vector" if vec else "scalar"), lanes, states,
            -(-d // (THREADS // lanes)))


def check_selective_scan_contract(delta, xi, bm, cm, a_mat, h0=None):
    """Raise ValueError outside the CUDA kernel's contract; returns
    (N, S, D, n)."""
    if delta.dim() != 3 or xi.shape != delta.shape:
        raise ValueError(f"delta/xi must share one (N, S, D) shape, got "
                         f"{tuple(delta.shape)}/{tuple(xi.shape)}")
    n_, s, d = delta.shape
    if a_mat.dim() != 2 or a_mat.shape[0] != d:
        raise ValueError(f"A must be ({d}, n), got {tuple(a_mat.shape)}")
    n = a_mat.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"d_state {n} outside the kernel's [1, "
                         f"{MAX_STATE}]")
    if bm.shape != (n_, s, n) or cm.shape != (n_, s, n):
        raise ValueError(f"B/C must be ({n_}, {s}, {n}), got "
                         f"{tuple(bm.shape)}/{tuple(cm.shape)}")
    if h0 is not None and h0.shape != (n_, d, n):
        raise ValueError(f"h0 must be ({n_}, {d}, {n}), got "
                         f"{tuple(h0.shape)}")
    if s < 1 or d < 1 or n_ > MAX_ROWS:
        raise ValueError(f"N={n_}, S={s}, D={d}: S and D must be >= 1 and "
                         f"N <= {MAX_ROWS}")
    tensors = [t for t in (delta, xi, bm, cm, a_mat, h0) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("the selective scan kernel takes float32 operands")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("selective scan operands must be contiguous")
    if any(t.device != delta.device for t in tensors):
        raise ValueError("selective scan operands must share one device")
    return n_, s, d, n


def mamba_scan_fused(delta, xi, bm, cm, a_mat, h0=None):
    """delta, xi (N, S, D); bm, cm (N, S, n); a_mat (D, n); h0 (N, D, n)
    or None.  Returns (y (N, S, D), h_last (N, D, n)), both float32."""
    operands = [t for t in (delta, xi, bm, cm, a_mat, h0) if t is not None]
    if any(t.device != delta.device for t in operands):
        raise ValueError("selective scan operands must share one device")
    if delta.device.type == "cpu":
        return R.mamba_scan_fused_ref(delta, xi, bm, cm, a_mat, h0)
    if delta.device.type != "cuda":
        raise ValueError(f"no selective scan kernel for {delta.device}")
    return _SelectiveScan.apply(delta, xi, bm, cm, a_mat, h0)


def _launch(delta, xi, bm, cm, a_mat, h0):
    """One launch of ``csrc/selective_scan.cu`` on CUDA tensors."""
    n_, s, d, n = check_selective_scan_contract(delta, xi, bm, cm, a_mat,
                                                h0)
    operands = [t for t in (delta, xi, bm, cm, a_mat, h0) if t is not None]
    lib = _build.load_library()
    y = torch.empty_like(delta)
    h_last = torch.empty((n_, d, n), dtype=torch.float32,
                         device=delta.device)
    plan = selective_scan_plan(
        d, n, all(t.data_ptr() % 16 == 0 for t in operands + [y]))
    copies, lanes, states, blocks = plan
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_selective_scan(
            delta.data_ptr(), xi.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a_mat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), n_, s, d, n,
            int(copies == "vector"), lanes, states, blocks, stream)
    _build.check(err, "mamba_scan_fused")
    mamba_scan_fused.launches += 1
    mamba_scan_fused.last_plan = plan
    return y, h_last


class _SelectiveScan(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain
    version and differentiates it (see the module docstring)."""

    @staticmethod
    def forward(ctx, delta, xi, bm, cm, a_mat, h0):
        ctx.save_for_backward(delta, xi, bm, cm, a_mat, h0)
        return _launch(delta, xi, bm, cm, a_mat, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_()
                   for t in saved]
            outs = R.mamba_scan_fused_ref(*ins)
            live = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(outs, live, (grad_y, grad_h),
                                             allow_unused=True))
        return tuple(None if t is None else next(grads) for t in ins)


mamba_scan_fused.launches = 0
mamba_scan_fused.last_plan = None
