"""One-pass row norm: the hand-written Hopper kernel and its door.

``norm_onepass(x, scale, bias=None, *, kind="rmsnorm", eps=1e-6)``
normalizes every row of x (R, D) in f32 and casts back to x's dtype:
layernorm (variance ``mean((x - mu)^2)``, then scale and bias) when
``kind == "layernorm"``, rmsnorm for any other kind (bias unused), as the
JAX kernel of the same name does.  On CPU tensors it runs the plain
version (``ref.norm_onepass_ref``); on CUDA tensors it launches
``csrc/layernorm.cu`` or raises -- there is no fallback.  It has no
backward: asked for a gradient on a non-CPU input, it raises
(``_build.refuse_grad``).  It is reached
through ``dispatch_layernorm`` and the ``kernels.ops.norm_onepass``
alias; the models normalize in plain PyTorch, as JAX's do in jnp.

The kernel has two paths, picked by ``norm_plan`` from shapes and
alignment alone (a dispatch by shape, not a fallback): ``vector`` keeps
each row in registers, read and written in 16-byte vectors, and needs D
a multiple of the vector width (8 bf16, 4 f32) and every operand on a
16-byte boundary; ``scalar`` (one block a row, staged in shared memory)
takes every other shape.  ``norm_onepass.last_plan`` records the plan of
the last CUDA launch.

Shape contract on CUDA: x (R, D) contiguous float32 or bfloat16 with
R >= 1 and 1 <= D <= 32,768; scale and bias (None or) contiguous (D,),
each float32 or x's dtype; all on one device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

MAX_D = 32_768
VEC_THREADS = 256      # a block of the vector path, unless a row needs more
VALUES = 16            # values of x a thread of the vector path holds
MAX_ROW_THREADS = 1024


def norm_plan(r, d, dtype, aligned=True, sms=132):
    """``(path, vectors, threads_per_row, rows_per_block, blocks)`` of a
    CUDA launch, from shapes and alignment alone (``aligned``: every
    operand starts on a 16-byte boundary).  The vector path gives each
    thread 16 values of its row (two 16-byte vectors of bf16, four of
    f32), twice that where a row would need more than 1,024 threads
    (D > 16,384), and a row as many threads as that takes (a multiple of
    32); blocks of up to 256 threads take several rows of a narrow D;
    one block a row group, at most as many as the card holds at once
    (2,048 threads an SM), which then walk the rows in a loop.  The
    scalar path takes one 256-thread block a row."""
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if d % vec or not aligned:
        return "scalar", 0, 256, 1, r
    nvec = d // vec
    nv = VALUES // vec
    while -(-nvec // nv) > MAX_ROW_THREADS:
        nv *= 2
    tpr = -(-nvec // (32 * nv)) * 32
    rpb = max(1, min(8, VEC_THREADS // tpr))
    blocks = min(-(-r // rpb), sms * max(1, 2048 // (tpr * rpb)))
    return "vector", nv, tpr, rpb, blocks


def check_norm_contract(x, scale, bias=None):
    """Raise ValueError outside the CUDA kernel's contract; returns
    (R, D)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, D), got {tuple(x.shape)}")
    r, d = x.shape
    if r < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"R={r}, D={d}: R must be >= 1 and D in "
                         f"[1, {MAX_D}]")
    _build.dtype_code(x.dtype)
    tensors = (x, scale) if bias is None else (x, scale, bias)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (d,)
                              or t.dtype not in (x.dtype, torch.float32)):
            raise ValueError(f"{name} must be ({d},) of {x.dtype} or "
                             f"float32, got {t.dtype} {tuple(t.shape)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("norm operands must be contiguous")
    if any(t.device != x.device for t in tensors):
        raise ValueError("norm operands must share one device")
    return r, d


def norm_onepass(x, scale, bias=None, *, kind="rmsnorm", eps=1e-6):
    """x (R, D) row-normalized -> (R, D) in x's dtype."""
    if x.device.type == "cpu":
        return R.norm_onepass_ref(x, scale, bias, kind=kind, eps=eps)
    _build.refuse_grad("norm_onepass", (x, scale, bias))
    if x.device.type != "cuda":
        raise ValueError(f"no norm kernel for {x.device}")
    r, d = check_norm_contract(x, scale, bias)
    lib = _build.load_library()
    out = torch.empty_like(x)
    layernorm = kind == "layernorm"
    operands = (x, scale) if bias is None or not layernorm else \
        (x, scale, bias)
    plan = norm_plan(r, d, x.dtype,
                     all(t.data_ptr() % 16 == 0 for t in operands),
                     _build.sm_count(x.device))
    _, nv, tpr, rpb, blocks = plan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_norm_onepass(
            _build.dtype_code(x.dtype), x.data_ptr(), scale.data_ptr(),
            _build.dtype_code(scale.dtype),
            None if bias is None else bias.data_ptr(),
            0 if bias is None else _build.dtype_code(bias.dtype),
            out.data_ptr(), r, d, int(layernorm), float(eps), nv, tpr, rpb,
            blocks, stream)
    _build.check(err, "norm_onepass")
    norm_onepass.launches += 1
    norm_onepass.last_plan = plan
    return out


norm_onepass.launches = 0
norm_onepass.last_plan = None
