"""Fused matmul + epilogue: the hand-written Hopper kernel and its door.

``matmul_fused(x, w, bias=None, *, activation="none", out_dtype=None)``
computes ``act(x @ w + bias)`` with an f32 accumulator and one cast to
``out_dtype`` (default ``x.dtype``), as the JAX kernel of the same name
does.  On CPU tensors it runs the plain version (``ref.matmul_fused_ref``);
on CUDA tensors it launches ``csrc/fused_matmul.cu`` or raises -- there is
no fallback.  It has no backward: asked for a gradient on a non-CPU
input, it raises (``_build.refuse_grad``).  It is reached through
``dispatch_matmul`` and the ``kernels.ops.matmul_fused`` alias; no model calls it, as in JAX.

The kernel has five paths, picked by ``matmul_plan`` from shapes and
alignment alone (a dispatch by shape, not a fallback: a failed build or
launch raises): ``wgmma`` (bf16, M > 16: TMA ring into Hopper's wgmma),
``split_k`` (bf16, M <= 16: the weight streamed by blocks over K ranges,
an f32 workspace allocated here and a reduce pass when K splits),
``fma_tile`` (f32: 128 x 128 CUDA-core tiles, never TF32) -- these three
need K and N multiples of 8 and x and w on 16-byte boundaries -- and for
every other shape ``wmma`` (bf16) and ``fma`` (f32), with masked loads.
``matmul_fused.last_plan`` records the ``(path, splits, split_rows)``
of the last CUDA launch.

Shape contract on CUDA: x (M, K) and w (K, N) contiguous, both float32 or
both bfloat16, 1 <= M <= 4,194,240 and N, K >= 1 (any value: the kernel
masks ragged edges; the TPU kernel's block divisibility is its tiling);
bias None or contiguous (N,) of x's dtype or float32; ``out_dtype``
float32 or bfloat16; activation one of none, gelu (tanh form), silu,
relu2; all on one device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

ACTIVATION_CODES = {a: i for i, a in enumerate(R.ACTIVATIONS)}
MAX_M = 65_535 * 64        # grid.y of 64-row tiles
PATHS = ("wmma", "fma", "wgmma", "split_k", "fma_tile")   # the C codes 0-4
SPLIT_K_MAX_M = 16         # rows of x that the split-K path takes
SPLIT_K_COLS = 256         # columns of a split-K block
SPLIT_K_ROWS = 32          # weight rows of a split-K stage
MAX_K_SPLITS = 32


def matmul_plan(m, n, k, dtype, aligned=True, sms=132):
    """``(path, splits, split_rows)`` of a CUDA launch, from shapes and
    alignment alone (``aligned``: x and w start on 16-byte boundaries).
    split_k blocks take ``split_rows`` rows of K each (a multiple of the
    32-row stage), enough splits that the column blocks fill ``sms`` SMs
    about four times over, at most 32; every other path takes the whole
    of K in one block."""
    fast = aligned and n % 8 == 0 and k % 8 == 0
    if dtype == torch.float32:
        return ("fma_tile" if fast else "fma"), 1, k
    if not fast:
        return "wmma", 1, k
    if m > SPLIT_K_MAX_M:
        return "wgmma", 1, k
    cols = -(-n // SPLIT_K_COLS)
    want = max(1, min(MAX_K_SPLITS, -(-4 * sms // cols),
                      -(-k // SPLIT_K_ROWS)))
    rows = -(-(-(-k // want)) // SPLIT_K_ROWS) * SPLIT_K_ROWS
    return "split_k", -(-k // rows), rows


def check_matmul_contract(x, w, bias=None, *, activation="none",
                          out_dtype=None):
    """Raise ValueError outside the CUDA kernel's contract; returns
    (M, K, N)."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}; choose one of "
                         f"{tuple(ACTIVATION_CODES)}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x (M, K) and w (K, N) do not chain: "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if min(m, k, n) < 1 or m > MAX_M:
        raise ValueError(f"M={m}, K={k}, N={n}: each must be >= 1 and M <= "
                         f"{MAX_M}")
    if x.dtype != w.dtype:
        raise ValueError(f"x and w must share one dtype, got {x.dtype} and "
                         f"{w.dtype}")
    _build.dtype_code(x.dtype)
    _build.dtype_code(out_dtype or x.dtype)
    tensors = (x, w)
    if bias is not None:
        if bias.shape != (n,) or bias.dtype not in (x.dtype, torch.float32):
            raise ValueError(f"bias must be ({n},) of {x.dtype} or float32, "
                             f"got {bias.dtype} {tuple(bias.shape)}")
        tensors += (bias,)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("fused matmul operands must be contiguous")
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused matmul operands must share one device")
    return m, k, n


def matmul_fused(x, w, bias=None, *, activation="none", out_dtype=None):
    """x (M, K) @ w (K, N) [+ bias (N,)] with the fused epilogue ->
    (M, N) in ``out_dtype`` (default ``x.dtype``)."""
    if x.device.type == "cpu":
        return R.matmul_fused_ref(x, w, bias, activation=activation,
                                  out_dtype=out_dtype)
    _build.refuse_grad("matmul_fused", (x, w, bias))
    if x.device.type != "cuda":
        raise ValueError(f"no fused matmul kernel for {x.device}")
    m, k, n = check_matmul_contract(x, w, bias, activation=activation,
                                    out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    lib = _build.load_library()
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = matmul_plan(m, n, k, x.dtype, aligned,
                       _build.sm_count(x.device))
    path, splits, rows = plan
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) \
        if splits > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_matmul_fused(
            _build.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            0 if bias is None else _build.dtype_code(bias.dtype),
            out.data_ptr(), _build.dtype_code(out_dtype), m, n, k,
            ACTIVATION_CODES[activation], PATHS.index(path), splits, rows,
            None if ws is None else ws.data_ptr(), stream)
    _build.check(err, "matmul_fused")
    matmul_fused.launches += 1
    matmul_fused.last_plan = plan
    return out


matmul_fused.launches = 0
matmul_fused.last_plan = None
