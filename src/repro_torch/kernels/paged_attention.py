"""Paged attention over the block pool: the Hopper kernels and their doors.

Two kernels, with the JAX kernels' signatures and layouts (pools
``(N, P, Hkv, D)``, block tables ``(B, NB)`` int32 already in range, and
on int8 pools per-row scales ``(N, P, Hkv)`` f32):

  * ``fused_paged_decode_grouped`` -- RoPE on q and the fresh k, the fresh
    K/V row written into its page (quantized with its row scale on int8
    pools), and one-token GQA attention over the slot's pages
    (``csrc/fused_paged_decode.cu``);
  * ``paged_prefill_attention_grouped`` -- S fresh queries at
    ``offset..offset+S-1`` attending every mapped page causally, int8
    pages dequantized in the tile loader (``csrc/paged_prefill.cu``).
    ``paged_verify_attention_grouped`` runs the same kernel with a
    per-slot ``(B,)`` offset: the speculative verify window, which the
    JAX package computes with its jnp reference only.  The two keep
    separate launch counters.

On CPU tensors each runs its plain version from ``kernels/ref.py``; on
CUDA tensors it launches its kernel or raises.  Unlike the JAX kernel,
which returns fresh pool buffers through input/output aliasing, the fused
decode writes the fresh rows (and scales) into the pools IN PLACE (both
paths).

Shape contract on CUDA (checked before every launch): every operand
contiguous and on one device; q and the fresh rows share one activation
dtype in {float32, bfloat16}; the pools hold either that dtype or int8,
and int8 pools come with f32 scales of shape (N, P, Hkv) (fp pools with
none); D in {64, 128}; block tables (B, NB) and positions / offsets (B,)
int32; for the fused decode G = H / Hkv in {1, 2, 4, 8}.  Table entries
must lie in [0, N) and positions and offsets be >= 0: the front doors
(``backend/dispatch.py``) clip the tables, and reading the values here
would cost a device sync per launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


def _check_common(q, k_pages, v_pages, block_tables, k_scales, v_scales, b,
                  hk, d, tensors):
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} outside the kernel's {HEAD_DIMS}")
    if k_pages.dim() != 4 or k_pages.shape[2:] != (hk, d) \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not hold (N, P, {hk}, "
                         f"{d}) pages")
    _build.dtype_code(q.dtype)
    if k_pages.dtype != v_pages.dtype \
            or k_pages.dtype not in (q.dtype, torch.int8):
        raise ValueError("the pools must share q's dtype, or be int8")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scales is not None) \
            or (k_scales is None) != (v_scales is None):
        raise ValueError("int8 pools take k_scales/v_scales, fp pools none")
    if quantized:
        for sc in (k_scales, v_scales):
            if sc.dtype != torch.float32 or sc.shape != k_pages.shape[:3]:
                raise ValueError(f"scales must be float32 "
                                 f"{tuple(k_pages.shape[:3])}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
        tensors = tensors + (k_scales, v_scales)
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be int32 (B={b}, NB), got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged attention operands must be contiguous")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged attention operands must share one device")


def check_fused_decode_contract(q, k_new, v_new, k_pages, v_pages,
                                block_tables, positions, k_scales=None,
                                v_scales=None):
    """Raise ValueError outside the fused decode kernel's contract;
    returns (B, Hkv, G, D, P, NB)."""
    if q.dim() != 4:
        raise ValueError("q must be (B, Hkv, G, D)")
    b, hk, g, d = q.shape
    if g not in DECODE_GROUPS:
        raise ValueError(f"{g} query heads per kv head outside the "
                         f"kernel's {DECODE_GROUPS}")
    if k_new.shape != (b, hk, d) or v_new.shape != (b, hk, d):
        raise ValueError(f"k_new/v_new must be ({b}, {hk}, {d})")
    if not (k_new.dtype == v_new.dtype == q.dtype):
        raise ValueError("q, k_new, v_new must share one dtype")
    if positions.dtype != torch.int32 or positions.shape != (b,):
        raise ValueError(f"positions must be int32 of shape ({b},)")
    _check_common(q, k_pages, v_pages, block_tables, k_scales, v_scales, b,
                  hk, d, (q, k_new, v_new, k_pages, v_pages, block_tables,
                          positions))
    return b, hk, g, d, k_pages.shape[1], block_tables.shape[1]


def check_paged_prefill_contract(q, k_pages, v_pages, block_tables, offset,
                                 k_scales=None, v_scales=None):
    """Raise ValueError outside the paged prefill kernel's contract.
    ``offset`` is an int (one window for every slot) or a (B,) int32
    tensor (one per slot).  Returns (B, Hkv, G, S, D, P, NB)."""
    if q.dim() != 5:
        raise ValueError("q must be (B, Hkv, G, S, D)")
    b, hk, g, s, d = q.shape
    tensors = (q, k_pages, v_pages, block_tables)
    if torch.is_tensor(offset):
        if offset.dtype != torch.int32 or offset.shape != (b,):
            raise ValueError(f"per-slot offsets must be int32 of shape "
                             f"({b},), got {offset.dtype} "
                             f"{tuple(offset.shape)}")
        tensors = tensors + (offset,)
    elif int(offset) < 0:
        raise ValueError(f"offset {offset} must be >= 0")
    _check_common(q, k_pages, v_pages, block_tables, k_scales, v_scales, b,
                  hk, d, tensors)
    return b, hk, g, s, d, k_pages.shape[1], block_tables.shape[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_paged_decode_grouped(q, k_new, v_new, k_pages, v_pages,
                               block_tables, positions, *, theta,
                               softcap=0.0, k_scales=None, v_scales=None):
    """q: (B, Hkv, G, D) un-roped; k_new/v_new: (B, Hkv, D) un-roped fresh
    K/V; pools (N, P, Hkv, D); block_tables (B, NB) int32 in range;
    positions (B,) int32 write position per slot; k_scales/v_scales
    (N, P, Hkv) f32 on int8 pools.  Returns ``(out (B, Hkv, G, D),
    k_pages, v_pages, k_scales, v_scales)`` with the fresh rows written
    into the pools in place."""
    if q.device.type == "cpu":
        return R.fused_paged_decode_ref(q, k_new, v_new, k_pages, v_pages,
                                        block_tables, positions,
                                        theta=theta, softcap=softcap,
                                        k_scales=k_scales,
                                        v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no fused paged decode kernel for {q.device}")
    b, hk, g, d, page, nb = check_fused_decode_contract(
        q, k_new, v_new, k_pages, v_pages, block_tables, positions,
        k_scales, v_scales)
    lib = _build.load_library()
    inv_freq = R.rope_inv_freq(d, theta, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_fused_paged_decode(
            _build.dtype_code(q.dtype), q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scales), _ptr(v_scales), block_tables.data_ptr(),
            positions.data_ptr(), inv_freq.data_ptr(), out.data_ptr(), b,
            hk, g, d, page, nb, float(softcap), 1.0 / math.sqrt(d), stream)
    _build.check(err, "fused_paged_decode_grouped")
    fused_paged_decode_grouped.launches += 1
    return out, k_pages, v_pages, k_scales, v_scales


def _launch_paged_prefill(name, q, k_pages, v_pages, block_tables, offsets,
                          softcap, k_scales, v_scales):
    """Launch ``csrc/paged_prefill.cu`` with per-slot offsets (B,) int32."""
    b, hk, g, s, d, page, nb = check_paged_prefill_contract(
        q, k_pages, v_pages, block_tables, offsets, k_scales, v_scales)
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_paged_prefill(
            _build.dtype_code(q.dtype), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), _ptr(k_scales), _ptr(v_scales),
            block_tables.data_ptr(), offsets.data_ptr(), out.data_ptr(), b,
            hk, g, s, d, page, nb, float(softcap), 1.0 / math.sqrt(d),
            stream)
    _build.check(err, name)
    return out


def paged_prefill_attention_grouped(q, k_pages, v_pages, block_tables,
                                    offset, *, softcap=0.0, k_scales=None,
                                    v_scales=None):
    """q: (B, Hkv, G, S, D) at positions offset..offset+S-1 (K/V already in
    the pool); block_tables (B, NB) int32 in range; offset int;
    k_scales/v_scales (N, P, Hkv) f32 on int8 pools.  Returns
    (B, Hkv, G, S, D)."""
    if q.device.type == "cpu":
        return R.paged_prefill_attention_ref(
            q, k_pages, v_pages, block_tables, offset, softcap=softcap,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no paged prefill kernel for {q.device}")
    if int(offset) < 0:
        raise ValueError(f"offset {offset} must be >= 0")
    offsets = torch.full((q.shape[0],), int(offset), dtype=torch.int32,
                         device=q.device)
    out = _launch_paged_prefill("paged_prefill_attention_grouped", q,
                                k_pages, v_pages, block_tables, offsets,
                                softcap, k_scales, v_scales)
    paged_prefill_attention_grouped.launches += 1
    return out


def paged_verify_attention_grouped(q, k_pages, v_pages, block_tables,
                                   offset, *, softcap=0.0, k_scales=None,
                                   v_scales=None):
    """The speculative verify window: q (B, Hkv, G, S, D) with slot b's S
    queries at ``offset[b] .. offset[b]+S-1`` (their K/V already in the
    pool); offset (B,) int32 >= 0.  Same kernel as the paged prefill,
    counted apart.  Returns (B, Hkv, G, S, D)."""
    if q.device.type == "cpu":
        return R.paged_verify_attention_ref(
            q, k_pages, v_pages, block_tables, offset, softcap=softcap,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no paged verify kernel for {q.device}")
    out = _launch_paged_prefill("paged_verify_attention_grouped", q,
                                k_pages, v_pages, block_tables, offset,
                                softcap, k_scales, v_scales)
    paged_verify_attention_grouped.launches += 1
    return out


fused_paged_decode_grouped.launches = 0
paged_prefill_attention_grouped.launches = 0
paged_verify_attention_grouped.launches = 0
