"""Kernel front doors: the layout adapters between the model and the kernels.

The device decides the path, and nothing else does: a CUDA tensor goes to
the hand-written kernel (which raises outside its shape contract), a CPU
tensor to the kernel's plain PyTorch version.  There is no environment
override and no fallback from a kernel to its plain version.

Each attention ``dispatch_*`` takes the model layout (B, S, H, D), hands
the kernel the JAX kernel layout, and clips the block-table sentinel into
range the way the JAX dispatch does (``jnp.clip(block_tables, 0, n - 1)``):
PyTorch raises on the out-of-range gathers JAX clamps.  The matmul and
norm doors take leading batch dimensions, as JAX's CPU path does, and
flatten them to the kernels' 2-D rows.
"""
from __future__ import annotations

import torch


def kernel_path(device) -> str:
    """What the hot kernels run as on ``device``: "cuda" (hand-written
    kernels) or "cpu-plain" (their plain PyTorch versions)."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu-plain"


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def dispatch_flash_attention(q, k, v, *, q_pos, k_pos, k_valid=None,
                             causal=True, window=0, softcap=0.0):
    """(B,S,H,D) model layout -> (B,H,S,D) kernel layout; returns
    (B, S, H*D).  q_pos (S,), k_pos (T,), k_valid (T,) bool/int or None."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    dev = q.device
    qk = q.transpose(1, 2).contiguous()
    kk = k.transpose(1, 2).contiguous()
    vk = v.transpose(1, 2).contiguous()
    if k_valid is None:
        k_valid = torch.ones((kk.shape[2],), dtype=torch.int32, device=dev)
    out = flash_attention_bhsd(qk, kk, vk, _i32(q_pos, dev),
                               _i32(k_pos, dev), _i32(k_valid, dev),
                               causal=causal, window=window, softcap=softcap)
    return out.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)


# ---------------------------------------------------------------------------
# paged attention (the block-pool KV cache)
# ---------------------------------------------------------------------------

def _grouped(q, hk):
    """(B, S, H, D) model layout -> (B, Hkv, G, S, D) kernel layout."""
    b, s, h, d = q.shape
    return q.transpose(1, 2).reshape(b, hk, h // hk, s, d).contiguous()


def _ungrouped(out, b, s):
    """(B, Hkv, G, S, D) kernel layout -> (B, S, H*D) model layout."""
    hk, g, d = out.shape[1], out.shape[2], out.shape[4]
    return out.reshape(b, hk * g, s, d).transpose(1, 2).reshape(
        b, s, hk * g * d)


def _clip_tables(block_tables, n):
    return torch.clamp(block_tables, 0, n - 1).to(torch.int32).contiguous()


def dispatch_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                             softcap=0.0, k_scales=None, v_scales=None):
    """One-token decode attention through per-slot block tables, the
    fresh row already in its page.  q (B, 1, H, D) model layout ->
    (B, 1, H*D); block_tables (B, NB) may carry out-of-range entries for
    unmapped blocks (clipped here; rows at or past ``lengths`` (B,) are
    masked regardless); k_scales/v_scales (N, P, Hkv) f32 on int8 pools.
    Unlike the JAX dispatch, which sends int8 pools to its jnp reference,
    int8 pools go to the kernel too: it dequantizes in its loader."""
    from repro_torch.kernels.paged_attention import paged_attention_grouped
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"paged attention is a one-token path, got {s}")
    hk = k_pages.shape[2]
    qg = q[:, 0].reshape(b, hk, h // hk, d).contiguous()
    out = paged_attention_grouped(
        qg, k_pages, v_pages, _clip_tables(block_tables, k_pages.shape[0]),
        _i32(lengths, q.device), softcap=softcap, k_scales=k_scales,
        v_scales=v_scales)
    return out.reshape(b, s, h * d)


def dispatch_ring_decode(q, k_ring, v_ring, positions, *, softcap=0.0):
    """One-token per-slot decode over a sliding window's dense ring, the
    fresh row already written at row ``positions % W``.  q (B, 1, H, D)
    model layout, rings (B, W, Hkv, D) with W = min(max_seq, window), so
    every valid row lies inside the window -> (B, 1, H*D).

    JAX computes this with its plain ``_attend_block``; here it is the
    unfused paged decode over a view of the ring: slot b's W rows are one
    page of W rows (page b of the pool view, an identity block table of
    one entry), at lengths ``min(pos + 1, W)`` -- before the ring wraps
    its rows 0..pos are the slot's positions; after, all W rows are.
    Softmax is order-free, so the ring's rotation does not matter.  A
    slot at position -1 has length 0: the uniform mean of V over its W
    rows, as JAX's all-masked row gives."""
    b, w = k_ring.shape[:2]
    table = torch.arange(b, dtype=torch.int32,
                         device=q.device)[:, None]
    lengths = torch.clamp(torch.as_tensor(positions, device=q.device) + 1,
                          max=w)
    return dispatch_paged_attention(q, k_ring, v_ring, table, lengths,
                                    softcap=softcap)


def dispatch_fused_paged_decode(q, k_new, v_new, k_pages, v_pages,
                                block_tables, positions, *, theta,
                                softcap=0.0, k_scales=None, v_scales=None):
    """Fused RoPE + page write + decode attention.  q arrives UN-roped in
    model layout (B, 1, H, D), k_new/v_new as (B, 1, Hkv, D); positions
    (B,) is each slot's write position; k_scales/v_scales (N, P, Hkv) f32
    on int8 pools.  Returns ``(out (B, 1, H*D), k_pages, v_pages,
    k_scales, v_scales)``; the pools (and scales) are updated in place."""
    from repro_torch.kernels.paged_attention import fused_paged_decode_grouped
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"fused paged decode is a one-token path, got {s}")
    hk = k_pages.shape[2]
    qg = q[:, 0].reshape(b, hk, h // hk, d).contiguous()
    kn = k_new[:, 0].contiguous()
    vn = v_new[:, 0].contiguous()
    bt = _clip_tables(block_tables, k_pages.shape[0])
    out, kp, vp, ks, vs = fused_paged_decode_grouped(
        qg, kn, vn, k_pages, v_pages, bt, _i32(positions, q.device),
        theta=theta, softcap=softcap, k_scales=k_scales, v_scales=v_scales)
    return out.reshape(b, s, h * d), kp, vp, ks, vs


def dispatch_paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                     offset, *, softcap=0.0, k_scales=None,
                                     v_scales=None):
    """Suffix/chunk prefill attention through block tables: the fresh
    chunk's K/V are already in the pool.  q (B, S, H, D) -> (B, S, H*D);
    offset is the position of the first fresh query; k_scales/v_scales
    (N, P, Hkv) on int8 pools, dequantized inside the kernel."""
    from repro_torch.kernels.paged_attention import (
        paged_prefill_attention_grouped)
    b, s = q.shape[:2]
    out = paged_prefill_attention_grouped(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages,
        _clip_tables(block_tables, k_pages.shape[0]), int(offset),
        softcap=softcap, k_scales=k_scales, v_scales=v_scales)
    return _ungrouped(out, b, s)


def dispatch_paged_verify_attention(q, k_pages, v_pages, block_tables,
                                    offset, *, softcap=0.0, k_scales=None,
                                    v_scales=None):
    """Speculative-verify attention through per-slot block tables: each
    slot's S-token window (current token + drafted tokens) is already in
    the pool and attends its mapped prefix under a causal mask anchored
    at a PER-SLOT ``offset`` (B,).  q (B, S, H, D) -> (B, S, H*D).  The
    JAX package runs this as its jnp reference on every backend; on CUDA
    the port runs it on the paged prefill kernel."""
    from repro_torch.kernels.paged_attention import (
        paged_verify_attention_grouped)
    b, s = q.shape[:2]
    out = paged_verify_attention_grouped(
        _grouped(q, k_pages.shape[2]), k_pages, v_pages,
        _clip_tables(block_tables, k_pages.shape[0]),
        _i32(offset, q.device), softcap=softcap, k_scales=k_scales,
        v_scales=v_scales)
    return _ungrouped(out, b, s)


# ---------------------------------------------------------------------------
# linear recurrence scan
# ---------------------------------------------------------------------------

def dispatch_linear_scan(a, b, h0=None):
    """a, b: (N, S, F); h0 (N, F) or None.  Returns all states (N, S, F).
    The JAX door chooses between its Pallas kernel and a chunked
    associative scan by backend; here the device decides, as for every
    kernel."""
    from repro_torch.kernels.linear_scan import linear_scan
    return linear_scan(a.contiguous(), b.contiguous(),
                       None if h0 is None else h0.contiguous())


# ---------------------------------------------------------------------------
# fused matmul
# ---------------------------------------------------------------------------

def dispatch_matmul(x, w, bias=None, *, activation="none", out_dtype=None):
    """x (..., K) @ w (K, N) [+ bias (N,)] with the fused bias /
    activation / down-cast epilogue -> (..., N) in ``out_dtype`` (default
    ``x.dtype``)."""
    from repro_torch.kernels.fused_matmul import matmul_fused
    lead = x.shape[:-1]
    out = matmul_fused(x.reshape(-1, x.shape[-1]).contiguous(),
                       w.contiguous(),
                       None if bias is None else bias.contiguous(),
                       activation=activation, out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# one-pass norm
# ---------------------------------------------------------------------------

def dispatch_layernorm(x, scale, bias=None, *, kind="rmsnorm", eps=1e-6):
    """Row RMSNorm (any ``kind`` but "layernorm") or LayerNorm of x
    (..., D) in f32 -> (..., D) in x's dtype."""
    from repro_torch.kernels.layernorm import norm_onepass
    out = norm_onepass(x.reshape(-1, x.shape[-1]).contiguous(),
                       scale.contiguous(),
                       None if bias is None else bias.contiguous(),
                       kind=kind, eps=eps)
    return out.reshape(x.shape)


__all__ = ["kernel_path", "dispatch_flash_attention",
           "dispatch_paged_attention", "dispatch_ring_decode",
           "dispatch_fused_paged_decode",
           "dispatch_paged_prefill_attention",
           "dispatch_paged_verify_attention", "dispatch_matmul",
           "dispatch_layernorm", "dispatch_linear_scan"]
