"""Kernel front doors: the layout adapters between the model and the kernels.

The device decides the path, and nothing else does: a CUDA tensor goes to
the hand-written kernel (which raises outside its shape contract), a CPU
tensor to the kernel's plain PyTorch version.  There is no environment
override and no fallback from a kernel to its plain version.

Each ``dispatch_*`` takes the model layout (B, S, H, D), hands the kernel
the JAX kernel layout, and clips the block-table sentinel into range the
way the JAX dispatch does (``jnp.clip(block_tables, 0, n - 1)``): PyTorch
raises on the out-of-range gathers JAX clamps.
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


__all__ = ["kernel_path", "dispatch_flash_attention",
           "dispatch_fused_paged_decode", "dispatch_paged_prefill_attention",
           "dispatch_paged_verify_attention"]
