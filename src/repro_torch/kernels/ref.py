"""Plain PyTorch versions of the port's kernels.

Each function computes, op for op, what its twin in the JAX package's
``kernels/ref.py`` computes, with the same signature and layouts, so the
tests can hold the two against each other on the same inputs.  The CPU
path of every kernel front door runs these; ``chip_smoke.py`` calls them
on CUDA tensors as the reference for the hand-written kernels.

Where JAX clamps an out-of-range gather or drops an out-of-range scatter
(``mode="drop"``), PyTorch raises: every such index is clipped or masked
explicitly here.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def rope_inv_freq(d: int, theta: float, device) -> torch.Tensor:
    """(d/2,) f32 inverse frequencies ``1/theta^(2i/d)``, built exactly as
    the JAX ``decode_rope_ref`` / ``layers.rope_freqs`` build them.  The
    fused decode kernel takes this table from here, so its angles are
    bit-equal to the plain version's."""
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (theta ** exps)


def decode_rope_ref(x, positions, theta):
    """Standard RoPE. x: (B, S, H, D); positions: (B, S).  Rotate-half
    pairs (c, c + D/2), f32 math, result cast back to ``x.dtype``."""
    b, s, h, d = x.shape
    inv = rope_inv_freq(d, theta, x.device)
    angles = positions.to(torch.float32)[..., None] * inv      # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]                     # (B,S,1,d/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def quantize_int8_rows(x):
    """Symmetric per-row int8 quantization over the last axis.

    x: (..., D) -> (q int8 (..., D), scale f32 (...,)).  Zero rows get
    scale 1 so dequant is exact.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so ties quantize as on the JAX side.

    The scale is the correctly rounded quotient amax / 127 on every
    device, as the kernels compute it (``__fdiv_rn``).  The divisor is a
    tensor on purpose: PyTorch's CUDA kernel for ``tensor / 127.0``
    multiplies by the rounded reciprocal instead, which is 1 ulp off for
    a few percent of inputs (as is ``amax / 127.0`` under ``jax.jit``,
    which XLA rewrites the same way)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    """Inverse of ``quantize_int8_rows``: (..., D) int8 + (...,) f32."""
    return q.to(torch.float32) * scale[..., None]


def _gather_pages(k_pages, v_pages, bt, k_scales, v_scales, b, nb, p, hk, d):
    """Gather (and dequantize, when scales are given) pool pages through
    in-range block tables into logical-ordered (B, NB*P, Hkv, D) f32."""
    k = k_pages[bt].reshape(b, nb * p, hk, d).to(torch.float32)
    v = v_pages[bt].reshape(b, nb * p, hk, d).to(torch.float32)
    if k_scales is not None:
        k = k * k_scales[bt].reshape(b, nb * p, hk)[..., None]
        v = v * v_scales[bt].reshape(b, nb * p, hk)[..., None]
    return k, v


def flash_attention_ref(q, k, v, q_pos, k_pos, k_valid, *, causal=True,
                        window=0, softcap=0.0):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D).  Plain softmax;
    a row with no admissible key gives 0."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    groups = h // hkv
    k = torch.repeat_interleave(k, groups, dim=1)
    v = torch.repeat_interleave(v, groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    rel = q_pos[:, None] - k_pos[None, :]
    ok = k_valid[None, :] > 0
    if causal:
        ok = ok & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    s = torch.where(ok, s, NEG_INF)
    any_ok = torch.any(ok, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    out = torch.where(any_ok[None, None, :, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        softcap=0.0, k_scales=None, v_scales=None):
    """One-token decode attention over a paged pool.  q: (B, Hkv, G, D);
    pools (N, P, Hkv, D); block_tables (B, NB) int32 (out-of-range entries
    are clipped to a page the length mask hides); lengths (B,).
    Returns (B, Hkv, G, D)."""
    b, hk, g, d = q.shape
    n, p = k_pages.shape[:2]
    nb = block_tables.shape[1]
    dt = q.dtype
    bt = torch.clamp(block_tables.long(), 0, n - 1)
    k, v = _gather_pages(k_pages, v_pages, bt, k_scales, v_scales,
                         b, nb, p, hk, d)                     # (B, T, Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", q.to(torch.float32), k) / math.sqrt(d)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(nb * p, device=q.device)
    ok = kpos[None, :] < lengths.to(q.device)[:, None]        # (B, T)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs.to(dt), v.to(dt))
    return out.to(dt)


def fused_paged_decode_ref(q, k_new, v_new, k_pages, v_pages, block_tables,
                           positions, *, theta, softcap=0.0, k_scales=None,
                           v_scales=None):
    """RoPE + page write + decode attention in one step.

    q: (B, Hkv, G, D) un-roped; k_new/v_new: (B, Hkv, D) un-roped fresh
    K/V; pools (N, P, Hkv, D); block_tables (B, NB) int32 in range;
    positions (B,) int32 write position per slot; k_scales/v_scales
    (N, P, Hkv) f32 on int8 pools (None on fp).  Ropes q and k_new at
    ``positions`` (the roped key comes back in the activation dtype),
    writes the fresh row into page ``bt[b, min(pos // P, NB-1)]`` row
    ``pos % P`` -- cast to the pool dtype, or on int8 pools quantized
    with its row scale -- then attends at ``lengths = positions + 1``.

    Unlike the JAX version, which returns new pools, this one writes the
    fresh rows (and scales) into the given tensors IN PLACE and returns
    them: ``(out, k_pages, v_pages, k_scales, v_scales)``."""
    b, hk, g, d = q.shape
    page = k_pages.shape[1]
    nb = block_tables.shape[1]
    cdt = k_pages.dtype
    pos_bs = positions[:, None]
    qr = decode_rope_ref(q.reshape(b, 1, hk * g, d), pos_bs,
                         theta).reshape(b, hk, g, d)
    kr = decode_rope_ref(k_new[:, None], pos_bs, theta)[:, 0]   # (B,Hkv,D)
    blk = torch.clamp(positions.long() // page, 0, nb - 1)
    pages = torch.gather(block_tables.long(), 1, blk[:, None])[:, 0]
    rows = positions.long() % page
    if k_scales is not None:
        kq, ks = quantize_int8_rows(kr)
        vq, vs = quantize_int8_rows(v_new)
        k_pages[pages, rows] = kq
        v_pages[pages, rows] = vq
        k_scales[pages, rows] = ks
        v_scales[pages, rows] = vs
    else:
        k_pages[pages, rows] = kr.to(cdt)
        v_pages[pages, rows] = v_new.to(cdt)
    out = paged_attention_ref(qr, k_pages, v_pages, block_tables,
                              positions + 1, softcap=softcap,
                              k_scales=k_scales, v_scales=v_scales)
    return out, k_pages, v_pages, k_scales, v_scales


def _paged_window_attention(q, k_pages, v_pages, block_tables, qpos, *,
                            softcap, k_scales, v_scales):
    """S queries per slot at absolute positions ``qpos`` ((S,) shared or
    (B, S) per slot) attending every mapped position ``kpos <= qpos``."""
    b, hk, g, s, d = q.shape
    n, p = k_pages.shape[:2]
    nb = block_tables.shape[1]
    dt = q.dtype
    bt = torch.clamp(block_tables.long(), 0, n - 1)
    k, v = _gather_pages(k_pages, v_pages, bt, k_scales, v_scales,
                         b, nb, p, hk, d)                     # (B, T, Hkv, D)
    sc = torch.einsum("bhgsd,bthd->bhgst", q.to(torch.float32),
                      k) / math.sqrt(d)
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    kpos = torch.arange(nb * p, device=q.device)                # (T,)
    ok = kpos <= qpos[..., None]                                # (.., S, T)
    if ok.dim() == 3:                                           # per slot
        ok = ok[:, None, None]
    sc = torch.where(ok, sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgst,bthd->bhgsd", probs.to(dt), v.to(dt))
    return out.to(dt)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables, offset,
                                *, softcap=0.0, k_scales=None,
                                v_scales=None):
    """Suffix/chunk prefill attention over a paged pool.  q: (B, Hkv, G, S,
    D) at positions ``offset .. offset+S-1`` (their K/V already in the
    pool); block_tables (B, NB) over every mapped block; offset int;
    k_scales/v_scales (N, P, Hkv) on int8 pools.  Pure causal mask
    ``kpos <= qpos``.  Returns (B, Hkv, G, S, D)."""
    qpos = int(offset) + torch.arange(q.shape[3], device=q.device)
    return _paged_window_attention(q, k_pages, v_pages, block_tables, qpos,
                                   softcap=softcap, k_scales=k_scales,
                                   v_scales=v_scales)


def paged_verify_attention_ref(q, k_pages, v_pages, block_tables, offset,
                               *, softcap=0.0, k_scales=None,
                               v_scales=None):
    """Speculative-verify attention over a paged pool: as
    ``paged_prefill_attention_ref`` with a PER-SLOT ``offset`` (B,) --
    slot b's S-token window sits at ``offset[b] .. offset[b]+S-1``."""
    s = q.shape[3]
    qpos = offset.to(device=q.device, dtype=torch.int64)[:, None] \
        + torch.arange(s, device=q.device)[None, :]            # (B, S)
    return _paged_window_attention(q, k_pages, v_pages, block_tables, qpos,
                                   softcap=softcap, k_scales=k_scales,
                                   v_scales=v_scales)


ACTIVATIONS = ("none", "gelu", "silu", "relu2")   # the kernel's codes 0-3


def _activation(acc, activation):
    """The fused matmul's epilogue activation on an f32 tensor: gelu is the
    tanh form (``jax.nn.gelu(approximate=True)``), relu2 is relu squared.
    An unknown name raises, as the Pallas epilogue does (the JAX ref
    returns the plain product instead)."""
    if activation == "gelu":
        return torch.nn.functional.gelu(acc, approximate="tanh")
    if activation == "silu":
        return torch.nn.functional.silu(acc)
    if activation == "relu2":
        return torch.square(torch.clamp_min(acc, 0.0))
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}; choose one "
                         f"of {ACTIVATIONS}")
    return acc


def matmul_fused_ref(x, w, bias=None, *, activation="none", out_dtype=None):
    """x (..., K) @ w (K, N) in f32, then + bias (N,) and the activation
    in f32, cast once to ``out_dtype`` (default ``x.dtype``)."""
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return _activation(acc, activation).to(out_dtype or x.dtype)


def norm_onepass_ref(x, scale, bias=None, *, kind="rmsnorm", eps=1e-6):
    """Row norm over the last axis in f32, cast back to ``x.dtype``:
    layernorm (variance ``mean((x - mu)^2)``, then scale and bias) when
    ``kind == "layernorm"``, rmsnorm (``x * rsqrt(mean(x^2) + eps) *
    scale``, bias unused) for any other kind, as in both JAX functions."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale.to(torch.float32)
        if bias is not None:
            y = y + bias.to(torch.float32)
    else:
        var = torch.square(xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def linear_scan_ref(a, b, h0=None):
    """a, b: (N, S, F) -> every state h_t = a_t * h_{t-1} + b_t, (N, S, F)
    in ``a.dtype``, by a plain sequential scan with an f32 carry from
    ``h0`` (N, F) (zeros when None).  The product and the sum are two
    separately rounded f32 ops, so the CUDA kernel (``__fmul_rn`` then
    ``__fadd_rn``) equals this bit for bit."""
    n, s, f = a.shape
    h = (torch.zeros((n, f), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    af, bf = a.to(torch.float32), b.to(torch.float32)
    out = torch.empty((n, s, f), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def mamba_scan_fused_ref(delta, xi, bm, cm, a_mat, h0=None):
    """The selective scan of mamba, memory-lean: delta, xi (N, S, di) f32;
    bm, cm (N, S, n) f32; a_mat (di, n) f32; h0 (N, di, n) f32 or None
    (zeros).  Returns (y (N, S, di) with ``y_t = C_t . h_t``, h_last
    (N, di, n)), as the JAX ``mamba_scan_fused``.  It steps through t with
    the arithmetic of the materialized route (``a_t = exp(delta_t A)``,
    ``b_t = (delta_t x_t) B_t``, ``h = a_t h + b_t`` as two separately
    rounded f32 ops, ``y_t = h C_t``), holding one (N, di, n) state and
    never a (N, S, di, n) tensor."""
    n_, s, di = delta.shape
    h = (torch.zeros((n_, di, a_mat.shape[1]), dtype=torch.float32,
                     device=delta.device)
         if h0 is None else h0.to(torch.float32))
    y = torch.empty((n_, s, di), dtype=torch.float32, device=delta.device)
    for t in range(s):
        d = delta[:, t]
        a = torch.exp(d[..., None] * a_mat)
        b = (d * xi[:, t])[..., None] * bm[:, t, None, :]
        h = a * h + b
        y[:, t] = torch.matmul(h, cm[:, t, :, None])[..., 0]
    return y, h
