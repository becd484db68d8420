"""Transformer layer primitives of the port (functional, on torch tensors).

Counterparts of the JAX package's ``models/layers.py`` for the serving
path of a dense GQA decoder (yi-6b): RMSNorm, RoPE, GQA attention over a
dense or a paged KV cache, the gated MLP, embedding and LM head.

Conventions, as on the JAX side:
  * params are nested dicts of tensors, weights laid out (in, out) so the
    JAX weights bridge across unchanged (``repro_torch.bridge``);
  * activations ``x`` are (batch, seq, d_model);
  * projections are ``torch.matmul`` (the JAX side leaves them to XLA as
    einsums); attention softmax runs in f32.  In f32 the arithmetic is
    the JAX layer's; in bf16 the MLP's hidden product is rounded to bf16
    before the gate multiply, where JAX keeps it in f32.

Unlike JAX, which returns fresh cache arrays, the port writes K/V into the
cache tensors it is given, IN PLACE, and returns the same dict.
"""
from __future__ import annotations

import math

import torch

from repro_torch.backend import dispatch as kops
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref as R

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator, shape, in_axis_size, dtype, device):
    """N(0, 1) / sqrt(fan_in), drawn in f32 on ``device``, cast to dtype."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def init_norm(cfg: ModelConfig, device):
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=device)}


def init_attention(generator, cfg: ModelConfig, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = getattr(torch, cfg.param_dtype)
    return {"wq": dense_init(generator, (d, qd), d, dt, device),
            "wk": dense_init(generator, (d, kvd), d, dt, device),
            "wv": dense_init(generator, (d, kvd), d, dt, device),
            "wo": dense_init(generator, (qd, d), qd, dt, device)}


def init_mlp(generator, cfg: ModelConfig, device):
    dt = getattr(torch, cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": dense_init(generator, (d, f), d, dt, device),
            "wo": dense_init(generator, (f, d), f, dt, device),
            "wg": dense_init(generator, (d, f), d, dt, device)}


def init_embedding(generator, cfg: ModelConfig, device):
    dt = getattr(torch, cfg.param_dtype)
    return {"table": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                cfg.d_model, dt, device)}


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-6):
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S).  Standard RoPE (no M-RoPE)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    angles = positions.to(torch.float32)[..., None] * inv       # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attend_block(qg, k, v, cfg, q_pos, k_pos, k_valid, causal, window, dt):
    """Plain GQA attention.  qg: (B,S,Hk,G,D); positions shared across the
    batch ((S,), (T,), (T,)) or per batch element ((B,S), (B,T), (B,T))."""
    b, cq = qg.shape[:2]
    hd = qg.shape[-1]
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=qg.device)
    if causal:
        ok = ok & (rel >= 0)
    if window and window > 0:
        ok = ok & (rel < window)
    if k_valid is not None:
        ok = ok & k_valid[..., None, :]
    bias = torch.where(ok, 0.0, NEG_INF)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        scores = c * torch.tanh(scores / c)
    if bias.dim() == 3:                 # per-batch mask -> (B,1,1,S,T)
        bias = bias[:, None, None]
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(dt), v.to(dt))
    return out.reshape(b, cq, -1)


def _attend(q, k, v, cfg: ModelConfig, *, q_pos, k_pos, k_valid, causal,
            window, dt):
    """GQA attention with position-based masking.  q: (B,S,H,D); k, v:
    (B,T,Hkv,D).  Positions shared across the batch go through the flash
    front door (the Hopper kernel on CUDA, its plain version on CPU);
    per-slot positions take the plain batched-mask path."""
    b, s, h, hd = q.shape
    hk = k.shape[2]
    if q_pos.dim() == 1 and k_pos.dim() == 1:
        return kops.dispatch_flash_attention(
            q, k, v, q_pos=q_pos, k_pos=k_pos, k_valid=k_valid,
            causal=causal, window=window,
            softcap=cfg.attn_logit_softcap).to(dt)
    qg = q.reshape(b, s, hk, h // hk, hd)
    return _attend_block(qg, k, v, cfg, q_pos, k_pos, k_valid, causal,
                         window, dt)


def ring_k_positions(last, W: int):
    """Absolute position of every row of a ring cache whose newest token
    sits at ``last`` (a 0-d tensor, or (B, 1) for per-slot decode).
    Returns (k_pos, k_valid); rows not yet written are masked."""
    i = torch.arange(W, device=last.device)
    k_pos = last - torch.remainder(last - i, W)
    return k_pos, k_pos >= 0


def _paged_write(kv_cache, pages, rows, k, v):
    """Scatter fresh K/V rows into pool pages, in place: cast to the pool
    dtype, or on int8 pools quantized with their row scales
    (``k_scales``/``v_scales`` written alongside).  ``pages``/``rows``
    index physical (page, row) per fresh token, with the leading shape of
    ``k``/``v``; pages outside the pool drop the write, as JAX's
    ``mode="drop"`` does."""
    kp, vp = kv_cache["k_pages"], kv_cache["v_pages"]
    keep = (pages >= 0) & (pages < kp.shape[0])
    pages, rows, k, v = pages[keep], rows[keep], k[keep], v[keep]
    if "k_scales" in kv_cache:
        kq, ks = R.quantize_int8_rows(k)
        vq, vs = R.quantize_int8_rows(v)
        kp[pages, rows] = kq
        vp[pages, rows] = vq
        kv_cache["k_scales"][pages, rows] = ks
        kv_cache["v_scales"][pages, rows] = vs
    else:
        kp[pages, rows] = k.to(kp.dtype)
        vp[pages, rows] = v.to(vp.dtype)
    return kv_cache


def _scale_kw(cache):
    """Dequant-scale kwargs for the paged dispatch calls (empty on fp)."""
    if "k_scales" in cache:
        return {"k_scales": cache["k_scales"], "v_scales": cache["v_scales"]}
    return {}


def multi_head_attention(p, x, cfg: ModelConfig, *, kv_cache=None,
                         cache_index=None, block_tables=None,
                         write_tables=None):
    """GQA attention with RoPE over an optional KV cache.

    Modes (as on the JAX side):
      * no cache: full causal attention over x;
      * dense cache ``{"k", "v"}: (B, W, Hkv, D)``, scalar ``cache_index``:
        prefill (x longer than one token, the tail written to the ring) or
        lock-step decode (write, then attend the ring);
      * dense cache, (B,) ``cache_index``: per-slot decode, each slot at its
        own position;
      * paged cache ``{"k_pages", "v_pages"}: (N, P, Hkv, D)`` (int8
        pools add ``k_scales``/``v_scales`` (N, P, Hkv)) with
        ``block_tables``: one-token per-slot decode through the fused
        RoPE + page-write + attention kernel; a per-slot window of S > 1
        tokens (the speculative verify: written at each slot's positions,
        then attended causally over the slot's pages); or batch-1 suffix
        prefill (scalar ``cache_index`` = tokens already cached; K/V
        written through ``write_tables``, then every query attends all
        mapped pages).
    Returns (out, kv_cache) -- the cache written in place."""
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    dev = x.device
    q = torch.matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = torch.matmul(x, p["wk"]).reshape(b, s, hk, hd)
    v = torch.matmul(x, p["wv"]).reshape(b, s, hk, hd)

    per_slot = torch.is_tensor(cache_index) and cache_index.dim() == 1
    offset = 0 if cache_index is None else cache_index
    if per_slot:
        offset = offset.to(device=dev, dtype=torch.int64)
        pos_bs = offset[:, None] + torch.arange(s, device=dev)[None, :]
    else:
        offset = int(offset)
    paged = kv_cache is not None and "k_pages" in kv_cache
    fuse_decode = paged and s == 1 and per_slot and cfg.rope_theta > 0 \
        and block_tables is not None
    if per_slot:
        positions = pos_bs
    else:
        positions = (offset + torch.arange(s, device=dev))[None, :].expand(
            b, s)
    if cfg.rope_theta > 0 and not fuse_decode:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q_pos = pos_bs if per_slot else torch.arange(s, device=dev) + offset

    if kv_cache is None:
        out = _attend(q, k, v, cfg, q_pos=q_pos,
                      k_pos=torch.arange(s, device=dev), k_valid=None,
                      causal=True, window=0, dt=dt)
    elif paged:
        if block_tables is None:
            raise NotImplementedError(
                "paged KV caches are addressed through block_tables")
        page = kv_cache["k_pages"].shape[1]
        if fuse_decode:
            out = kops.dispatch_fused_paged_decode(
                q, k, v, kv_cache["k_pages"], kv_cache["v_pages"],
                block_tables, offset, theta=cfg.rope_theta,
                softcap=cfg.attn_logit_softcap, **_scale_kw(kv_cache))[0]
            out = out.to(dt)
        elif per_slot:
            # speculative verify: each slot writes its S-token window at
            # its own positions (blocks past the table go to the drop
            # sentinel), then every window query attends the slot's
            # mapped prefix under a per-slot causal mask
            n = kv_cache["k_pages"].shape[0]
            nb = block_tables.shape[1]
            blk = pos_bs // page                                  # (B, S)
            phys = torch.where(
                blk < nb,
                torch.gather(block_tables.long(), 1,
                             torch.clamp(blk, 0, nb - 1)), n)
            _paged_write(kv_cache, phys, pos_bs % page, k, v)
            out = kops.dispatch_paged_verify_attention(
                q, kv_cache["k_pages"], kv_cache["v_pages"], block_tables,
                offset, softcap=cfg.attn_logit_softcap,
                **_scale_kw(kv_cache)).to(dt)
        else:
            if b != 1:
                raise NotImplementedError(
                    "paged prefill writes through one write-table row")
            wt = block_tables if write_tables is None else write_tables
            n = kv_cache["k_pages"].shape[0]
            nb = wt.shape[1]
            pos = offset + torch.arange(s, device=dev)
            blk = pos // page
            rows = pos % page
            # pad positions can run past the table: map them to the drop
            # sentinel n explicitly (torch raises where JAX would clamp)
            phys = torch.where(
                blk < nb, wt[0, torch.clamp(blk, 0, nb - 1)].long(), n)
            _paged_write(kv_cache, phys, rows, k[0], v[0])
            out = kops.dispatch_paged_prefill_attention(
                q, kv_cache["k_pages"], kv_cache["v_pages"], block_tables,
                offset, softcap=cfg.attn_logit_softcap,
                **_scale_kw(kv_cache)).to(dt)
    else:
        kc, vc = kv_cache["k"], kv_cache["v"]
        W = kc.shape[1]
        if s > 1 and not per_slot:
            # prefill: attend the fresh k/v, write the tail into the ring
            out = _attend(q, k, v, cfg, q_pos=q_pos,
                          k_pos=torch.arange(s, device=dev), k_valid=None,
                          causal=True, window=0, dt=dt)
            tail = min(s, W)
            slots = (offset + torch.arange(s - tail, s, device=dev)) % W
            kc[:, slots] = k[:, s - tail:].to(kc.dtype)
            vc[:, slots] = v[:, s - tail:].to(vc.dtype)
        elif per_slot:
            # per-slot decode: each slot writes its own row(s), attends
            # under its own length mask
            rows = pos_bs % W
            bidx = torch.arange(b, device=dev)[:, None]
            kc[bidx, rows] = k.to(kc.dtype)
            vc[bidx, rows] = v.to(vc.dtype)
            k_pos, k_valid = ring_k_positions((offset + s - 1)[:, None], W)
            out = _attend(q, kc, vc, cfg, q_pos=q_pos, k_pos=k_pos,
                          k_valid=k_valid, causal=True, window=0, dt=dt)
        else:
            # lock-step decode: ring write then attend over the cache
            slots = (offset + torch.arange(s, device=dev)) % W
            kc[:, slots] = k.to(kc.dtype)
            vc[:, slots] = v.to(vc.dtype)
            k_pos, k_valid = ring_k_positions(
                torch.tensor(offset + s - 1, device=dev), W)
            out = _attend(q, kc, vc, cfg, q_pos=q_pos, k_pos=k_pos,
                          k_valid=k_valid, causal=True, window=0, dt=dt)

    out = torch.matmul(out, p["wo"])
    return out, kv_cache


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------


def apply_mlp(p, x, cfg: ModelConfig):
    """Gated SiLU MLP: wo(silu(x wg) * (x wi))."""
    dt = x.dtype
    hid = torch.matmul(x, p["wi"]).to(torch.float32)
    gate = torch.matmul(x, p["wg"]).to(torch.float32)
    hid = torch.nn.functional.silu(gate) * hid
    return torch.matmul(hid.to(dt), p["wo"])


def embed(p, ids, cfg: ModelConfig):
    return p["table"][ids]


def logits_head(p_head, x, cfg: ModelConfig):
    """f32 logits, as the JAX head's f32-accumulated einsum gives them."""
    return torch.matmul(x.to(torch.float32), p_head["w"].to(torch.float32))
