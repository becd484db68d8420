"""Transformer layer primitives of the port (functional, on torch tensors).

Counterparts of the JAX package's ``models/layers.py`` for the serving
path of the GQA decoders (llama-style yi, nemotron's LayerNorm and
squared-ReLU MLP, gemma2's sliding windows, softcaps and GeGLU), of the
MoE decoders (qwen2-moe, granite-moe), of the attention layers of the
jamba hybrid (rope-free) and qwen2-vl (M-RoPE), and of the encoders (the
paper's ViTs and whisper's encoder: non-causal, rope-free) and whisper's
cross-attention over encoder K/V: RMSNorm and LayerNorm (also per head,
qk-norm), RoPE, M-RoPE and sinusoidal positions,
GQA attention over a dense cache or ring or a paged KV cache, the gated
or plain MLP, the top-k routed MoE FFN, embedding and the LM head (its
own weight or the embedding's transpose, with an optional final softcap),
and the head fused with cross-entropy over vocab chunks for the loss.

Conventions, as on the JAX side:
  * params are nested dicts of tensors, weights laid out (in, out) so the
    JAX weights bridge across unchanged (``repro_torch.bridge``);
  * activations ``x`` are (batch, seq, d_model);
  * projections are ``torch.matmul`` (the JAX side leaves them to XLA as
    einsums), whose output JAX casts straight back to the activation
    dtype; where JAX keeps the f32 accumulator (the MLP's hidden and gate
    products, the LM head, the MoE expert products) the port takes
    ``matmul_f32``/``bmm_f32``.  Attention softmax runs in f32.

Unlike JAX, which returns fresh cache arrays, the port writes K/V into the
cache tensors it is given, IN PLACE, and returns the same dict.

Tensor parallelism (``par``, a ``sharding.Parallel``; sharded training
only).  Each rank holds its shards of the weights as JAX's rules place
them over ``model`` and computes on plain local tensors; activations
between blocks are replicated over ``model``.  Attention and the MLP are
Megatron's: wq/wk/wv and wi/wg column-parallel behind ``f``, wo
row-parallel before ``g``.  The MoE FFN is tensor parallel inside each
expert, or expert parallel (a rank's whole experts); either way a
token's capacity row counts the global token order over the data axes.
The embedding and the head are vocab-parallel.  A weight the rules leave
replicated (a dim ``model`` does not divide) runs replicated.
"""
from __future__ import annotations

import itertools
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


def init_norm(cfg: ModelConfig, device, dim: int = 0):
    """Norm params of width ``dim`` (default ``d_model``; qk-norm's are
    ``head_dim`` wide)."""
    dim = dim or cfg.d_model
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def init_attention(generator, cfg: ModelConfig, device, cross: bool = False):
    """wq, wk, wv, wo; a cross-attention layer (``cross``) has the same
    weights, its wk/wv applied to the encoder's output.  With
    ``cfg.qk_norm``, also ``q_norm``/``k_norm`` of width ``head_dim``."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = getattr(torch, cfg.param_dtype)
    p = {"wq": dense_init(generator, (d, qd), d, dt, device),
         "wk": dense_init(generator, (d, kvd), d, dt, device),
         "wv": dense_init(generator, (d, kvd), d, dt, device),
         "wo": dense_init(generator, (qd, d), qd, dt, device)}
    if cfg.qk_norm:
        p["q_norm"] = init_norm(cfg, device, cfg.head_dim)
        p["k_norm"] = init_norm(cfg, device, cfg.head_dim)
    return p


def init_mlp(generator, cfg: ModelConfig, device):
    dt = getattr(torch, cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(generator, (d, f), d, dt, device),
         "wo": dense_init(generator, (f, d), f, dt, device)}
    if cfg.gated_mlp:
        p["wg"] = dense_init(generator, (d, f), d, dt, device)
    return p


def init_moe(generator, cfg: ModelConfig, device):
    """Router (f32), stacked expert weights (E, D, F) / (E, F, D) and, with
    shared experts, one fused shared expert of ``shared_expert_d_ff``."""
    moe = cfg.moe
    dt = getattr(torch, cfg.param_dtype)
    e, d, f = moe.num_experts, cfg.d_model, moe.expert_d_ff
    p = {"router": dense_init(generator, (d, e), d, torch.float32, device),
         "wi": dense_init(generator, (e, d, f), d, dt, device),
         "wg": dense_init(generator, (e, d, f), d, dt, device),
         "wo": dense_init(generator, (e, f, d), f, dt, device)}
    if moe.num_shared_experts:
        sf = moe.shared_expert_d_ff
        p["shared"] = {"wi": dense_init(generator, (d, sf), d, dt, device),
                       "wg": dense_init(generator, (d, sf), d, dt, device),
                       "wo": dense_init(generator, (sf, d), sf, dt, device)}
    return p


def init_embedding(generator, cfg: ModelConfig, device):
    dt = getattr(torch, cfg.param_dtype)
    return {"table": dense_init(generator, (cfg.vocab_size, cfg.d_model),
                                cfg.d_model, dt, device)}


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


def apply_norm(p, x, cfg: ModelConfig, eps: float = 1e-6):
    """RMSNorm, or LayerNorm with its bias, in f32, cast back to the input
    dtype."""
    xf = x.to(torch.float32)
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, mrope_sections=()):
    """x: (B, S, H, D); positions: (B, S), or (3, B, S) for M-RoPE.

    M-RoPE (``mrope_sections``, e.g. qwen2-vl's (16, 24, 24), summing to
    D/2): frequency f rotates by position stream ``sec[f]`` (temporal,
    height, width), so it needs (3, B, S) positions and raises without
    them, as JAX asserts.  Without sections a (3, B, S) input rotates by
    its stream 0."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    if mrope_sections:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        if sum(mrope_sections) != d // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} must sum "
                             f"to head_dim / 2 = {d // 2}")
        # the stream of each frequency, (d/2,), built on the device from
        # the sections' bounds (no host-to-device copy)
        f = torch.arange(d // 2, device=x.device)
        sec = torch.zeros_like(f)
        for bound in itertools.accumulate(mrope_sections[:-1]):
            sec = sec + (f >= bound).long()
        # each frequency's position stream, (B, S, d/2)
        pos = positions.to(torch.float32)[sec].permute(1, 2, 0)
        angles = pos * inv
    else:
        if positions.dim() == 3:
            positions = positions[0]
        angles = positions.to(torch.float32)[..., None] * inv   # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device="cpu"):
    """(seq, dim) f32 sinusoidal embeddings: sin in the even columns, cos
    in the odd ones (whisper's encoder and decoder positions)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def sinusoidal_position_at(pos: int, dim: int, device="cpu"):
    """The (dim,) sinusoidal embedding of the single position ``pos``."""
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) * div
    pe = torch.zeros((dim,), dtype=torch.float32, device=device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe


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


def cross_kv(p, enc_out, cfg: ModelConfig):
    """Cross-attention K/V (B, T, Hkv, D) from the encoder's output:
    f32-accumulated projections cast to the activation dtype, computed
    once at prefill and cached so that decode steps skip them."""
    b, t, _ = enc_out.shape
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    k = matmul_f32(enc_out, p["wk"]).to(enc_out.dtype)
    v = matmul_f32(enc_out, p["wv"]).to(enc_out.dtype)
    return k.reshape(b, t, hk, hd), v.reshape(b, t, hk, hd)


def multi_head_attention(p, x, cfg: ModelConfig, *, positions=None,
                         causal: bool = True, window: int = 0,
                         kv_cache=None, cache_index=None,
                         kv_source=None, use_rope: bool = True,
                         precomputed_kv=None, block_tables=None,
                         write_tables=None, attend_cache: bool = False,
                         par=None):
    """GQA attention with RoPE over an optional KV cache.

    par: tensor parallelism over ``model`` (``_attention_tp``), for the
    stateless forward of training only: self-attention, or
    cross-attention over ``kv_source``.

    positions: explicit RoPE positions, (B, S), or (3, B, S) for M-RoPE
    (qwen2-vl).  They rotate q and k only: every mask keeps the query
    positions the cache offset gives (``q_pos``), as JAX's does.  None:
    the positions ``cache_index`` gives.  With ``q_norm``/``k_norm`` in
    ``p`` (qk-norm), q and k are normed per head after the head reshape
    and before RoPE.

    causal=False: bidirectional attention (the encoders).  Cross-attention
    takes its keys from ``kv_source`` (B, T, D), projected here, or from
    ``precomputed_kv`` ((B, T, Hkv, D) K and V, ``cross_kv``'s): then k
    takes no RoPE and no causal mask applies, as in JAX.  ``use_rope``
    False leaves q unrotated too.

    window > 0: sliding-window attention (a query attends keys less than
    ``window`` positions back), applied in every dense mode as JAX does;
    its dense cache is a ring of ``min(max_seq, window)`` rows.  On a CUDA
    tensor the per-slot one-token decode over such a ring runs the
    unfused paged decode kernel on a view of the ring
    (``dispatch_ring_decode``: every valid ring row lies inside the
    window); elsewhere the plain ``_attend_block``.  A paged cache with a
    window raises, as JAX's does.

    Modes (as on the JAX side):
      * no cache: full attention over x (causal unless ``causal`` is
        False), or over the cross-attention keys;
      * dense cache ``{"k", "v"}: (B, W, Hkv, D)``, scalar ``cache_index``:
        prefill (x longer than one token, the tail written to the ring;
        with ``attend_cache`` a chunked-prefill continuation, whose
        queries also attend the ``cache_index`` tokens already in the
        ring) or lock-step decode (write, then attend the ring);
      * dense cache, (B,) ``cache_index``: per-slot decode, each slot at its
        own position;
      * paged cache ``{"k_pages", "v_pages"}: (N, P, Hkv, D)`` (int8
        pools add ``k_scales``/``v_scales`` (N, P, Hkv)) with
        ``block_tables``: one-token per-slot decode through the fused
        RoPE + page-write + attention kernel (rope-free attention, M-RoPE
        and explicit positions cannot fuse: they write the fresh row and
        then run the unfused paged decode kernel); a per-slot window of
        S > 1
        tokens (the speculative verify: written at each slot's positions,
        then attended causally over the slot's pages); or batch-1 suffix
        prefill (scalar ``cache_index`` = tokens already cached; K/V
        written through ``write_tables``, then every query attends all
        mapped pages).
    Returns (out, kv_cache) -- the cache written in place."""
    if tensor_parallel(p, cfg, par):
        if kv_cache is not None or precomputed_kv is not None:
            raise NotImplementedError(
                "tensor-parallel attention runs the stateless forward of "
                "training: no cache (cross-attention takes kv_source)")
        return _attention_tp(p, x, cfg, par, positions=positions,
                             causal=causal, window=window,
                             use_rope=use_rope, kv_source=kv_source), None
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    dev = x.device
    q = torch.matmul(x, p["wq"]).reshape(b, s, h, hd)
    if precomputed_kv is not None:
        k, v = precomputed_kv
        kv_source = k          # cross-attention: no rope on k, no causal
    else:
        kv_in = x if kv_source is None else kv_source
        t = kv_in.shape[1]
        k = torch.matmul(kv_in, p["wk"]).reshape(b, t, hk, hd)
        v = torch.matmul(kv_in, p["wv"]).reshape(b, t, hk, hd)
    if "q_norm" in p:
        q = apply_norm(p["q_norm"], q, cfg)
        k = apply_norm(p["k_norm"], k, cfg)
    rope = use_rope and cfg.rope_theta > 0

    per_slot = torch.is_tensor(cache_index) and cache_index.dim() == 1
    offset = 0 if cache_index is None else cache_index
    if per_slot:
        offset = offset.to(device=dev, dtype=torch.int64)
        pos_bs = offset[:, None] + torch.arange(s, device=dev)[None, :]
    else:
        offset = int(offset)
    paged = kv_cache is not None and "k_pages" in kv_cache
    fuse_decode = paged and s == 1 and per_slot and rope \
        and kv_source is None and block_tables is not None \
        and not cfg.mrope_sections and positions is None
    if positions is None:
        positions = pos_bs if per_slot else (
            offset + torch.arange(s, device=dev))[None, :].expand(b, s)
    if rope and not fuse_decode:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        if kv_source is None:
            k = apply_rope(k, positions, cfg.rope_theta,
                           cfg.mrope_sections)
    causal = causal and kv_source is None
    q_pos = pos_bs if per_slot else torch.arange(s, device=dev) + offset

    if kv_cache is None:
        out = _attend(q, k, v, cfg, q_pos=q_pos,
                      k_pos=torch.arange(k.shape[1], device=dev),
                      k_valid=None, causal=causal, window=window, dt=dt)
    elif paged:
        if window:
            raise NotImplementedError(
                "sliding-window attention keeps its dense ring cache "
                "(ring wrap order is position-, not block-, aligned)")
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
        elif s == 1 and per_slot:
            # one-token decode that cannot fuse (rope-free attention): the
            # fresh row lands in its page row (the table entry of block
            # offset // page, clipped into the table; the sentinel's sink
            # page takes idle slots' writes), then the slot attends its
            # pages at lengths = offset + 1
            nb = block_tables.shape[1]
            blk = torch.clamp(offset // page, 0, nb - 1)
            pages = torch.gather(block_tables.long(), 1, blk[:, None])[:, 0]
            _paged_write(kv_cache, pages, offset % page, k[:, 0], v[:, 0])
            out = kops.dispatch_paged_attention(
                q, kv_cache["k_pages"], kv_cache["v_pages"], block_tables,
                offset + 1, softcap=cfg.attn_logit_softcap,
                **_scale_kw(kv_cache)).to(dt)
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
            if attend_cache:
                # chunked-prefill continuation: the chunk's queries attend
                # the ring's rows at their absolute positions (rows not
                # yet written masked by k_valid) and the fresh k/v; the
                # ring is position-ordered, so the valid keys sum in the
                # one-shot prefill's order
                k_pos_old, k_valid_old = ring_k_positions(
                    torch.full((), offset - 1, device=dev), W)
                out = _attend(
                    q, torch.cat([kc.to(dt), k], dim=1),
                    torch.cat([vc.to(dt), v], dim=1), cfg, q_pos=q_pos,
                    k_pos=torch.cat([k_pos_old,
                                     offset + torch.arange(s, device=dev)]),
                    k_valid=torch.cat([k_valid_old,
                                       torch.ones((s,), dtype=torch.bool,
                                                  device=dev)]),
                    causal=causal, window=window, dt=dt)
            else:
                # prefill: attend the fresh k/v
                out = _attend(q, k, v, cfg, q_pos=q_pos,
                              k_pos=torch.arange(s, device=dev),
                              k_valid=None, causal=causal, window=window,
                              dt=dt)
            # write the tail into the ring
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
            if window and s == 1 and dev.type == "cuda":
                # a window's ring: every valid row lies inside the window
                # (W = min(max_seq, window)), so this is the unfused paged
                # decode over the ring at lengths min(pos + 1, W)
                out = kops.dispatch_ring_decode(
                    q, kc, vc, offset, softcap=cfg.attn_logit_softcap).to(dt)
            else:
                k_pos, k_valid = ring_k_positions((offset + s - 1)[:, None],
                                                  W)
                out = _attend(q, kc, vc, cfg, q_pos=q_pos, k_pos=k_pos,
                              k_valid=k_valid, causal=causal, window=window,
                              dt=dt)
        else:
            # lock-step decode: ring write then attend over the cache
            slots = (offset + torch.arange(s, device=dev)) % W
            kc[:, slots] = k.to(kc.dtype)
            vc[:, slots] = v.to(vc.dtype)
            k_pos, k_valid = ring_k_positions(
                torch.full((), offset + s - 1, device=dev), W)
            out = _attend(q, kc, vc, cfg, q_pos=q_pos, k_pos=k_pos,
                          k_valid=k_valid, causal=causal, window=window,
                          dt=dt)

    out = torch.matmul(out, p["wo"])
    return out, kv_cache


def _shared(norm_p, par):
    """A norm's params behind ``f``: qk-norm's scale is shared by every
    head, and each rank norms its own heads only, so its gradient is a
    sum over the ranks."""
    return {k: par.f(v, "model") for k, v in norm_p.items()}


def tensor_parallel(p, cfg: ModelConfig, par) -> bool:
    """Whether attention params ``p`` hold ``model`` shards (JAX's rules
    cut wq's columns whenever ``model`` divides them)."""
    return par is not None and par.tp > 1 \
        and p["wq"].shape[1] != cfg.num_heads * cfg.head_dim


def _attention_tp(p, x, cfg: ModelConfig, par, *, positions, causal,
                  window, use_rope, kv_source=None):
    """Megatron attention over ``model``: wq/wk/wv column-parallel behind
    ``f``, wo row-parallel and ``g``.

    When the rank's wq columns hold whole query heads, its heads go
    through flash unchanged.  When they cut a head (deit-t: 3 heads over
    ``model`` = 2), q (and K and V) are all-gathered over ``model`` after
    the projection, every rank attends every head, and takes the columns
    of the output that its wo rows multiply.  When the rank's wk/wv shard
    does not hold whole KV heads (JAX shards them whenever ``model``
    divides Hkv * head_dim, which GSPMD handles), K and V are
    all-gathered too and each rank takes the KV heads of its query
    heads.  Each of those gathers feeds a distinct part of the
    row-parallel sum, so its summing backward is right.

    kv_source: cross-attention (whisper's decoder) over the encoder's
    output (replicated over ``model``): K and V from it behind ``f``,
    f32-accumulated and cast as ``cross_kv`` gives them, non-causal and
    unrotated."""
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp, r = par.tp, par.model_rank
    dt, dev = x.dtype, x.device
    grp = h // hk
    wk, wv = p["wk"], p["wv"]
    if wk.shape[1] == hk * hd:
        raise NotImplementedError(
            f"{cfg.name}: wk/wv replicated under a sharded wq (model={tp} "
            f"does not divide Hkv * head_dim = {hk * hd})")
    xm = par.f(x, "model")
    if kv_source is None:
        k, v = torch.matmul(xm, wk), torch.matmul(xm, wv)
    else:
        src = par.f(kv_source, "model")
        k, v = (matmul_f32(src, w).to(dt) for w in (wk, wv))
    skv = k.shape[1]
    q = torch.matmul(xm, p["wq"])
    whole = h % tp == 0
    if whole:
        hq, q0 = h // tp, r * h // tp
    else:
        hq, q0 = h, 0
        q = par.all_gather(q, -1, "model")
    q = q.reshape(b, s, hq, hd)
    if whole and hk % tp == 0:
        nk = hk // tp
        k, v = (t.reshape(b, skv, nk, hd) for t in (k, v))
    else:
        if hq % grp and grp % hq:
            raise NotImplementedError(
                f"{cfg.name}: {hq} query heads a rank cut across GQA groups "
                f"of {grp}")
        lo = q0 // grp
        nk = max(hq // grp, 1)
        k, v = (par.all_gather(t, -1, "model").reshape(b, skv, hk, hd)
                [:, :, lo:lo + nk] for t in (k, v))
    if "q_norm" in p:
        q = apply_norm(_shared(p["q_norm"], par), q, cfg)
        k = apply_norm(_shared(p["k_norm"], par), k, cfg)
    rope = use_rope and cfg.rope_theta > 0 and kv_source is None
    if rope:
        if positions is None:
            positions = torch.arange(s, device=dev)[None, :].expand(b, s)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    out = _attend(q, k, v, cfg, q_pos=torch.arange(s, device=dev),
                  k_pos=torch.arange(skv, device=dev), k_valid=None,
                  causal=causal and kv_source is None, window=window, dt=dt)
    if not whole:
        rows = p["wo"].shape[0]
        out = out[..., r * rows:(r + 1) * rows]
    return par.g(torch.matmul(out, p["wo"]), "model")


# ---------------------------------------------------------------------------
# MLP, embedding, head
# ---------------------------------------------------------------------------


def matmul_f32(x, w):
    """x (..., K) @ w (K, N) accumulated in f32 and returned in f32: the
    counterpart of ``jnp.einsum(..., preferred_element_type=jnp.float32)``
    with no cast after it.  On CUDA, bf16 operands go to the dtype
    overload of ``torch.mm`` (f32 output, no widened weight copy) inside
    ``_MatmulF32``; on the CPU both operands are widened first, which
    gives the same product because bf16 values are exact in f32 (and is
    differentiable as it stands)."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def bmm_f32(x, w):
    """Batched x (E, M, K) @ w (E, K, N) accumulated and returned in f32,
    the batched counterpart of ``matmul_f32`` (JAX's expert einsums with
    ``preferred_element_type=jnp.float32``)."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return _MatmulF32.apply(x, w)
    return torch.bmm(x.to(torch.float32), w.to(torch.float32))


def _mm_f32(a, b):
    """a @ b (2-D or batched 3-D) accumulated and returned in f32: the
    dtype overload of ``torch.mm``/``torch.bmm`` on CUDA; widened operands
    elsewhere."""
    if a.device.type == "cuda":
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _split_bf16(g):
    """f32 ``g`` as three bf16 terms whose sum is ``g`` to within 2^-27
    of each value (8 significant bits a term; f32 holds 24)."""
    hi = g.to(torch.bfloat16)
    rest = g - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.to(torch.float32)).to(torch.bfloat16)


def matmul_f32_grads(x, w, g, needs=(True, True)):
    """The gradients of the f32-output product ``x @ w`` (2-D, or batched
    3-D) for the f32 cotangent ``g``, by JAX's transpose rule for
    ``preferred_element_type=f32`` products: the cotangent stays f32, each
    product accumulates in f32, and each gradient is cast to its operand's
    dtype -- what autograd through the CPU path's widened product gives.
    For bf16 operands ``g`` enters as its three bf16 terms
    (``_split_bf16``), summed after their products, so that the products
    stay on the tensor cores with the f32 cotangent's precision."""
    parts = (g,) if x.dtype == torch.float32 else _split_bf16(g)

    def summed(mm):                           # the smallest terms first
        out = mm(parts[-1])
        for part in parts[-2::-1]:
            out = out + mm(part)
        return out
    gx = summed(lambda p: _mm_f32(p, w.mT)).to(x.dtype) if needs[0] else None
    gw = summed(lambda p: _mm_f32(x.mT, p)).to(w.dtype) if needs[1] else None
    return gx, gw


class _MatmulF32(torch.autograd.Function):
    """``torch.mm``/``torch.bmm`` with ``out_dtype=float32`` (which has no
    derivative of its own) and ``matmul_f32_grads`` as its backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return matmul_f32_grads(x, w, g, ctx.needs_input_grad)


_ACTS = {"silu": torch.nn.functional.silu,
         "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
         "relu2": lambda x: torch.relu(x).square()}


def apply_mlp(p, x, cfg: ModelConfig, par=None):
    """wo(act(x wg) * (x wi)) when gated, else wo(act(x wi)); the hidden
    (and gate) products kept in f32 as JAX keeps them.  ``par`` with wi
    sharded over ``model``: wi/wg column-parallel behind ``f``, wo
    row-parallel and ``g``."""
    act = _ACTS[cfg.mlp_activation]
    split = par is not None and par.tp > 1 and p["wi"].shape[-1] != cfg.d_ff
    xin = par.f(x, "model") if split else x
    hid = matmul_f32(xin, p["wi"])
    if "wg" in p:
        hid = act(matmul_f32(xin, p["wg"])) * hid
    else:
        hid = act(hid)
    out = torch.matmul(hid.to(x.dtype), p["wo"])
    return par.g(out, "model") if split else out


def moe_capacity(cfg: ModelConfig, n: int, s: int) -> int:
    """Expert rows a choice round may fill: ``ceil(n * capacity_factor /
    E)``, or ``n`` (drop-free) for a one-token step, as in JAX: there a
    drop would make one slot's token depend on what the others decoded."""
    if s == 1:
        return n
    return max(1, int(math.ceil(n * cfg.moe.capacity_factor
                                / cfg.moe.num_experts)))


def apply_moe(p, x, cfg: ModelConfig, par=None):
    """Top-k capacity-limited MoE FFN with JAX's semantics
    (``repro.models.layers.apply_moe``): f32 router and softmax, top-k
    probabilities renormalized, per choice round a token's row in its
    expert by a cumulative count in token order, rows past the capacity
    dropped (contributing 0), each round's combine added into an f32 ``y``
    in round order, then the shared expert.  Returns (y, aux), aux the
    Switch load-balance loss.

    Where JAX runs one expert product per round (each reading every
    expert's weights), the port stacks the k rounds' dispatch buffers into
    one (E, k * cap, D) product: each row's product is the same, and the
    expert weights are read once.  The buffer is filled by one indexed
    assignment with no host sync: kept rows hold distinct (expert, row)
    pairs, dropped ones land on a sink row past the k * cap that the
    product never reads.

    par (sharded training): the result is JAX's global one.  Over the
    data axes, each rank routes its own tokens, but the capacity counts
    the global n tokens, a token's row counts the global token order (the
    (round, expert) counts of the ranks before it, all-gathered, offset
    the rank's own), and aux is this rank's share of the global Switch
    loss (its router-probability sum against the all-reduced first-choice
    counts, over the global n squared; the shares sum to JAX's aux).
    Over ``model``, the experts are tensor parallel inside each expert
    (wi/wg (E, D, F/tp), wo (E, F/tp, D)) or, with the experts sharded
    (``expert_parallel``), each rank computes its E/tp whole experts for
    every token; either way the rank's expert output is a part of the
    whole, so its input passes ``f``, the combine weights pass ``f`` (so
    the router's gradient is whole on every rank) and ``g`` sums the
    combine and the shared expert's row-parallel part."""
    moe = cfg.moe
    b, s, d = x.shape
    n = b * s
    e, k = moe.num_experts, moe.experts_per_token
    dp = par.dp if par is not None else 1
    cap = moe_capacity(cfg, n * dp, s)
    dt, dev = x.dtype, x.device
    xf = x.reshape(n, d)

    logits = torch.matmul(xf.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)              # (n, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # row of each (token, round) in its expert: the count of earlier
    # tokens of the round that chose the same expert
    onehot = (top_e[..., None]
              == torch.arange(e, device=dev)).to(torch.int32)  # (n, k, e)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    rank_pos = pos
    if dp > 1:
        # the (round, expert) counts of the data ranks before this one
        counts = par.gather_plain(onehot.sum(dim=0)[None], 0,
                                  par.data_axes)
        before = counts[:par.data_rank].sum(dim=0)            # (k, e)
        pos = pos + (onehot * before).sum(dim=-1)
    keep = pos < cap                                          # (n, k)
    # a rank's kept rows lie below cap - its offset: its own count stores
    rows = torch.arange(k, device=dev) * cap + rank_pos
    e_loc = p["wi"].shape[0]
    ep = e_loc != e
    tp_ffn = par is not None and par.tp > 1 \
        and p["wi"].shape[-1] != moe.expert_d_ff
    if ep:
        local = top_e - par.model_rank * e_loc
        mine = (local >= 0) & (local < e_loc)
        keep = keep & mine
        eidx = torch.where(mine, local, 0)
    else:
        eidx = top_e
    split = ep or tp_ffn
    sh_split = "shared" in p and par is not None and par.tp > 1 \
        and p["shared"]["wi"].shape[-1] != moe.shared_expert_d_ff
    xin = par.f(xf, "model") if split or sh_split else xf
    buf = torch.zeros((e_loc, k * cap + 1, d), dtype=dt, device=dev)
    buf[eidx, torch.where(keep, rows, k * cap)] = \
        (xin if split else xf)[:, None, :].expand(n, k, d)
    buf = buf[:, :k * cap]
    hid = bmm_f32(buf, p["wi"])
    gate = bmm_f32(buf, p["wg"])
    hid = (torch.nn.functional.silu(gate) * hid).to(dt)
    out = bmm_f32(hid, p["wo"])                               # (e, k*cap, d)
    tok = torch.where(keep[..., None],
                      out[eidx, torch.where(keep, rows, 0)], 0.0)
    if split:
        top_w = par.f(top_w, "model")
    y = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + tok[:, j] * top_w[:, j:j + 1]
    if "shared" in p:
        sh = p["shared"]
        xs = xin if sh_split else xf
        hid = matmul_f32(xs, sh["wi"])
        gate = matmul_f32(xs, sh["wg"])
        hid = (torch.nn.functional.silu(gate) * hid).to(dt)
        shared = matmul_f32(hid, sh["wo"])
        if split == sh_split:
            y = y + shared
        else:          # one part is whole: sum the other over model first
            y = (par.g(y, "model") + shared if split
                 else y + par.g(shared, "model"))
            split = sh_split = False
    if split or sh_split:
        y = par.g(y, "model")
    # Switch aux loss: E * sum(mean router prob * share of first choices)
    first = torch.zeros((e,), dtype=torch.float32, device=dev)
    first.index_add_(0, top_e[:, 0], torch.ones((n,), dtype=torch.float32,
                                                 device=dev))
    if dp > 1:
        first = par.all_reduce(first, par.data_axes)
        aux = e * torch.sum(probs.sum(dim=0) / (n * dp) * (first / (n * dp)))
    else:
        aux = e * torch.sum(probs.mean(dim=0) * (first / n))
    return y.reshape(b, s, d).to(dt), aux


def embed(p, ids, cfg: ModelConfig, par=None):
    """The table's rows of ``ids``.  ``par`` with the table sharded on V
    over ``model`` (vocab-parallel): each rank looks up the ids in its
    vocabulary block (others give zero rows) and ``g`` sums them."""
    table = p["table"]
    if par is not None and par.tp > 1 and table.shape[0] != cfg.vocab_size:
        v_loc = table.shape[0]
        local = ids - par.model_rank * v_loc
        ok = (local >= 0) & (local < v_loc)
        out = table[local.clamp(0, v_loc - 1)] * ok[..., None].to(
            table.dtype)
        out = par.g(out, "model")
    else:
        out = table[ids]
    if cfg.family == "dense" and cfg.tie_embeddings:
        out = out * torch.sqrt(torch.tensor(float(cfg.d_model))).to(
            out.dtype)
    return out


def _xent_chunk(m, l, tgt, xf, w_c, labels, start: int, cap: float):
    """One vocab chunk of ``chunked_softmax_xent``: its f32 logits, the
    running max and sum moved on, and the target logit picked up where
    the label falls in the chunk."""
    chunk = w_c.shape[1]
    logits = torch.matmul(xf, w_c.to(torch.float32))          # (N, chunk)
    if cap > 0:
        logits = cap * torch.tanh(logits / cap)
    m_new = torch.maximum(m, logits.max(dim=-1).values)
    l = l * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(dim=-1)
    local = labels - start
    in_chunk = (local >= 0) & (local < chunk)
    got = torch.gather(logits, 1, local.clamp(0, chunk - 1)[:, None])[:, 0]
    return m_new, l, torch.where(in_chunk, got, tgt)


def chunked_softmax_xent(x, w, labels, cfg: ModelConfig, *,
                         chunk: int = 8192):
    """Cross-entropy fused with the LM head over vocab chunks, as JAX's
    function of that name: an online logsumexp runs across the chunks, so
    the (tokens, vocab) logits never exist at once.  A vocabulary that
    ``chunk`` does not divide runs as one chunk.  The final softcap
    applies inside.  Each chunk runs under ``torch.utils.checkpoint``
    (non-reentrant), so the backward recomputes its logits, as JAX's
    ``jax.checkpoint(body)`` does.  Plain PyTorch, as JAX's is jnp.

    x: (N, D) final hidden; w: (D, V); labels: (N,) int (< 0 is masked by
    the caller: such a row's target stays 0).  Returns the per-token nll
    (N,) in f32."""
    from torch.utils.checkpoint import checkpoint
    n = x.shape[0]
    v = w.shape[1]
    if v % chunk:
        chunk = v
    xf = x.to(torch.float32)
    dev = x.device
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n,), dtype=torch.float32, device=dev)
    tgt = torch.zeros((n,), dtype=torch.float32, device=dev)
    for start in range(0, v, chunk):
        m, l, tgt = checkpoint(_xent_chunk, m, l, tgt, xf,
                               w[:, start:start + chunk], labels, start,
                               cfg.final_logit_softcap, use_reentrant=False)
    return m + torch.log(l) - tgt


def vocab_parallel_xent(x, w, labels, cfg: ModelConfig, par, *,
                        chunked: bool, chunk: int = 8192):
    """Cross-entropy over a head sharded on V over ``model``: ``w`` (D,
    V/tp) is this rank's vocabulary block.  Each rank computes its block's
    running max, sum of exponentials and target logit (0 when the label
    lies in another block) -- over its block in vocab chunks like
    ``chunked_softmax_xent`` when ``chunked``, else as one f32-accumulated
    product like ``logits_head`` -- then the max is all-reduced first
    (no gradient: the log-sum-exp does not depend on it), the sums and
    target logits after (``g``), into the global log-sum-exp: the (tokens,
    V) logits never exist.  x (N, D) passes ``f``.  Returns the per-token
    nll (N,) in f32."""
    from torch.utils.checkpoint import checkpoint
    n = x.shape[0]
    v_loc = w.shape[1]
    v0 = par.model_rank * v_loc
    x = par.f(x, "model")
    dev = x.device
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((n,), dtype=torch.float32, device=dev)
    tgt = torch.zeros((n,), dtype=torch.float32, device=dev)
    if chunked:
        if v_loc % chunk:
            chunk = v_loc
        xf = x.to(torch.float32)
        for start in range(0, v_loc, chunk):
            m, l, tgt = checkpoint(_xent_chunk, m, l, tgt, xf,
                                   w[:, start:start + chunk], labels,
                                   v0 + start, cfg.final_logit_softcap,
                                   use_reentrant=False)
    else:
        logits = matmul_f32(x, w)
        cap = cfg.final_logit_softcap
        if cap > 0:
            logits = cap * torch.tanh(logits / cap)
        m = logits.max(dim=-1).values
        l = torch.exp(logits - m[:, None]).sum(dim=-1)
        local = labels - v0
        inside = (local >= 0) & (local < v_loc)
        got = torch.gather(logits, 1,
                           local.clamp(0, v_loc - 1)[:, None])[:, 0]
        tgt = torch.where(inside, got, 0.0)
    top = par.all_reduce(m, "model", op="max")
    total = par.g(l * torch.exp(m - top), "model")
    return top + torch.log(total) - par.g(tgt, "model")


def logits_head(p_embed, p_head, x, cfg: ModelConfig):
    """f32 logits, as the JAX head's f32-accumulated einsum gives them;
    a tied head reads the embedding table's transpose.  A final softcap
    ``c * tanh(logits / c)`` applies in f32."""
    if cfg.tie_embeddings or p_head is None:
        out = matmul_f32(x, p_embed["table"].t())
    else:
        out = matmul_f32(x, p_head["w"])
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        out = c * torch.tanh(out / c)
    return out
