"""The recurrent mixers of the port: Mamba-1 (jamba) and xLSTM's mLSTM and
sLSTM (xlstm-125m).

Counterpart of the JAX package's ``models/ssm.py``:

  init_mamba(generator, cfg, device)        -> params
  apply_mamba(p, x, cfg, state=None)        -> (y, new_state)
  init_mlstm / apply_mlstm, init_slstm / apply_slstm: the same contract

``state`` is the O(1) recurrent state a slot carries between steps, f32
in the caches: mamba's ``{"conv": (B, d_conv - 1, d_inner), "ssm": (B,
d_inner, d_state)}``, mLSTM's ``{"C": (B, H, hd, hd), "n": (B, H, hd),
"m": (B, H)}`` (hd = d_inner // H, mLSTM's own head width), sLSTM's
``{"c", "n", "h", "m"}``, each (B, d).  Mamba's selective SSM
``h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t``, ``y_t = C_t . h_t``
takes the path the JAX package takes with ``REPRO_MAMBA`` unset (the
port reads no environment variable for it):

  * S > 1 (prefill): ``mamba_scan_fused``, the fused selective scan
    (``kernels/selective_scan.py``: the Hopper kernel on CUDA, its plain
    version on CPU), which forms the gate and input in registers and
    never materializes a (B, S, d_inner, d_state) tensor;
  * S == 1 (decode): the gate and input of the one step, (B, 1,
    d_inner * d_state) f32, through ``dispatch_linear_scan`` with the
    slot's state as h0, then the C contraction.

The xLSTM recurrences reach no kernel, in either package: JAX runs them
as a sequential ``lax.scan`` in jnp, the port as a Python loop over time
in plain PyTorch (batch and heads vectorized), one step's state at a
time (the state history is never stored).  With ``state=None`` their
stabilizer ``m`` starts at -1e30, as JAX's does; from a cache it starts
at the cache's leaves (zeros from ``make_cache``): the two give close,
not identical, values, and the port mirrors both.

Dtypes as on the JAX side: the in/x/out projections take the activation
dtype; the in and out projections are cast back to it, and the x
projection keeps its f32 accumulator (``matmul_f32``).  ``conv_w``,
``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` are f32 and
the scan runs in f32.  mLSTM's q, k and v keep their f32 accumulators,
its gate weights ``w_i``/``w_f``, ``f_bias`` and ``out_norm`` are f32;
sLSTM's ``w_h``, ``bias`` and ``f_bias`` are f32, its recurrence f32.

Tensor parallelism (``par``, a ``sharding.Parallel`` with ``model`` > 1;
the stateless training forward): each mixer computes with the shards
that JAX's specs (``sharding/rules.py``) give its rank, and where a cut
does not fall on a boundary of the math it moves activations, never
the stored params:
  * mamba: ``in_proj``'s columns hold a block of ``[xi | z]``, so its
    output is all-gathered over ``model`` and the rank takes its
    ``d_inner / tp`` channels of each; the conv, ``dt_proj``, the scan
    and the gate run on those channels; ``x_proj`` and ``out_proj`` are
    row-parallel (the x projection's partial sum is all-reduced before
    its split);
  * mLSTM: ``up_proj``'s output is gathered the same way; ``wq``/``wk``/
    ``wv`` give the rank's heads (every head, gathered, when ``model``
    does not divide the heads: the rank then keeps its ``d_inner / tp``
    columns of the normed output), the gate weights, ``f_bias`` and
    ``out_norm`` are read at the rank's heads; ``down_proj`` is
    row-parallel;
  * sLSTM: a gate's chunk reads the recurrent outputs of every head, so
    the recurrence runs whole on every rank: ``w_x``'s output and
    ``w_h`` are gathered for it (``gather_replicated``: its gradient is
    the rank's block, not a sum), then ``up``'s output is gathered and
    cut as mamba's and ``down`` is row-parallel.
A leaf the rules leave whole (its dim not divisible by ``model``) is
used whole: sLSTM's ``w_h`` when ``model`` does not divide the heads,
its ``down`` when it does not divide the GLU's width (``up``'s output
then gathered for replicated compute); mamba and mLSTM cut ``d_inner``
and their up projection's 2 d_inner alike.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.backend import dispatch as kops
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import selective_scan as SS
from repro_torch.models.layers import dense_init, matmul_f32


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank


def init_mamba(generator, cfg: ModelConfig, device):
    """Random mamba weights with the JAX init constants: dense
    N(0,1)/sqrt(fan_in) projections, dt_bias = softplus^-1(0.01) = -4.6,
    A_log = log(1..d_state) per channel, D = 1."""
    d, n = cfg.d_model, cfg.ssm.d_state
    d_inner, dt_rank = mamba_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    f32 = torch.float32
    a_init = torch.arange(1, n + 1, dtype=f32, device=device)[None, :] \
        .repeat(d_inner, 1)
    return {
        "in_proj": dense_init(generator, (d, 2 * d_inner), d, dt, device),
        "conv_w": dense_init(generator, (cfg.ssm.d_conv, d_inner),
                             cfg.ssm.d_conv, f32, device),
        "conv_b": torch.zeros((d_inner,), dtype=f32, device=device),
        "x_proj": dense_init(generator, (d_inner, dt_rank + 2 * n), d_inner,
                             dt, device),
        "dt_proj": dense_init(generator, (dt_rank, d_inner), dt_rank, f32,
                              device),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=f32, device=device),
        "A_log": torch.log(a_init),
        "D": torch.ones((d_inner,), dtype=f32, device=device),
        "out_proj": dense_init(generator, (d_inner, d), d_inner, dt, device),
    }


def _mamba_conv(p, x_in, conv_state):
    """Depthwise causal conv over seq.  x_in: (B, S, d_inner); conv_state:
    (B, d_conv - 1, d_inner) history or None (zeros).  Returns (silu(conv)
    in x_in's dtype, the new history).  As in JAX, the history keeps the
    wider of its own and x_in's dtype (an f32 cache leaf stays f32)."""
    k = p["conv_w"].shape[0]
    b, s, _ = x_in.shape
    if conv_state is None:
        conv_state = torch.zeros((b, k - 1, x_in.shape[-1]),
                                 dtype=x_in.dtype, device=x_in.device)
    wide = torch.promote_types(conv_state.dtype, x_in.dtype)
    padded = torch.cat([conv_state.to(wide), x_in.to(wide)], dim=1)
    out = torch.zeros(x_in.shape, dtype=torch.float32, device=x_in.device)
    for i in range(k):
        out = out + padded[:, i:i + s].to(torch.float32) * p["conv_w"][i]
    out = out + p["conv_b"]
    return F.silu(out).to(x_in.dtype), padded[:, -(k - 1):]


def _scan_dispatch(a, b, h0=None):
    """The (B, S, d_inner, d_state) recurrence, flattened to (B, S, F) for
    the scan front door.  Returns (h_all, h_last f32)."""
    bsz, s = a.shape[:2]
    feat = a.shape[2:]
    f = math.prod(feat)
    h0f = None if h0 is None else h0.reshape(bsz, f).to(torch.float32)
    h_all = kops.dispatch_linear_scan(a.reshape(bsz, s, f),
                                      b.reshape(bsz, s, f), h0f)
    h_all = h_all.reshape((bsz, s) + tuple(feat))
    return h_all, h_all[:, -1].to(torch.float32)


def mamba_scan_fused(delta, xi, bm, cm, a_mat, h0=None):
    """The memory-lean selective scan, as the JAX function of that name:
    delta, xi (B, S, di) f32; bm, cm (B, S, n) f32 (views of the x
    projection are fine); a_mat (di, n); h0 (B, di, n) or None.  Returns
    (y = C.h per step (B, S, di), h_last (B, di, n) f32)."""
    return SS.mamba_scan_fused(
        delta.contiguous(), xi.contiguous(), bm.contiguous(),
        cm.contiguous(), a_mat.contiguous(),
        None if h0 is None else h0.to(torch.float32).contiguous())


def _is_cut(par, t, dim: int, full: int) -> bool:
    """Whether leaf ``t`` holds a ``model`` shard of ``dim`` (``full``
    long whole)."""
    return par is not None and par.tp > 1 and t.shape[dim] != full


def _gathered_halves(par, y, half: int):
    """This rank's blocks of both halves of ``[a | b]`` (each ``half``
    long) from ``y``, its shard of the columns: ``y`` all-gathered over
    ``model`` (each rank uses a distinct part, so the summing backward is
    right), then the rank's ``half / tp`` columns of each half."""
    full = par.all_gather(y, -1, "model")
    c = half // par.tp
    lo = par.model_rank * c
    return full[..., lo:lo + c], full[..., half + lo:half + lo + c]


def apply_mamba(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                par=None):
    """x: (B, S, d).  state: {"conv": (B, k-1, di), "ssm": (B, di, n)} or
    None.  Returns (out (B, S, d) in x's dtype, {"conv", "ssm"}).
    ``par``: tensor parallel over ``model`` (module docstring; the
    state then covers the rank's channels)."""
    d_inner, dt_rank = mamba_dims(cfg)
    n = cfg.ssm.d_state
    dt_ = x.dtype
    f32 = torch.float32
    tp = _is_cut(par, p["conv_b"], 0, d_inner)

    if tp:
        xz = torch.matmul(par.f(x, "model"), p["in_proj"]).to(dt_)
        xi, z = _gathered_halves(par, xz, d_inner)
    else:
        xz = torch.matmul(x, p["in_proj"]).to(dt_)
        xi, z = torch.split(xz, d_inner, dim=-1)
    xi, new_conv = _mamba_conv(p, xi, state["conv"] if state else None)

    proj = matmul_f32(xi, p["x_proj"])
    if tp:
        # the row-parallel partial sums, summed; every rank then feeds
        # the whole to its own channels
        proj = par.f(par.g(proj, "model"), "model")
    dt_raw, bm, cm = torch.split(proj, [dt_rank, n, n], dim=-1)
    delta = F.softplus(torch.matmul(dt_raw, p["dt_proj"]) + p["dt_bias"])
    a_mat = -torch.exp(p["A_log"])                              # (di, n)

    # selective SSM: h_t = exp(delta A) h_{t-1} + delta B_t x_t; y = C_t.h
    xf = xi.to(f32)
    h0 = state["ssm"] if state else None
    if x.shape[1] > 1:
        y, h_last = mamba_scan_fused(delta, xf, bm, cm, a_mat, h0)
    else:
        a = torch.exp(delta[..., None] * a_mat)                  # (B,1,di,n)
        b = (delta * xf)[..., None] * bm[:, :, None, :]
        h_all, h_last = _scan_dispatch(a, b, h0)
        y = torch.matmul(h_all, cm[..., None])[..., 0]           # (B,1,di)
    y = y + xf * p["D"]
    y = (y * F.silu(z.to(f32))).to(dt_)
    out = torch.matmul(y, p["out_proj"]).to(dt_)
    if tp:
        out = par.g(out, "model")
    return out, {"conv": new_conv, "ssm": h_last}


def mamba_state_shape(cfg: ModelConfig, batch: int):
    d_inner, _ = mamba_dims(cfg)
    return {"conv": (batch, cfg.ssm.d_conv - 1, d_inner),
            "ssm": (batch, d_inner, cfg.ssm.d_state)}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig):
    d_inner = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return d_inner, d_inner // cfg.num_heads


def init_mlstm(generator, cfg: ModelConfig, device):
    """Random mLSTM weights with the JAX init constants (dense
    N(0,1)/sqrt(fan_in), the gate weights f32, f_bias = 3)."""
    d, h = cfg.d_model, cfg.num_heads
    d_inner, _ = mlstm_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    f32 = torch.float32
    return {
        "up_proj": dense_init(generator, (d, 2 * d_inner), d, dt, device),
        "wq": dense_init(generator, (d_inner, d_inner), d_inner, dt, device),
        "wk": dense_init(generator, (d_inner, d_inner), d_inner, dt, device),
        "wv": dense_init(generator, (d_inner, d_inner), d_inner, dt, device),
        "w_i": dense_init(generator, (d_inner, h), d_inner, f32, device),
        "w_f": dense_init(generator, (d_inner, h), d_inner, f32, device),
        "f_bias": torch.full((h,), 3.0, dtype=f32, device=device),
        "out_norm": {"scale": torch.ones((d_inner,), dtype=f32,
                                         device=device)},
        "down_proj": dense_init(generator, (d_inner, d), d_inner, dt,
                                device),
    }


def apply_mlstm(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                par=None):
    """Stabilized exponential-gating mLSTM, step by step over the
    sequence as JAX's ``lax.scan``.  x: (B, S, d); state: {"C", "n", "m"}
    or None.  Returns (out (B, S, d) in x's dtype, the last state).
    ``par``: tensor parallel over ``model`` (module docstring; the state
    then covers the heads the rank runs)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    d_inner, hd = mlstm_dims(cfg)
    dt_ = x.dtype
    f32 = torch.float32
    tp = _is_cut(par, p["wq"], 1, d_inner)
    w_i, w_f, f_bias = p["w_i"], p["w_f"], p["f_bias"]
    scale = p["out_norm"]["scale"]

    if tp:
        # the whole xin for the rank's q/k/v columns, z at its channels
        up = par.all_gather(torch.matmul(par.f(x, "model"), p["up_proj"])
                            .to(dt_), -1, "model")
        cols = d_inner // par.tp
        lo = par.model_rank * cols
        xin, z = up[..., :d_inner], up[..., d_inner + lo:d_inner + lo + cols]
    else:
        up = torch.matmul(x, p["up_proj"]).to(dt_)
        xin, z = torch.split(up, d_inner, dim=-1)
    q, k, v = (matmul_f32(xin, p[w]) for w in ("wq", "wk", "wv"))
    h0, nh = 0, h
    if tp:
        if h % par.tp:
            # a column block cuts a head: every rank runs every head
            q, k, v = (par.all_gather(t, -1, "model") for t in (q, k, v))
        else:
            nh = h // par.tp
            h0 = par.model_rank * nh
        # the replicated gate weights and norm scale at the rank's heads
        w_i, w_f, f_bias, scale = (par.f(t, "model")
                                   for t in (w_i, w_f, f_bias, scale))
        w_i, w_f = w_i[:, h0:h0 + nh], w_f[:, h0:h0 + nh]
        f_bias, scale = f_bias[h0:h0 + nh], scale[h0 * hd:(h0 + nh) * hd]
    q = q.reshape(b, s, nh, hd) / math.sqrt(hd)
    k = k.reshape(b, s, nh, hd)
    v = v.reshape(b, s, nh, hd)
    xf = xin.to(f32)
    i_gate = torch.matmul(xf, w_i)                               # (B,S,H)
    log_f = F.logsigmoid(torch.matmul(xf, w_f) + f_bias)

    if state is None:
        c = torch.zeros((b, nh, hd, hd), dtype=f32, device=x.device)
        n = torch.zeros((b, nh, hd), dtype=f32, device=x.device)
        m = torch.full((b, nh), -1e30, dtype=f32, device=x.device)
    else:
        c, n, m = state["C"], state["n"], state["m"]
    hs = torch.empty((b, s, nh, hd), dtype=f32, device=x.device)
    for t in range(s):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]
        i_t, lf_t = i_gate[:, t], log_f[:, t]
        m_new = torch.maximum(lf_t + m, i_t)
        f_eff = torch.exp(lf_t + m - m_new)
        i_eff = torch.exp(i_t - m_new)
        c = f_eff[..., None, None] * c \
            + i_eff[..., None, None] * (k_t[..., :, None] * v_t[..., None, :])
        n = f_eff[..., None] * n + i_eff[..., None] * k_t
        num = torch.matmul(q_t[..., None, :], c)[..., 0, :]      # (B,H,hd)
        den = torch.abs((q_t * n).sum(dim=-1))
        den = torch.maximum(den, torch.exp(-m_new))
        hs[:, t] = num / den[..., None]
        m = m_new

    # per-head RMS output norm, then the z gate and the down projection
    var = hs.square().mean(dim=-1, keepdim=True)
    hn = (hs * torch.rsqrt(var + 1e-6)).reshape(b, s, nh * hd)
    hn = hn * scale
    if tp and nh == h:
        hn = hn[..., lo:lo + cols]
    hn = (hn * F.silu(z.to(f32))).to(dt_)
    out = torch.matmul(hn, p["down_proj"]).to(dt_)
    if tp:
        out = par.g(out, "model")
    return out, {"C": c, "n": n, "m": m}


def mlstm_state_shape(cfg: ModelConfig, batch: int):
    _, hd = mlstm_dims(cfg)
    h = cfg.num_heads
    return {"C": (batch, h, hd, hd), "n": (batch, h, hd), "m": (batch, h)}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent mixing)
# ---------------------------------------------------------------------------

def init_slstm(generator, cfg: ModelConfig, device):
    """Random sLSTM weights with the JAX init constants: the input weights
    of the four gates (i, f, z, o), block-diagonal recurrent weights a
    head (H, hd, 4 hd) in f32, bias 0, f_bias 3, the GLU's up and down
    projections."""
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    d_ff = int(cfg.xlstm.slstm_proj_factor * d)
    dt = getattr(torch, cfg.param_dtype)
    f32 = torch.float32
    return {
        "w_x": dense_init(generator, (d, 4 * d), d, dt, device),
        "w_h": dense_init(generator, (h, hd, 4 * hd), hd, f32, device),
        "bias": torch.zeros((4 * d,), dtype=f32, device=device),
        "f_bias": torch.full((d,), 3.0, dtype=f32, device=device),
        "up": dense_init(generator, (d, 2 * d_ff), d, dt, device),
        "down": dense_init(generator, (d_ff, d), d_ff, dt, device),
    }


def apply_slstm(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                par=None):
    """Strictly sequential scalar-memory LSTM with exponential gating.
    x: (B, S, d); state: {"c", "n", "h", "m"}, each (B, d), or None.
    Returns (out (B, S, d) in x's dtype, the last state).

    The recurrent product is per head, ``(B, H, hd) @ (H, hd, 4 hd)``,
    laid out (B, 4 d); ``gx + rec`` is then cut into four contiguous
    chunks of d for i, f, z and o, as JAX cuts it (so a gate's chunk
    takes the recurrent outputs of every head).  ``par``: tensor
    parallel over ``model`` (module docstring: the recurrence runs whole
    on every rank)."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    d_ff = int(cfg.xlstm.slstm_proj_factor * d)
    dt_ = x.dtype
    f32 = torch.float32

    if _is_cut(par, p["w_x"], 1, 4 * d):
        gates_x = par.gather_replicated(
            matmul_f32(par.f(x, "model"), p["w_x"]), -1, "model")
    else:
        gates_x = matmul_f32(x, p["w_x"])
    gates_x = gates_x + p["bias"]                               # (B,S,4d)
    w_h = p["w_h"]                                              # (H,hd,4hd)
    if _is_cut(par, w_h, 0, h):
        w_h = par.gather_replicated(w_h, 0, "model")
    if state is None:
        c = torch.zeros((b, d), dtype=f32, device=x.device)
        n, hh = torch.zeros_like(c), torch.zeros_like(c)
        m = torch.full((b, d), -1e30, dtype=f32, device=x.device)
    else:
        c, n, hh, m = state["c"], state["n"], state["h"], state["m"]
    hs = torch.empty((b, s, d), dtype=f32, device=x.device)
    for t in range(s):
        rec = torch.matmul(hh.reshape(b, h, hd).transpose(0, 1), w_h)
        g = gates_x[:, t] + rec.transpose(0, 1).reshape(b, 4 * d)
        i_r, f_r, z_r, o_r = torch.split(g, d, dim=-1)
        lsf = F.logsigmoid(f_r + p["f_bias"])
        m_new = torch.maximum(lsf + m, i_r)
        i_e = torch.exp(i_r - m_new)
        f_e = torch.exp(lsf + m - m_new)
        c = f_e * c + i_e * torch.tanh(z_r)
        n = f_e * n + i_e
        hh = torch.sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs[:, t] = hh

    # post up/down projection: a GLU with JAX's default (tanh) GELU
    split = False
    if _is_cut(par, p["up"], 1, 2 * d_ff):
        up = matmul_f32(par.f(hs.to(dt_), "model"), p["up"])
        split = _is_cut(par, p["down"], 0, d_ff)
        if split:
            a, gate = _gathered_halves(par, up, d_ff)
        else:
            a, gate = torch.chunk(par.gather_replicated(up, -1, "model"), 2,
                                  dim=-1)
    else:
        up = matmul_f32(hs.to(dt_), p["up"])
        a, gate = torch.chunk(up, 2, dim=-1)
    y = (F.gelu(a, approximate="tanh") * gate).to(dt_)
    out = torch.matmul(y, p["down"]).to(dt_)
    if split:
        out = par.g(out, "model")
    return out, {"c": c, "n": n, "h": hh, "m": m}


def slstm_state_shape(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    return {"c": (batch, d), "n": (batch, d), "h": (batch, d),
            "m": (batch, d)}
