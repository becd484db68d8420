"""The Mamba-1 selective SSM mixer of the port (jamba's mamba layers).

Counterpart of the mamba half of the JAX package's ``models/ssm.py``:

  init_mamba(generator, cfg, device)        -> params
  apply_mamba(p, x, cfg, state=None)        -> (y, new_state)

``state`` is the O(1) recurrent state a slot carries between steps,
``{"conv": (B, d_conv - 1, d_inner), "ssm": (B, d_inner, d_state)}``
(both f32 in the caches); ``state=None`` starts from zeros.  The
selective SSM ``h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t``,
``y_t = C_t . h_t`` takes the path the JAX package takes with
``REPRO_MAMBA`` unset (the port reads no environment variable for it):

  * S > 1 (prefill): ``mamba_scan_fused``, the fused selective scan
    (``kernels/selective_scan.py``: the Hopper kernel on CUDA, its plain
    version on CPU), which forms the gate and input in registers and
    never materializes a (B, S, d_inner, d_state) tensor;
  * S == 1 (decode): the gate and input of the one step, (B, 1,
    d_inner * d_state) f32, through ``dispatch_linear_scan`` with the
    slot's state as h0, then the C contraction.

Dtypes as on the JAX side: the in/x/out projections take the activation
dtype; the in and out projections are cast back to it, and the x
projection keeps its f32 accumulator (``matmul_f32``).  ``conv_w``,
``conv_b``, ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` are f32 and
the scan runs in f32.
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


def apply_mamba(p, x, cfg: ModelConfig, state: Optional[dict] = None):
    """x: (B, S, d).  state: {"conv": (B, k-1, di), "ssm": (B, di, n)} or
    None.  Returns (out (B, S, d) in x's dtype, {"conv", "ssm"})."""
    d_inner, dt_rank = mamba_dims(cfg)
    n = cfg.ssm.d_state
    dt_ = x.dtype
    f32 = torch.float32

    xz = torch.matmul(x, p["in_proj"]).to(dt_)
    xi, z = torch.split(xz, d_inner, dim=-1)
    xi, new_conv = _mamba_conv(p, xi, state["conv"] if state else None)

    proj = matmul_f32(xi, p["x_proj"])
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
    return out, {"conv": new_conv, "ssm": h_last}


def mamba_state_shape(cfg: ModelConfig, batch: int):
    d_inner, _ = mamba_dims(cfg)
    return {"conv": (batch, cfg.ssm.d_conv - 1, d_inner),
            "ssm": (batch, d_inner, cfg.ssm.d_state)}
