"""Dense flash attention: the hand-written Hopper kernel and its front door.

``flash_attention_bhsd`` keeps the JAX kernel's signature and layouts
(q (B,H,Sq,D), k/v (B,Hkv,Skv,D), q_pos (Sq,), k_pos (Skv,), k_valid
(Skv,)).  On CPU tensors it runs the plain version
(``ref.flash_attention_ref``); on CUDA tensors it launches
``csrc/flash_attention.cu`` or raises -- there is no fallback.

Gradients.  The JAX kernel has no backward of its own (no ``custom_vjp``
in the JAX package), so none is ported: ``_FlashAttention``, a
``torch.autograd.Function``, runs the hand-written kernel forward and
recomputes the attention in its backward through the plain version's
differentiable math (``ref.flash_attention_ref``), returning the
gradients of q, k and v.  That backward forms the (B, H, Sq, Skv) f32
scores; a Hopper flash backward from a saved row logsumexp is later
kernel work.  Every CUDA call goes through the Function: under
``torch.no_grad()``, as in serving, it records nothing and is the same
launch, with no extra copy and no host sync.  ``launches`` counts
forward launches (a remat recompute is one).

bf16 runs on the tensor cores, f32 on the CUDA cores.  In bf16 the
wrapper may split the keys (``flash_split``, from shapes alone): the
kernel then writes per-split partial rows into an f32 workspace
allocated here, and a combine pass of the same C call merges them.

Shape contract on CUDA: q, k, v contiguous and starting on a 16-byte
boundary (the kernel's cp.async copies), one dtype in {float32,
bfloat16}, D in {40, 60, 64, 128, 256}, H a multiple of Hkv; q_pos,
k_pos, k_valid contiguous int32 of lengths Sq, Skv, Skv; everything on
one device.  D = 40 and 60 (the paper's DeiT-160 and LV-ViT-T) run the
bf16 tile padded to 48 and 64 columns inside the kernel; the softmax
scale is 1/sqrt(D) of the true D, as in JAX.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as R

HEAD_DIMS = (40, 60, 64, 128, 256)


def check_flash_contract(q, k, v, q_pos, k_pos, k_valid):
    """Raise ValueError unless the operands fit the CUDA kernel's
    contract; returns (B, H, Hkv, Sq, Skv, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B,H,S,D)")
    b, h, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} outside the kernel's {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} heads is not a multiple of {hkv} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    _build.dtype_code(q.dtype)
    for name, t, n in (("q_pos", q_pos, sq), ("k_pos", k_pos, skv),
                       ("k_valid", k_valid, skv)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name} must be int32 of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = (q, k, v, q_pos, k_pos, k_valid)
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("flash attention operands must be contiguous")
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention operands must share one device")
    _build.check_aligned("flash attention", (q, k, v))
    return b, h, hkv, sq, skv, d


def flash_split(b, h, sq, skv, sms=132):
    """``(splits, keys_per_split)`` of a bf16 flash launch: (query tile,
    head, batch) blocks against the card's SMs, over the Skv keys."""
    return _build.split_plan(b * h * -(-sq // _build.MMA_ROWS), skv, sms)


def flash_attention_bhsd(q, k, v, q_pos, k_pos, k_valid, *, causal=True,
                         window=0, softcap=0.0):
    """q: (B,H,Sq,D), k/v: (B,Hkv,Skv,D) -> (B,H,Sq,D)."""
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, q_pos, k_pos, k_valid,
                                     causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, k_valid, causal,
                                 window, softcap)


def _launch(q, k, v, q_pos, k_pos, k_valid, causal, window, softcap):
    """One launch of ``csrc/flash_attention.cu`` on CUDA tensors."""
    b, h, hkv, sq, skv, d = check_flash_contract(q, k, v, q_pos, k_pos,
                                                 k_valid)
    lib = _build.load_library()
    out = torch.empty_like(q)
    splits, per = 1, 1
    if q.dtype == torch.bfloat16:
        splits, per = flash_split(b, h, sq, skv, _build.sm_count(q.device))
    ws_o, ws_ml = _build.split_workspace(q, splits, b * h * sq, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            _build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
            k_valid.data_ptr(), out.data_ptr(),
            None if ws_o is None else ws_o.data_ptr(),
            None if ws_ml is None else ws_ml.data_ptr(), splits, per, b, h,
            hkv, sq, skv, d, int(bool(causal)), int(window), float(softcap),
            1.0 / math.sqrt(d), stream)
    _build.check(err, "flash_attention_bhsd")
    flash_attention_bhsd.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain
    version and differentiates it (no backward kernel: see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, k_valid, causal, window,
                softcap):
        ctx.save_for_backward(q, k, v, q_pos, k_pos, k_valid)
        ctx.flags = (causal, window, softcap)
        return _launch(q, k, v, q_pos, k_pos, k_valid, causal, window,
                       softcap)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, q_pos, k_pos, k_valid = ctx.saved_tensors
        causal, window, softcap = ctx.flags
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = R.flash_attention_ref(*qkv, q_pos, k_pos, k_valid,
                                        causal=causal, window=window,
                                        softcap=softcap)
            grads = torch.autograd.grad(out, qkv, grad_out)
        return (*grads, None, None, None, None, None, None)


flash_attention_bhsd.launches = 0
