#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of the repository; it puts ``src`` on ``sys.path``
itself and imports only ``repro_torch``, torch and numpy.  Without a CUDA
device it fails (it never runs on the CPU instead).  Phases, in order:

  1. card identity (``nvidia-smi`` name and power limit); TF32 off for
     matmuls and cuDNN, so f32 means f32;
  2. build of the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
     process per source, into ``build/``);
  3. each kernel against its plain PyTorch version on the same CUDA
     tensors at the main path's shapes (H=32, Hkv=4, G=8, D=128, page 16),
     f32 and bf16, timed with CUDA events (L2 flushed before every launch)
     beside the bound the card's peaks give, the plain version, and
     ``F.scaled_dot_product_attention`` on the gathered K/V as the library
     yardstick (timed here only: the port never calls it); then the fused
     decode's int8 mode (written rows and scales bit-equal), the paged
     prefill over int8 pools, and the verify window (B=4, S=5, per-slot
     offsets 100-1000) over fp and int8 pools;
  4. f32 end-to-end parity: yi-6b at full width, 2 layers; the paged
     engine (4 slots, 6 staggered requests, one warm-prefix admission)
     must give each request the same greedy stream as the port's one-shot
     gold (dense prefill through the flash kernel, then dense decode);
     with a repeated segment in every prompt, so that drafting engages,
     ``speculate=4`` (dense and paged fp) must give the gold's streams,
     and int8 pools the same streams with ``speculate=4`` as without;
  5. the main path at full size: yi-6b, all 32 layers, bf16, random
     weights from ``torch.Generator`` seed 0, served by the paged engine
     (4 slots, max_seq 1024, 8 requests of 100-600 prompt tokens, four
     sharing a 256-token prefix, 64 new tokens each), plus one full-size
     ``Model.forward`` through the flash kernel; then served again on
     int8 pools with ``speculate=4`` (8 prompts that each repeat a
     32-token segment).  The kernels' launch counters are zeroed just
     before each serve and read just after: each must be nonzero, and
     every logit finite.  A short profiled decode window follows each
     serve.

It prints a ``{"kernels": [...]}`` JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Measurements are also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BYTES = 3.35e12            # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, /s
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# f32: order of summation only.  bf16: the plain versions round softmax
# probabilities (and the fused decode its roped query) to bf16 where the
# kernels keep f32; one bf16 ulp is 2^-8 relative.


class CheckFailed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise CheckFailed(msg)


def bench(fn, flush, iters=20, warmup=3):
    """Median ms of ``fn`` on the current stream, L2 flushed first."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts,
                                                                 ends)]))


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def assert_close(name, a, b, dtype):
    err = max_err(a, b)
    tol = TOL[dtype]
    ok = torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
    print(f"[kernels] {name} {str(dtype)[6:]}: max_abs_err={err:.3g} "
          f"(atol=rtol={tol}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} {dtype} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev, flush):
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    hk, g, d, page = 4, 8, 128, 16
    h = hk * g
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        # -- fused paged decode: B=8 at ragged positions up to ~1000 -------
        b, nb = 8, 64
        n = b * nb + 1
        pos = torch.tensor([999, 15, 16, 511, 256, 3, 640, 1000],
                           dtype=torch.int32, device=dev)
        bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
            b, nb).to(torch.int32)
        kp, vp = rnd((n, page, hk, d), dtype), rnd((n, page, hk, d), dtype)
        q, kn, vn = rnd((b, hk, g, d), dtype), rnd((b, hk, d), dtype), \
            rnd((b, hk, d), dtype)
        kpk, vpk, kpr, vpr = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        out = TP.fused_paged_decode_grouped(q, kn, vn, kpk, vpk, bt, pos,
                                            theta=5e6)[0]
        ref = TR.fused_paged_decode_ref(q, kn, vn, kpr, vpr, bt, pos,
                                        theta=5e6)[0]
        torch.cuda.synchronize()
        err = max(assert_close("fused_paged_decode out", out, ref, dtype),
                  assert_close("fused_paged_decode k_pages", kpk, kpr, dtype),
                  assert_close("fused_paged_decode v_pages", vpk, vpr, dtype))
        ms = bench(lambda: TP.fused_paged_decode_grouped(
            q, kn, vn, kpk, vpk, bt, pos, theta=5e6), flush)
        plain = bench(lambda: TR.fused_paged_decode_ref(
            q, kn, vn, kpr, vpr, bt, pos, theta=5e6), flush)
        # library yardstick: SDPA over the gathered, length-masked K/V
        kg = kp[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        vg = vp[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        kg = kg.repeat_interleave(g, 1).contiguous()
        vg = vg.repeat_interleave(g, 1).contiguous()
        qs = q.reshape(b, h, 1, d)
        mask = (torch.arange(nb * page, device=dev)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        lib = bench(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), flush)
        keys = int((pos.long() + 1).sum())
        nbytes = (2 * b * h * d + 4 * b * hk * d + 2 * keys * hk * d) * el \
            + 4 * (b + int(((pos.long() + page) // page).sum()))
        bnd, by = bound_ms(nbytes, 4 * keys * hk * g * d, dtype)
        results[("fused_paged_decode", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by, shape=f"B={b} Hkv={hk} G={g} D={d} "
            f"P={page} NB={nb} pos<=1000")

        # -- paged prefill: S=256 at offset 0 and 256, 1024-token table ----
        b, nb, s = 1, 64, 256
        n = nb + 1
        bt = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        kp, vp = rnd((n, page, hk, d), dtype), rnd((n, page, hk, d), dtype)
        q = rnd((b, hk, g, s, d), dtype)
        for offset in (0, 256):
            out = TP.paged_prefill_attention_grouped(q, kp, vp, bt, offset)
            ref = TR.paged_prefill_attention_ref(q, kp, vp, bt, offset)
            err = assert_close(f"paged_prefill offset={offset}", out, ref,
                               dtype)
        ms = bench(lambda: TP.paged_prefill_attention_grouped(
            q, kp, vp, bt, offset), flush)
        plain = bench(lambda: TR.paged_prefill_attention_ref(
            q, kp, vp, bt, offset), flush)
        kg = kp[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        vg = vp[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        kg = kg.repeat_interleave(g, 1).contiguous()
        vg = vg.repeat_interleave(g, 1).contiguous()
        qs = q.reshape(b, h, s, d)
        mask = (torch.arange(nb * page, device=dev)[None, :]
                <= offset + torch.arange(s, device=dev)[:, None])
        lib = bench(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), flush)
        t = offset + s
        pairs = s * offset + s * (s + 1) // 2
        nbytes = (2 * hk * g * s * d + 2 * t * hk * d) * el \
            + 4 * (-(-t // page))
        bnd, by = bound_ms(nbytes, 4 * pairs * hk * g * d, dtype)
        results[("paged_prefill", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by, shape=f"B=1 Hkv={hk} G={g} S={s} "
            f"offset={offset} D={d} P={page} NB={nb}")

        # -- flash: Sq=Skv=512 causal, plus a window / k_valid case -------
        b, s = 1, 512
        q = rnd((b, h, s, d), dtype)
        k, v = rnd((b, hk, s, d), dtype), rnd((b, hk, s, d), dtype)
        qp = torch.arange(s, dtype=torch.int32, device=dev)
        ones = torch.ones((s,), dtype=torch.int32, device=dev)
        holes = (qp % 9 != 4).to(torch.int32)
        for kw, kv in ((dict(causal=True), ones),
                       (dict(causal=True, window=128, softcap=30.0), holes)):
            out = TF.flash_attention_bhsd(q, k, v, qp, qp, kv, **kw)
            ref = TR.flash_attention_ref(q, k, v, qp, qp, kv, **kw)
            e = assert_close(f"flash_attention {kw}", out, ref, dtype)
            if kv is ones:
                err = e
        ms = bench(lambda: TF.flash_attention_bhsd(q, k, v, qp, qp, ones),
                   flush)
        plain = bench(lambda: TR.flash_attention_ref(q, k, v, qp, qp, ones),
                      flush)
        kr = k.repeat_interleave(g, 1).contiguous()
        vr = v.repeat_interleave(g, 1).contiguous()
        lib = bench(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True), flush)
        pairs = s * (s + 1) // 2
        nbytes = (2 * b * h * s * d + 2 * b * hk * s * d) * el + 12 * s
        bnd, by = bound_ms(nbytes, 4 * pairs * h * d, dtype)
        results[("flash_attention", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by,
            shape=f"B=1 H={h} Hkv={hk} Sq=Skv={s} causal D={d}")
        for name in ("fused_paged_decode", "paged_prefill",
                     "flash_attention"):
            r = results[(name, dtype)]
            print(f"[kernels] {name} {str(dtype)[6:]} ({r['shape']}): "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def int8_kernel_phase(dev, flush, results):
    """Phase 3, int8 pools and the verify window: the fused decode's int8
    mode (written rows and scales bit-equal to the plain version's), the
    paged prefill kernel over int8 pools, and the verify window (per-slot
    offsets) over fp and int8 pools.  SDPA runs on K/V dequantized and
    gathered beforehand (untimed)."""
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    hk, g, d, page = 4, 8, 128, 16
    h = hk * g
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def gathered(kp, vp, ks, vs, bt, dtype):
        """(B, H, T, D) K/V in logical order for the SDPA yardstick."""
        b, nb = bt.shape
        kg = TR.dequantize_int8(kp, ks) if ks is not None else kp.float()
        vg = TR.dequantize_int8(vp, vs) if vs is not None else vp.float()
        kg = kg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        vg = vg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
        return (kg.repeat_interleave(g, 1).to(dtype).contiguous(),
                vg.repeat_interleave(g, 1).to(dtype).contiguous())

    def window_bytes(keys, rows, el, row_bytes, tables):
        return 2 * rows * h * d * el + 2 * keys * hk * row_bytes \
            + 4 * tables

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        # -- int8 fused decode: B=8 at ragged positions up to 1000 --------
        b, nb = 8, 64
        n = b * nb + 1
        pos = torch.tensor([999, 15, 16, 511, 256, 3, 640, 1000],
                           dtype=torch.int32, device=dev)
        bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
            b, nb).to(torch.int32)
        kp, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        vp, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        q, kn, vn = rnd((b, hk, g, d), dtype), rnd((b, hk, d), dtype), \
            rnd((b, hk, d), dtype)
        mine = [kp.clone(), vp.clone(), ks.clone(), vs.clone()]
        plain = [kp.clone(), vp.clone(), ks.clone(), vs.clone()]
        out = TP.fused_paged_decode_grouped(
            q, kn, vn, mine[0], mine[1], bt, pos, theta=5e6,
            k_scales=mine[2], v_scales=mine[3])[0]
        ref = TR.fused_paged_decode_ref(
            q, kn, vn, plain[0], plain[1], bt, pos, theta=5e6,
            k_scales=plain[2], v_scales=plain[3])[0]
        torch.cuda.synchronize()
        err = assert_close("fused_paged_decode int8 out", out, ref, dtype)
        for name, a, r in zip(("k_pages", "v_pages", "k_scales",
                               "v_scales"), mine, plain):
            same = torch.equal(a, r)
            print(f"[kernels] fused_paged_decode int8 {str(dtype)[6:]} "
                  f"written {name} bit-equal: {same}")
            check(same, f"int8 fused decode {name} differ from the plain "
                        f"version's ({dtype})")
        ms = bench(lambda: TP.fused_paged_decode_grouped(
            q, kn, vn, mine[0], mine[1], bt, pos, theta=5e6,
            k_scales=mine[2], v_scales=mine[3]), flush)
        pl = bench(lambda: TR.fused_paged_decode_ref(
            q, kn, vn, plain[0], plain[1], bt, pos, theta=5e6,
            k_scales=plain[2], v_scales=plain[3]), flush)
        kg, vg = gathered(kp, vp, ks, vs, bt, dtype)
        qs = q.reshape(b, h, 1, d)
        mask = (torch.arange(nb * page, device=dev)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        lib = bench(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), flush)
        keys = int((pos.long() + 1).sum())
        nbytes = window_bytes(keys, b, el, d + 4,
                              int(((pos.long() + page) // page).sum())) \
            + 2 * b * hk * d * el
        bnd, by = bound_ms(nbytes, 4 * keys * hk * g * d, dtype)
        results[("fused_paged_decode_int8", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
            bound_ms=bnd, bound_by=by, shape=f"B={b} Hkv={hk} G={g} D={d} "
            f"P={page} NB={nb} pos<=1000 int8 pools")

        # -- int8 paged prefill: S=256 at offset 0 and 256 -----------------
        b, nb, s = 1, 64, 256
        n = nb + 1
        bt = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        kp, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        vp, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        sc = dict(k_scales=ks, v_scales=vs)
        q = rnd((b, hk, g, s, d), dtype)
        for offset in (0, 256):
            out = TP.paged_prefill_attention_grouped(q, kp, vp, bt, offset,
                                                     **sc)
            ref = TR.paged_prefill_attention_ref(q, kp, vp, bt, offset,
                                                 **sc)
            err = assert_close(f"paged_prefill int8 offset={offset}", out,
                               ref, dtype)
        ms = bench(lambda: TP.paged_prefill_attention_grouped(
            q, kp, vp, bt, offset, **sc), flush)
        pl = bench(lambda: TR.paged_prefill_attention_ref(
            q, kp, vp, bt, offset, **sc), flush)
        kg, vg = gathered(kp, vp, ks, vs, bt, dtype)
        mask = (torch.arange(nb * page, device=dev)[None, :]
                <= offset + torch.arange(s, device=dev)[:, None])
        qs = q.reshape(b, h, s, d)
        lib = bench(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask), flush)
        t = offset + s
        pairs = s * offset + s * (s + 1) // 2
        nbytes = window_bytes(t, s, el, d + 4, -(-t // page))
        bnd, by = bound_ms(nbytes, 4 * pairs * hk * g * d, dtype)
        results[("paged_prefill_int8", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
            bound_ms=bnd, bound_by=by, shape=f"B=1 Hkv={hk} G={g} S={s} "
            f"offset={offset} D={d} P={page} NB={nb} int8 pools")

        # -- verify: B=4, S=K+1=5 at per-slot offsets 100-1000 -------------
        b, nb, s = 4, 64, 5
        n = b * nb + 1
        offs = torch.tensor([100, 371, 640, 1000], dtype=torch.int32,
                            device=dev)
        bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
            b, nb).to(torch.int32)
        kp, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        vp, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        q = rnd((b, hk, g, s, d), dtype)
        qpos = offs.long()[:, None] + torch.arange(s, device=dev)[None]
        mask = (torch.arange(nb * page, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]
        qs = q.reshape(b, h, s, d)
        keys = int((qpos[:, -1] + 1).sum())
        pairs = int((qpos + 1).sum())
        tables = int(((qpos[:, -1] + page) // page).sum())
        for pool in ("fp", "int8"):
            if pool == "int8":
                pools, sc, row_bytes = (kp, vp), dict(k_scales=ks,
                                                      v_scales=vs), d + 4
            else:
                pools = (TR.dequantize_int8(kp, ks).to(dtype),
                         TR.dequantize_int8(vp, vs).to(dtype))
                sc, row_bytes = {}, d * el
            out = TP.paged_verify_attention_grouped(q, *pools, bt, offs,
                                                    **sc)
            ref = TR.paged_verify_attention_ref(q, *pools, bt, offs, **sc)
            err = assert_close(f"paged_verify {pool} pools", out, ref, dtype)
            ms = bench(lambda: TP.paged_verify_attention_grouped(
                q, *pools, bt, offs, **sc), flush)
            pl = bench(lambda: TR.paged_verify_attention_ref(
                q, *pools, bt, offs, **sc), flush)
            kg, vg = gathered(*pools, sc.get("k_scales"),
                              sc.get("v_scales"), bt, dtype)
            lib = bench(lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask), flush)
            nbytes = window_bytes(keys, b * s, el, row_bytes, tables) \
                + 4 * b
            bnd, by = bound_ms(nbytes, 4 * pairs * hk * g * d, dtype)
            name = "paged_verify" if pool == "int8" else "paged_verify_fp"
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
                bound_ms=bnd, bound_by=by, shape=f"B={b} Hkv={hk} G={g} "
                f"S={s} offsets 100-1000 D={d} P={page} NB={nb} {pool} pools")
        for name in ("fused_paged_decode_int8", "paged_prefill_int8",
                     "paged_verify", "paged_verify_fp"):
            r = results[(name, dtype)]
            print(f"[kernels] {name} {str(dtype)[6:]} ({r['shape']}): "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving path
# ---------------------------------------------------------------------------

def gold_decode(model, params, prompt, max_new, max_seq):
    """The port's isolated one-shot greedy decode: dense prefill (flash
    kernel), then lock-step dense decode.  Returns (tokens, logits)."""
    from repro_torch.serving import make_serve_step
    logits, cache = model.prefill(params, {"tokens": prompt[None]}, max_seq)
    out, lgs = [int(logits[0, -1].argmax())], [logits[0, -1]]
    step = make_serve_step(model)
    pos = len(prompt)
    while len(out) < max_new and pos < max_seq - 1:
        nxt, logits, cache = step(params, cache,
                                  np.array([[out[-1]]], np.int32), pos)
        out.append(int(nxt[0, 0]))
        lgs.append(logits[0, -1])
        pos += 1
    return out, lgs


def top2_gap(logits):
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def run_schedule(eng, sched, request_cls):
    pending = sorted(enumerate(sched), key=lambda x: x[1][2])
    tick, busy = 0, True
    while busy or pending:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _) = pending.pop(0)
            eng.submit(request_cls(uid, prompt, max_new))
        busy = eng.tick()
        tick += 1
    return {r.uid: r for r in eng.done}


def compare_streams(label, got, refs, gaps):
    """Every stream of ``got`` ({uid: Request}) must equal ``refs``
    ({uid: tokens}); on a difference the reference's top-2 logit gap at
    that step is printed (``gaps[uid][step]``) and the check fails."""
    for uid, ref in refs.items():
        mine = got[uid].out_tokens
        if mine != ref:
            i = next((j for j, (a, b) in enumerate(zip(mine, ref))
                      if a != b), min(len(mine), len(ref)))
            g = gaps.get(uid, [])
            gap = f"{g[min(i, len(g) - 1)]:.3g}" if g else "not recorded"
            print(f"[parity] {label} uid={uid} first differs at step {i}: "
                  f"engine {mine[i:i + 3]} reference {ref[i:i + 3]}, "
                  f"reference top-2 logit gap {gap}")
            check(False, f"{label}: stream of request {uid} differs")
    print(f"[parity] {label}: all {len(refs)} streams equal")


def watch_engine(eng, model, max_seq):
    """Wrap a paged or dense engine's steps so that every logit they
    produce is checked for finiteness and, for plain decode steps, each
    slot's top-2 logit gap is recorded per (uid, token index)."""
    finite, gaps = [], {}

    def serve_step(params, cache, tokens, cache_index, block_tables=None):
        live = [(s, r.uid, len(r.out_tokens))
                for s, r in enumerate(eng._slot_req) if r is not None]
        logits, cache = model.decode_step(params, cache, tokens, cache_index,
                                          block_tables=block_tables)
        finite.append(torch.isfinite(logits).all())
        for slot, uid, idx in live:
            g = gaps.setdefault(uid, [])
            g += [float("nan")] * (idx + 1 - len(g))
            g[idx] = top2_gap(logits[slot, -1])
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None], logits, \
            cache

    def verify_step(params, cache, tokens, cache_index, block_tables=None):
        logits, cache = model.decode_step(params, cache, tokens, cache_index,
                                          block_tables=block_tables)
        finite.append(torch.isfinite(logits).all())
        return logits.argmax(-1).to(torch.int32), cache

    def prefill(params, cache, tokens, slot, offset, length, bt, wt):
        logits, cache = model.prefill_suffix_paged(
            params, cache, tokens, slot, offset, length, max_seq, bt, wt)
        finite.append(torch.isfinite(logits).all())
        return logits[:, -1].argmax(-1).to(torch.int32), cache

    eng.serve_step = serve_step
    if eng._spec_k:
        eng._verify_step = verify_step
    if eng.paged:
        eng._prefill_suffix_paged = prefill
    return finite, gaps


def would_draft(sched, streams, k=4):
    """True when, replaying ``streams`` ({uid: tokens}) token by token,
    the drafter would propose for some request at some decode tick with a
    nonzero budget.  Until the first draft every tick is a plain decode
    that advances each slot by one token, so the engine then drafts too."""
    from repro_torch.serving import ngram_draft
    for uid, (prompt, max_new, _) in enumerate(sched):
        out = streams[uid]
        for j in range(1, len(out)):
            budget = min(k, max_new - j - 1)
            if budget > 0 and ngram_draft(np.concatenate(
                    [prompt, np.asarray(out[:j], np.int32)]), budget):
                return True
    return False


def parity_phase(dev):
    """Phase 4, f32 at full width and 2 layers: the paged engine against
    the one-shot gold; then, on a variant of the schedule on which the
    drafter proposes, speculate=4 on the dense and the paged fp engine
    against that schedule's gold, and int8 pools with speculate=4 against
    int8 pools without it."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(REGISTRY["yi-6b"], num_layers=2,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    v = cfg.vocab_size

    def toks(n):
        return rng.integers(1, v, n).astype(np.int32)

    prefix = toks(64)
    sched = [(np.concatenate([prefix, toks(16)]), 4, 0),
             (toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
             (np.concatenate([prefix, toks(30)]), 10, 3),   # warm prefix
             (toks(70), 9, 5)]
    max_seq = 256
    eng = ServingEngine(model, params, slots=4, max_seq=max_seq, paged=True,
                        page_size=16)
    got = run_schedule(eng, sched, Request)
    st = eng.cache_stats()
    print(f"[parity] f32 yi-6b 2 layers: {len(got)} requests, warm "
          f"admissions {st['prefill_compute_hits']}, reused prefix tokens "
          f"{st['reused_prefill_tokens']}")
    check(st["prefill_compute_hits"] >= 1
          and st["reused_prefill_tokens"] >= 64,
          "the warm-prefix admission did not reuse the shared prefix")
    golds, gaps = {}, {}
    for uid, (prompt, max_new, _) in enumerate(sched):
        golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                      max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    compare_streams("paged fp vs one-shot gold", got, golds, gaps)

    # speculation: the drafter proposes only where the context repeats an
    # n-gram, and at this depth and vocabulary that depends on what the
    # random model generates.  So redraw the prompts' last 8 tokens (the
    # shared prefix stays) until the gold streams and the int8 streams
    # without speculation both predict a draft, and verify and rollback
    # are sure to run on fp and int8 pools.
    base = sched
    for attempt in range(16):
        redraw = np.random.default_rng(100 + attempt)
        sched = [(np.concatenate([p[:-8], redraw.integers(1, v, 8)]).astype(
            np.int32), m + 8, t) for p, m, t in base]
        golds, gaps = {}, {}
        for uid, (prompt, max_new, _) in enumerate(sched):
            golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                          max_seq)
            gaps[uid] = [top2_gap(x) for x in lgs]
        eng = ServingEngine(model, params, slots=4, max_seq=max_seq,
                            paged=True, page_size=16, kv_dtype="int8")
        finite, int8_gaps = watch_engine(eng, model, max_seq)
        int8_got = run_schedule(eng, sched, Request)
        check(bool(torch.stack(finite).all()),
              "int8 speculate=0: non-finite logits")
        int8_ref = {u: q.out_tokens for u, q in int8_got.items()}
        if would_draft(sched, golds) and would_draft(sched, int8_ref):
            break
    else:
        check(False, "no schedule variant makes the drafter propose")
    print(f"[parity] speculation schedule: variant {attempt} (prompts' last "
          f"8 tokens redrawn, 8 more new tokens each)")
    spec_keys = ("spec_steps", "spec_proposed", "spec_accepted",
                 "acceptance_rate", "tokens_per_step")
    spec = {}
    for label, kw in (("dense fp speculate=4", {}),
                      ("paged fp speculate=4", dict(paged=True,
                                                    page_size=16))):
        eng = ServingEngine(model, params, slots=4, max_seq=max_seq,
                            speculate=4, **kw)
        finite, _ = watch_engine(eng, model, max_seq)
        got = run_schedule(eng, sched, Request)
        check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
        compare_streams(f"{label} vs one-shot gold", got, golds, gaps)
        spec[label] = {k: eng.stats()[k] for k in spec_keys}
        print(f"[parity] {label}: {json.dumps(spec[label])}")
        check(spec[label]["spec_steps"] > 0, f"{label}: nothing verified")

    eng = ServingEngine(model, params, slots=4, max_seq=max_seq, paged=True,
                        page_size=16, kv_dtype="int8", speculate=4)
    finite, _ = watch_engine(eng, model, max_seq)
    got = run_schedule(eng, sched, Request)
    check(bool(torch.stack(finite).all()),
          "int8 speculate=4: non-finite logits")
    compare_streams("paged int8 speculate=4 vs speculate=0", got, int8_ref,
                    int8_gaps)
    firsts = all(int8_ref[u][0] == golds[u][0] for u in golds)
    print(f"[parity] int8 first tokens equal the fp gold's: {firsts}")
    check(firsts, "an int8 first token differs from the fp engine's")
    agree = sum(int8_ref[u] == golds[u] for u in golds)
    print(f"[parity] int8 streams equal to the fp gold in full: {agree} of "
          f"{len(golds)} (printed, not checked: int8 rounds K/V)")
    spec["paged int8 speculate=4"] = {k: eng.stats()[k] for k in spec_keys}
    print(f"[parity] paged int8 speculate=4: "
          f"{json.dumps(spec['paged int8 speculate=4'])}")
    check(spec["paged int8 speculate=4"]["spec_steps"] > 0,
          "int8 speculate=4: nothing verified")
    del eng, params
    torch.cuda.empty_cache()
    return dict(spec=spec, int8_equal_fp_gold=agree)


def serve_prompts(cfg, seed, repeat_segment):
    """8 prompts of 100-600 tokens, the first four sharing a 256-token
    prefix.  With ``repeat_segment`` every prompt holds a 32-token segment
    twice, so that prompt-lookup drafting has n-grams to match."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    prefix = rng.integers(1, v, 256).astype(np.int32)
    prompts = []
    for i in range(8):
        if i < 4:
            n = int(rng.integers(300, 601))
            p = np.concatenate([prefix, rng.integers(1, v, n - 256)])
        else:
            p = rng.integers(1, v, int(rng.integers(100, 601)))
        if repeat_segment:
            p[-32:] = p[-96:-64]        # ... seg, 32 others, seg
        prompts.append(p.astype(np.int32))
    return prompts


def serve_run(label, model, params, prompts, kernels, new=64, **engine_kw):
    """Serve ``prompts`` at full size, the kernels' launch counters set to
    0 just before and read just after.  Returns (engine, results)."""
    from repro_torch.serving import Request, ServingEngine
    max_seq = 1024
    eng = ServingEngine(model, params, slots=4, max_seq=max_seq, paged=True,
                        page_size=16, **engine_kw)
    finite, _ = watch_engine(eng, model, max_seq)
    draft_s = [0.0]                     # host time of prompt-lookup drafting
    if eng._spec_k:
        draft_all = eng._draft_all

        def timed_draft_all():
            t = time.perf_counter()
            out = draft_all()
            draft_s[0] += time.perf_counter() - t
            return out
        eng._draft_all = timed_draft_all
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, new))
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    st = eng.stats()
    ttft = sorted(st["ttft_s"])
    tick = st["phase_time_s"]["decode"] / max(st["decode_steps"], 1)
    print(f"[serve] {label}: {len(done)} requests, {st['gen_tokens']} "
          f"tokens in {wall:.3f} s: {st['gen_tokens'] / wall:.2f} tok/s; "
          f"TTFT p50 {ttft[len(ttft) // 2]:.4f} s, max {ttft[-1]:.4f} s; "
          f"decode steps {st['decode_steps']}, tick {tick * 1e3:.2f} ms; "
          f"warm admissions {st['cache']['prefill_compute_hits']} (reused "
          f"{st['cache']['reused_prefill_tokens']} tokens)")
    print(f"[serve] {label}: spec steps {st['spec_steps']}, "
          f"acceptance_rate {st['acceptance_rate']:.4f}, tokens_per_step "
          f"{st['tokens_per_step']:.4f}, kv {st['cache']['kv_dtype']} "
          f"kv_capacity_x {st['cache']['kv_capacity_x']:.4f}; drafting "
          f"{draft_s[0]:.4f} s of host time")
    print(f"[serve] {label}: phase_time_s {json.dumps(st['phase_time_s'])}")
    print(f"[serve] {label}: launches on the path: {json.dumps(launches)}")
    check(len(done) == len(prompts)
          and all(len(done[u].out_tokens) == new for u in done),
          f"{label}: not every request finished its {new} tokens")
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a kernel of the path never launched: {launches}")
    return eng, dict(
        launches=launches, tok_s=st["gen_tokens"] / wall, wall_s=wall,
        ttft_s=ttft, phase_time_s=st["phase_time_s"], tick_s=tick,
        draft_s=draft_s[0],
        decode_steps=st["decode_steps"], cache=st["cache"],
        spec={k: st[k] for k in ("spec_steps", "spec_proposed",
                                 "spec_accepted", "acceptance_rate",
                                 "tokens_per_step")},
        first_tokens=[done[u].out_tokens[0] for u in sorted(done)])


def serve_phase(dev, kernels):
    """Phase 5: full-size yi-6b bf16 served twice on the same weights --
    the fp paged engine (serve-full, then one full-size forward
    through the flash kernel), and the paged engine with int8 pools and
    speculate=4 on prompts that repeat a segment."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    cfg = REGISTRY["yi-6b"]
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    print(f"[serve] yi-6b bf16 full size: {nparam / 1e9:.3f} B params, "
          f"{nparam * 2 / 1e9:.1f} GB, init {time.perf_counter() - t0:.1f} s")
    fp_kernels = {k: kernels[k] for k in ("fused_paged_decode",
                                          "paged_prefill",
                                          "flash_attention")}
    prompts = serve_prompts(cfg, 0, repeat_segment=False)
    for fn in kernels.values():
        fn.launches = 0
    eng, fp = serve_run("fp paged", model, params, prompts, {})
    # one full-size forward over the prompt of a served request (flash)
    logits, _ = model.forward(params, {"tokens": prompts[0][None]})
    fin = bool(torch.isfinite(logits).all())
    same = int(logits[0, -1].argmax()) == fp["first_tokens"][0]
    torch.cuda.synchronize()
    fp["launches"] = {name: fn.launches for name, fn in fp_kernels.items()}
    print(f"[serve] Model.forward last-position argmax equals the served "
          f"first token: {same} (printed, not checked: bf16 near-ties)")
    print(f"[serve] fp paged + forward: launches on the path: "
          f"{json.dumps(fp['launches'])}")
    check(fin, "non-finite logits in the full-size forward")
    check(all(n > 0 for n in fp["launches"].values()),
          f"a kernel of the fp path never launched: {fp['launches']}")
    fp["forward_argmax_matches"] = same
    fp["profile"] = profile_decode(eng, prompts[4:], Request)
    del eng
    torch.cuda.empty_cache()

    int8_kernels = {"fused_paged_decode_int8": kernels["fused_paged_decode"],
                    "paged_prefill_int8": kernels["paged_prefill"],
                    "paged_verify": kernels["paged_verify"]}
    prompts = serve_prompts(cfg, 1, repeat_segment=True)
    eng, q8 = serve_run("int8 speculate=4", model, params, prompts,
                        int8_kernels, kv_dtype="int8", speculate=4)
    q8["profile"] = profile_decode(eng, prompts[4:], Request)
    return dict(fp=fp, int8_spec=q8,
                launches={**fp["launches"], **q8["launches"]})


def profile_decode(eng, prompts, request_cls):
    """Where a decode tick's time goes: a short served window (4 requests
    of 16 tokens, after the measured run) under ``torch.profiler``.
    Reports the device's busy share of the window's wall time and device
    time by kernel class.  Diagnostic only: a profiler that records no
    device time is reported, not failed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(100 + uid, p[:100], 16))
    eng.tick()                          # admissions outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ticks = 0
        while eng.tick():
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU op that launched
    # a kernel is credited with the same device time and is skipped
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_kernel[evt.key] = (by_kernel.get(evt.key, 0.0)
                                  + evt.self_device_time_total / 1e6)
    classes = {"fused_paged_decode": 0.0, "paged_verify": 0.0, "gemm": 0.0,
               "copy": 0.0, "other": 0.0}
    for key, sec in by_kernel.items():
        low = key.lower()
        if "fused_decode_kernel" in key:
            classes["fused_paged_decode"] += sec
        elif "paged_prefill_kernel" in key:    # the verify windows
            classes["paged_verify"] += sec
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass")):
            classes["gemm"] += sec
        elif "copy" in low:
            classes["copy"] += sec
        else:
            classes["other"] += sec
    busy = sum(classes.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    # host side: self CPU seconds and calls by op, and the calls that
    # wait for the device (synchronize, device-to-host copies)
    host = sorted(((evt.self_cpu_time_total / 1e6, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CPU), reverse=True)
    waits = {k: (round(sec, 5), n) for sec, n, k in host
             if "Synchronize" in k or "nonzero" in k or "item" in k
             or "_local_scalar_dense" in k}
    print(f"[profile] {ticks + 1} decode ticks, wall {wall:.4f} s, device "
          f"busy {busy:.4f} s ({busy / wall:.3f} of the wall)")
    print(f"[profile] device seconds by class {json.dumps(classes)}")
    for key, sec in top:
        print(f"[profile]   {sec:.5f} s  {key[:90]}")
    print(f"[profile] host ops {sum(n for _, n, _ in host)} in the window; "
          f"device waits (s, calls): {json.dumps(waits)}")
    for sec, n, key in host[:10]:
        print(f"[profile]   host {sec:.5f} s  {n:6d} calls  {key[:70]}")
    return dict(ticks=ticks + 1, wall_s=wall, device_busy_s=busy,
                busy_share=busy / wall if wall else 0.0, classes=classes,
                top=top, host_top=host[:10], waits=waits)


# ---------------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off for matmuls and cuDNN (f32 is f32)")
    dev = "cuda"

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.paged_attention import (
        fused_paged_decode_grouped, paged_prefill_attention_grouped,
        paged_verify_attention_grouped)
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({_build.last_build})")

    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    try:
        t0 = time.perf_counter()
        results = kernel_phase(dev, flush)
        int8_kernel_phase(dev, flush, results)
        print(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        parity = parity_phase(dev)
        print(f"[parity] phase {time.perf_counter() - t0:.1f} s")
        kernels = {"fused_paged_decode": fused_paged_decode_grouped,
                   "paged_prefill": paged_prefill_attention_grouped,
                   "paged_verify": paged_verify_attention_grouped,
                   "flash_attention": flash_attention_bhsd}
        t0 = time.perf_counter()
        served = serve_phase(dev, kernels)
        print(f"[serve] phase {time.perf_counter() - t0:.1f} s")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    decode = ("src/repro_torch/csrc/fused_paged_decode.cu",
              "src/repro/kernels/paged_attention.py:303")
    prefill = ("src/repro_torch/csrc/paged_prefill.cu",
               "src/repro/kernels/paged_attention.py:134")
    meta = {
        "fused_paged_decode": decode,
        "fused_paged_decode_int8": decode,
        "paged_prefill": prefill,
        "paged_prefill_int8": prefill,
        # no Pallas kernel: the JAX package runs verify as jnp
        "paged_verify": ("src/repro_torch/csrc/paged_prefill.cu",
                         "src/repro/backend/dispatch.py:232"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85"),
    }
    line = []
    for name, (src, tpu) in meta.items():
        r = results[(name, torch.bfloat16)]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu,
                     "launches": served["launches"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernels": {f"{n} {str(dt)[6:]}": r
                               for (n, dt), r in results.items()},
                   "parity": parity, "serve": served,
                   "build": _build.last_build,
                   "seconds": time.perf_counter() - t_start}, f, indent=1,
                  default=str)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
