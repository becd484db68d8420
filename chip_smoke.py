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
     yardstick (timed here only: the port never calls it);
  4. f32 end-to-end parity: yi-6b at full width, 2 layers; the paged
     engine (4 slots, 6 staggered requests, one warm-prefix admission)
     must give each request the same greedy stream as the port's one-shot
     gold (dense prefill through the flash kernel, then dense decode);
  5. the main path at full size: yi-6b, all 32 layers, bf16, random
     weights from ``torch.Generator`` seed 0, served by the paged engine
     (4 slots, max_seq 1024, 8 requests of 100-600 prompt tokens, four
     sharing a 256-token prefix, 64 new tokens each), plus one full-size
     ``Model.forward`` through the flash kernel.  The kernels' launch
     counters are zeroed just before and read just after: each must be
     nonzero, and every logit finite.

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
        out, _, _ = TP.fused_paged_decode_grouped(q, kn, vn, kpk, vpk, bt,
                                                  pos, theta=5e6)
        ref, _, _ = TR.fused_paged_decode_ref(q, kn, vn, kpr, vpr, bt, pos,
                                              theta=5e6)
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


def parity_phase(dev):
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
    for uid, (prompt, max_new, _) in enumerate(sched):
        gold, lgs = gold_decode(model, params, prompt, max_new, max_seq)
        mine = got[uid].out_tokens
        if mine != gold:
            i = next((j for j, (a, b) in enumerate(zip(mine, gold))
                      if a != b), min(len(mine), len(gold)))
            gap = top2_gap(lgs[min(i, len(lgs) - 1)])
            print(f"[parity] uid={uid} first differs at step {i}: engine "
                  f"{mine[i:i + 3]} gold {gold[i:i + 3]}, gold top-2 logit "
                  f"gap {gap:.3g}")
            check(False, f"f32 stream of request {uid} differs from gold")
    print(f"[parity] all {len(sched)} streams equal the one-shot gold")
    del eng, params
    torch.cuda.empty_cache()


def serve_phase(dev, kernels):
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine
    cfg = REGISTRY["yi-6b"]
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    print(f"[serve] yi-6b bf16 full size: {nparam / 1e9:.3f} B params, "
          f"{nparam * 2 / 1e9:.1f} GB, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    v = cfg.vocab_size
    prefix = rng.integers(1, v, 256).astype(np.int32)
    prompts = []
    for i in range(8):
        if i < 4:
            n = int(rng.integers(300, 601))
            p = np.concatenate([prefix, rng.integers(1, v, n - 256)])
        else:
            p = rng.integers(1, v, int(rng.integers(100, 601)))
        prompts.append(p.astype(np.int32))
    max_seq, new = 1024, 64
    eng = ServingEngine(model, params, slots=4, max_seq=max_seq, paged=True,
                        page_size=16)
    finite = []

    def checked_step(params, cache, tokens, cache_index, block_tables=None):
        logits, cache = model.decode_step(params, cache, tokens, cache_index,
                                          block_tables=block_tables)
        finite.append(torch.isfinite(logits).all())
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None], logits, \
            cache

    def checked_prefill(params, cache, tokens, slot, offset, length, bt, wt):
        logits, cache = model.prefill_suffix_paged(
            params, cache, tokens, slot, offset, length, max_seq, bt, wt)
        finite.append(torch.isfinite(logits).all())
        return logits[:, -1].argmax(-1).to(torch.int32), cache

    eng.serve_step = checked_step
    eng._prefill_suffix_paged = checked_prefill
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, new))
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one full-size forward over the prompt of a served request (flash)
    logits, _ = model.forward(params, {"tokens": prompts[0][None]})
    finite.append(torch.isfinite(logits).all())
    same = int(logits[0, -1].argmax()) == done[0].out_tokens[0]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    st = eng.stats()
    ttft = sorted(st["ttft_s"])
    print(f"[serve] {len(done)} requests, {st['gen_tokens']} tokens in "
          f"{wall:.3f} s: {st['gen_tokens'] / wall:.2f} tok/s; TTFT p50 "
          f"{ttft[len(ttft) // 2]:.4f} s, max {ttft[-1]:.4f} s; decode "
          f"steps {st['decode_steps']}; warm admissions "
          f"{st['cache']['prefill_compute_hits']} (reused "
          f"{st['cache']['reused_prefill_tokens']} tokens)")
    print(f"[serve] phase_time_s {json.dumps(st['phase_time_s'])}")
    print(f"[serve] Model.forward last-position argmax equals the served "
          f"first token: {same} (printed, not checked: bf16 near-ties)")
    print(f"[serve] launches on the main path: {json.dumps(launches)}")
    check(len(done) == 8 and all(len(done[u].out_tokens) == new
                                 for u in done),
          "not every request finished its 64 tokens")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    return dict(launches=launches, tok_s=st["gen_tokens"] / wall,
                wall_s=wall, ttft_s=ttft, phase_time_s=st["phase_time_s"],
                decode_steps=st["decode_steps"],
                forward_argmax_matches=same, cache=st["cache"],
                profile=profile_decode(eng, prompts[4:], Request))


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
    classes = {"fused_paged_decode": 0.0, "gemm": 0.0, "copy": 0.0,
               "other": 0.0}
    for key, sec in by_kernel.items():
        low = key.lower()
        if "fused_decode_kernel" in key:
            classes["fused_paged_decode"] += sec
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                    "cutlass")):
            classes["gemm"] += sec
        elif "copy" in low:
            classes["copy"] += sec
        else:
            classes["other"] += sec
    busy = sum(classes.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {ticks + 1} decode ticks, wall {wall:.4f} s, device "
          f"busy {busy:.4f} s ({busy / wall:.3f} of the wall)")
    print(f"[profile] device seconds by class {json.dumps(classes)}")
    for key, sec in top:
        print(f"[profile]   {sec:.5f} s  {key[:90]}")
    return dict(ticks=ticks + 1, wall_s=wall, device_busy_s=busy,
                busy_share=busy / wall if wall else 0.0, classes=classes,
                top=top)


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
        fused_paged_decode_grouped, paged_prefill_attention_grouped)
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({_build.last_build})")

    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    try:
        t0 = time.perf_counter()
        results = kernel_phase(dev, flush)
        print(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        parity_phase(dev)
        print(f"[parity] phase {time.perf_counter() - t0:.1f} s")
        kernels = {"fused_paged_decode": fused_paged_decode_grouped,
                   "paged_prefill": paged_prefill_attention_grouped,
                   "flash_attention": flash_attention_bhsd}
        t0 = time.perf_counter()
        served = serve_phase(dev, kernels)
        print(f"[serve] phase {time.perf_counter() - t0:.1f} s")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "fused_paged_decode": ("src/repro_torch/csrc/fused_paged_decode.cu",
                               "src/repro/kernels/paged_attention.py:303"),
        "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                          "src/repro/kernels/paged_attention.py:134"),
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
                   "serve": served, "build": _build.last_build,
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
