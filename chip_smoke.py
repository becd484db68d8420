#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded     # phase 10 alone (no ok line)
    python3 chip_smoke.py --plan-mesh   # phase 11 alone (no ok line)
    python3 chip_smoke.py --probe-p2p   # gloo's point to point on CUDA

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
     yardstick (timed here only: the port never calls it); the fused
     decode's and flash's rows also give the profiler's device time beside
     SDPA's, and the decode's key splits; bf16 flash must lie within one
     ulp of its plain version and no further from an f64 evaluation than
     1.1 times it (P kept in f32); the paged
     prefill at S=256 (offsets 0 and 256) and S=600 (offset 0, the serve's
     longest prompt); the plan path's new shapes: flash at the dense
     chunked-prefill continuation (Sq=128 and 64 queries at pos_base 128
     against a 1024-row ring whose rows 128..1023 are not yet written,
     plus their own keys; at Sq=64 whole bf16 key splits hold no valid
     key), and the paged prefill at S=48 from offsets 48, 56 (mid-page)
     and 96; then the fused decode's int8 mode (written rows and
     scales bit-equal), the paged prefill over int8 pools at the same
     shapes, and the verify window (B=4, S=5, per-slot offsets 100-1000)
     over fp and int8 pools, whose bf16 launch must split its keys, plus
     a single slot at offset 1000 (16 splits, checked only); each
     attention line prints its bf16 key splits; then jamba's kernels: the
     unfused paged decode (B=4, Hkv=8, G=8, lengths up to 1000) over fp
     and int8 pools, with its key splits and device time beside SDPA's,
     and with an empty slot (the uniform mean of V over its table), a
     one-key slot and one past its table held to the plain version; the
     linear scan at mamba's decode (N=4, S=1, F=262,144, with h0) and at
     N=1, S=512 on its vector path and at an odd F on its scalar path,
     bit-equal, with device times; the fused selective scan (mamba's
     prefill) at N=1, S=600 and N=4, S=100 with h0 (d_inner 16,384,
     d_state 16) within 1e-5 of its plain version, timed beside the
     materialized route it replaces (``was_ms``); then the plans'
     decode replicas at B=2 (a replica decodes its own slots): the fused
     decode over fp and int8 pools (16 bf16 key splits) and the unfused
     decode at Hkv=8 (8 splits), each against its plain version; then
     the new families' GQA groups (nemotron's G=6 and yi-34b's G=7,
     which the split walk pads to 8 rows, qwen2-moe's G=1 at Hkv=16,
     granite-moe's G=2 at D=64): the fused decode at each (B=4,
     positions up to 1000) on fp pools in f32 and bf16 and on int8
     pools, the unfused decode and the paged prefill (S=256) at G=6,
     each timed
     beside its bound, plain version and SDPA; flash and the paged
     prefill at G=1 (qwen2-moe) and flash at G=6, checked; then head_dim
     256 at gemma2-9b's shapes (Hkv=8, G=2, page 16, softcap 50), f32
     and bf16: flash (causal, window 4096, Sq=Skv=4608), the paged
     prefill (S=600 at 0 on fp and int8 pools, S=256 at 4096), the fused
     decode (B=4, positions up to 6000, fp and int8) and the ring-view
     decode of the local layers (the unfused decode over B=4 rings of
     4096 rows), each beside SDPA at the same mask without the softcap;
     then
     the kernel front door, ``repro_torch.kernels.ops``: the fused matmul
     (yi-6b's gate projection at 4 and 512 tokens, a 4096-wide projection
     with each epilogue, f32 and bf16, bf16 to f32) and the one-pass norm
     (rmsnorm at 4 and 512 rows of widths 4096 and 8192, bf16 and f32;
     layernorm with a bias), launched once each through the door with
     the counters zeroed just before (each matmul's path and K splits,
     and each norm's path and launch plan, as the wrappers planned them
     printed), then checked and timed beside
     ``torch.addmm``/``F.rms_norm``/``F.layer_norm``; and the model's
     f32-accumulating bf16 product (``matmul_f32``) against the widened
     product at yi-6b's MLP and head and jamba's mamba x projection;
  4. f32 end-to-end parity: yi-6b at full width, 2 layers; the paged
     engine (4 slots, 6 staggered requests, one warm-prefix admission)
     must give each request the same greedy stream as the port's one-shot
     gold (dense prefill through the flash kernel, then dense decode);
     with a repeated segment in every prompt, so that drafting engages,
     ``speculate=4`` (dense and paged fp) must give the gold's streams,
     and int8 pools the same streams with ``speculate=4`` as without.
     Then the jamba hybrid (jamba-1.5-large-398b-dense-ffn) at full width,
     one period (8 layers), f32: the dense and the paged engine must give
     the gold's streams on a staggered schedule whose warm admission
     shares blocks without compute reuse, a paged prefill + unfused
     decode must give ``Model.forward``'s logits, and int8 pools the fp
     run's first tokens.  Plans: f32 yi-6b (2 layers) through
     ``uniform_plan(2, 2, n_microbatches=2)`` at chunk 16, dense and
     paged, must give the gold's streams, and paged int8 with
     ``speculate=4`` the monolithic int8 engine's; the f32 hybrid (one
     period) through a 1-stage plan with 2 decode replicas at chunk 16,
     paged, the gold's streams.  Overlap: ``overlap=True`` for
     f32 yi-6b, monolithic and through the 2-stage plan, dense and paged,
     on the staggered schedule, and paged on a readmission schedule (5
     requests through 2 slots, one retiring on EOS), and for the f32
     hybrid (paged): every stream must equal the gold's; one traced
     paged plan run must give the untraced run's streams and a Perfetto
     object that validates.  Re-planning (``ServingEngine.replan``):
     f32 yi-6b (2 layers) with swaps mono -> ``uniform_plan(2, 2,
     n_microbatches=1)`` -> ``uniform_plan(2, 2, n_microbatches=4)`` ->
     mono forced mid-traffic at chunk 16, dense, paged and paged
     overlapped: the gold's streams, no row copied on the paged swaps
     and one a migration on the dense ones; a rebalance onto a 2-replica
     plan with both active slots on replica 0 (one block-table handoff,
     the pool's counters unchanged); swaps in the middle of a chunked
     prefill to mono and to a wider plan; ``measure_plan``'s round-trip
     error below 1e-4 for a 1-stage and 2-stage plans at M = 1, 2, 4; and
     on the f32 hybrid the same rebalance, whose migration copies one
     mamba-state row.  The MoE and non-llama dense families, f32 at
     published width: qwen2-moe-a2.7b, nemotron-4-15b and yi-34b at 2
     layers and granite-moe-1b-a400m at its full 24: the staggered
     schedule through the paged engine must give the gold's streams and
     a paged prefill + decode ``Model.forward``'s logits (MoE at a
     drop-free capacity); MoE engines must prefill at the exact length
     with no compute reuse or speculation, and through a 2-stage plan at
     chunk 16 in one chunk a prompt, with the gold's streams; on int8
     pools nemotron and yi-34b must give the fp gold's first tokens, and
     the MoE models whole, finite streams (int8 K/V flips routing).
     gemma2-9b in f32 at published width, 4 layers (two groups), on
     prompts of 4,000-4,600 tokens (the prefills and one decode cross
     position 4,096 and wrap the 4,096-row rings): the dense and the
     paged engine must give the gold's streams, int8 pools whole finite
     streams with f32 rings, a 2-stage plan at chunk 256 one chunk a
     prompt longer than the ring and the gold's streams.
     Each run zeroes the launch counters
     just before and reads them just after: every kernel of its path
     must have launched (the dense run's flash launches are also sorted
     by shape: chunk-0 passes and continuations);
  5. the main path at full size: yi-6b, all 32 layers, bf16, random
     weights from ``torch.Generator`` seed 0, served by the paged engine
     (4 slots, max_seq 1024, 8 requests of 100-600 prompt tokens, four
     sharing a 256-token prefix, 64 new tokens each), plus one full-size
     ``Model.forward`` through the flash kernel; then served again on
     int8 pools with ``speculate=4`` (8 prompts that each repeat a
     32-token segment; 16 of the 32 layers, the first groups of the
     same weights, for the smoke's time); then serve-hybrid: the jamba hybrid at full
     width, 16 layers, bf16, the same engine size and request shape.
     The kernels' launch counters are zeroed just before each serve and
     read just after: each must be nonzero (on serve-hybrid the fused
     selective scan counts admissions, the linear scan decode steps),
     and every logit finite.  serve-plan: serve-full's model (its first
     ``SERVE_PLAN_LAYERS`` layers), requests and engine under the
     launcher's ``--strategy hybrid:2 --replicas 2 --chunk 128`` (the
     searched 2-stage plan, its ``describe()``
     printed; both stages and replicas share the card; its paged
     prefill launches sorted by chunk), its numbers beside
     serve-full's.  serve-overlap and serve-plan-overlap: serve-full and
     serve-plan with ``overlap=True``, their numbers printed beside the
     sync runs' (tok/s, TTFT, prefill phase, host tick, the host_sync
     bucket, the device's busy share) and their bf16 streams held to the
     sync runs' with the same warm-prefix admissions.  A short profiled
     decode window follows each serve; then, on each overlapped engine,
     one ``_dispatch_decode`` under ``torch.cuda.set_sync_debug_mode(
     "error")`` must not sync the host; the host syncs a decode tick of
     every serve are counted (mode "warn", by source line) and printed;
     and serve-overlap traces a short window into
     ``chiprun_out/serve_overlap_trace.json``, which must validate.
     Measured design points: ``measured_design_points`` on serve-full's
     weights for a 1-stage and 2-stage plans at M = 1, 2, 4 (a batch of
     4 x 128 tokens), each beside ``predict_plan(hw=H100)``, and the
     width ``lower(n_microbatches="auto", measure_with=...)`` picks.
     serve-adapt: serve-full's engine with the launcher's adaptive ladder
     (measured profiles, ``warm_replans`` then ``reset_stats``), the 8
     prompts as a burst and then a trickling tail of 8 short requests:
     its profiles, decisions and numbers print beside serve-full's and
     serve-plan's; every request must finish, the controller must score,
     and no swap may copy a row.  serve-moe and serve-nemotron:
     qwen2-moe-a2.7b and nemotron-4-15b at published width, 12 of 24 and
     16 of 32 layers (``SERVE_FAMILY_LAYERS``, for the smoke's time),
     bf16, with serve-full's engine and requests, each
     with its profiled decode window (the MoE expert products' device
     time a tick from the profile's bmm ops) and host syncs a tick; each
     model is freed before the next.  serve-gemma2: gemma2-9b at
     published width, 14 of 42 layers (``SERVE_GEMMA2_LAYERS``), serve-full's
     engine at max_seq 8192, 8 prompts of 1,000-6,000 tokens (four past
     the window, four sharing a 256-token prefix, one crossing 4,096
     while it decodes), 64 new tokens each, with its profiled decode
     window and host syncs a tick.
  6. the encoders (the paper's ViTs and whisper-base): phase 3 adds flash
     at their shapes (``ENCODER_FLASH``: non-causal Sq=Skv=197 at D=64,
     40 and 60, whisper's encoder at Sq=Skv=1500, its cross decode and
     dense self-decode at Sq=1), f32 and bf16, beside SDPA; phase 4
     holds each ViT's f32 logits at published size (12 layers, B=6) to
     the host's plain forward within 1e-4 and whisper-base's f32 greedy
     streams (6 + 6 layers, 1500 frames, 32 tokens) to the host's; phase
     5 runs the bf16 ViTs at B = 1, 3, 6 and 256 (ms a batch, images/s,
     the ``core`` prediction on ``hw.H100`` beside them; device time,
     busy share and kernels a forward at B = 1 and 256) and whisper-base
     at B=4
     (encode, prefill, decode step, tok/s, peak memory), each time beside
     the card's name and power limit.
  7. the last families: phase 3 adds qwen2-vl's flash shapes
     (``VLM_FLASH``: the causal prefill at B=2, H=64, Hkv=8, Sq=Skv=512,
     D=128 and one lock-step decode query over a 1024-row cache, 544 rows
     valid), f32 and bf16, beside SDPA; phase 4 holds xlstm-125m (f32,
     published width, one period: 4 of 12 layers) through
     the dense, ``paged=True`` (running dense),
     ``hybrid:2`` plan (chunks carrying the mLSTM/sLSTM state), overlapped
     and re-planned (one migrated state row) engines to the one-shot
     gold, with no speculation; qwen2-vl-72b (f32, published width, 2
     layers; a 512-position prompt of text, a 16x24 image and text, on
     distinct M-RoPE streams) to the host's plain forward within 1e-4 and
     its 17-token greedy stream to the host's; and jamba's MoE period
     (one period, 2 experts, f32) through the paged engine to the gold.
     Phase 5 serves xlstm-125m at one period (4 of 12 layers) in bf16
     with serve-full's engine and prompts (serve-xlstm: tok/s, TTFT, prefill phase, host and device ms
     and kernels a tick, host syncs, and one 600-token prefill through an
     mLSTM and an sLSTM layer alone), runs qwen2-vl at 32 of 80 layers
     (run-vlm, ~61 GB: prefill and decode-step ms beside the weight-read
     bound, tok/s, peak memory) and serves ``jamba-1.5-large-398b-8e`` at
     one period (serve-jamba-moe, ~51.8 GB: serve-hybrid's engine and
     prompts, the expert products' device share), each freeing its model
     before the next.
  8. training: the gradient routes of the kernels a training forward
     reaches -- flash (``GRAD_FLASH``: train-yi's B=4, H=32, Hkv=4,
     S=512, D=128 causal; gemma2's D=256 with a window and softcap 50;
     deit-t's non-causal D=64) and the selective scan (N=1, S=128,
     d_inner 16,384), each an ``autograd.Function`` of the kernel
     forward and the plain version's backward, against autograd through
     the plain version on the same CUDA tensors (f32 and bf16; forward +
     backward timed beside the plain version's and SDPA's), and
     ``matmul_f32``/``bmm_f32``'s backward against the f32 products;
     model gradients on the card against the host's plain path (yi-6b at
     published width, 2 layers, f32, and a reduced-width jamba period:
     every leaf within 1e-4 of its largest; yi's bf16 gradients at cosine
     >= 0.99 to the f32 ones); train-yi (yi-6b at published width, 8
     layers, bf16, remat, B=4, S=512, ``SyntheticLM`` seed 0, AdamW at
     the CLI's settings, 12 steps: step ms, tokens/s, model TFLOP/s and
     its share of 989, peak memory, the loss curve, flash launches a
     step = 16), the training CLI on the card, and a ``CheckpointManager``
     save and restore of the trained params, bit-equal.
  9. placement: the SSR pipeline executor over a device mesh of two
     slots on the one card (``make_plan_mesh(plan, devices=[cuda:0] *
     2)``).  f32 yi-6b at published width, 4 layers, B=8, S=128: the
     uneven 3 | 1 ``ssr_dse`` plan at M=4, the same at 2 x 2 rounds,
     and ``pipeline_forward(n_stages=2, n_microbatches=4)``, each within
     1e-4 of ``Model.forward`` (relative to its largest |logit|) with 16
     flash launches; bf16 yi-6b at published size (32 layers), B=8,
     S=512, through the search's uneven 2-stage plan at 4 microbatches
     x 2 rounds: 256 flash launches, finite logits, the argmax of every
     position whose top-2 gap exceeds 4 bf16 ulps equal to
     ``Model.forward``'s, no host sync in the runner (sync debug mode
     "error"), ``plan_forward`` and ``Model.forward`` ms beside
     ``measure_plan``'s composed makespan and ``predict_plan(hw=H100)``;
     ``place_params`` passes the params through on one card.
 10. sharded training: two rank processes on the one card over gloo
     (NCCL refuses two ranks on one GPU), each on its shards of a
     ``DeviceMesh``.  First which collectives gloo takes on CUDA tensors
     (those the collectives module sends must be taken).  f32 yi-6b at
     published width, 2 layers, B=4, S=128, on meshes (1, 2) and (2, 1)
     with FSDP and ZeRO-1, against the unsharded ``make_train_step`` on
     the same weights (``torch.Generator`` seed 0): the first batch's
     gradients within 1e-4 of each leaf's largest, then two steps (loss
     within 1e-4, grad_norm within 1e-4 relative, every param within
     1e-4 of its leaf's largest, AdamW at ``SHARD_OPT``); the (1, 2)
     params saved and restored onto (2, 1) and onto no mesh, bit-equal.
     bf16 yi-6b, 4 layers, remat, B=4, S=512 on (1, 2): step ms,
     tokens/s, peak memory a rank, collectives a step and their bytes,
     flash launches a rank and step (phase 8 adds flash's and
     ``matmul_f32``'s rows at a rank's shapes), beside the unsharded step
     on one rank.
 11. the plan runner's data and model axes: one process a rank of a
     ("stage", "data", "model") mesh on the one card over gloo, each
     stage a data x model submesh (phase 3 adds flash at a rank's heads,
     ``PLAN_MESH_FLASH``).  f32 yi-6b at published width, 3 layers, B=8,
     S=128: the uneven 2 | 1 plan of JAX's executor test on (2, 2, 2), 8
     ranks, and its 2 x 2 rounds on (2, 1, 2), 4 ranks, each within 1e-4
     of ``Model.forward``'s largest |logit| and 1e-5 of the one-process
     ``plan_forward``'s; bf16, 8 layers, B=8, S=512, M=4 through the
     search's plan on (2, 1, 2) (its tp set to 2 where its factors gave
     model = 1): finite logits, phase 9's argmax check, flash launches a
     rank = its stage's attention layers x microbatches; the runner's,
     ``plan_forward``'s, ``Model.forward``'s and the one-process
     ``plan_forward``'s ms, the collectives and sends of a call, each
     rank's resident params and peak memory.

It prints a ``{"kernels": [...]}`` JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line.  Measurements are also written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

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


def burst_ms(fn, n=20):
    """(ms a call of ``fn`` over ``n`` calls back to back between one event
    pair, warm: no flush; ms a call the host took to enqueue them).  The
    device sets the first whenever the host enqueues faster than the
    kernels run."""
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    s.record()
    for _ in range(n):
        fn()
    e.record()
    host = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n, host


def device_ms(fn, flush, reps=10, bound=None, tries=3):
    """Device time of one call of ``fn`` (ms): the CUDA kernels that
    ``torch.profiler`` records over ``reps`` calls, L2 flushed before each
    (the flush's own kernels left out), over ``reps``.  Unlike ``bench``,
    it leaves out the host's time between launches, which is all an event
    pair sees when a call's host work outlasts its kernel.

    The profiler can miss kernels (a whisper-encoder reading once came to
    0.0198 ms for a 0.18 ms launch), so a reading is profiled again, up to
    ``tries`` times, when a kernel's record count is not a multiple of
    ``reps``, when it is below ``bound`` (ms), or when it is under half
    the back-to-back time (``burst_ms``) while the host enqueues in under
    half that time, so that the device sets it.  After ``tries``
    rejections the reading is not measured: ``None`` (null in the JSON),
    its reason printed and kept in ``device_ms.unread``; never a number
    the guard rejected.  The profiler, not the kernel, is at fault there:
    the row's comparison with its plain version still decides the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
    fn()
    torch.cuda.synchronize()
    if not device_ms.warm:
        # the process's first profiler session (CUPTI starting) can miss
        # kernels: one throwaway session over the same call
        with profile(activities=[ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()
        device_ms.warm = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush.zero_()
        torch.cuda.synchronize()
    skip = set(kernels(prof))
    burst, host = burst_ms(fn)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        mine = {k: v for k, v in kernels(prof).items() if k not in skip}
        ms = sum(t for t, _ in mine.values()) / reps / 1e3
        counts = sorted(n for _, n in mine.values())
        if not counts or any(n % reps for n in counts):
            why = f"kernel record counts {counts} over {reps} calls"
        elif bound is not None and ms < bound:
            why = f"below its bound {bound:.4f} ms"
        elif host < burst / 2 and ms < burst / 2:
            why = (f"under half the back-to-back time {burst:.4f} ms (host "
                   f"{host:.4f} ms a call)")
        else:
            return ms
        print(f"[device] reading {ms:.4f} ms rejected: {why}; profiling "
              f"again")
    reason = f"{tries} profiles rejected, the last {ms:.4f} ms: {why}"
    print(f"[device] not measured: {reason}")
    device_ms.unread.append(reason)
    return None


device_ms.warm = False
device_ms.unread = []


def fmt_ms(x):
    """A device reading for a line: its ms, or "not measured"."""
    return "not measured" if x is None else f"{x:.4f}"


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


def bf16_ulp(x):
    """The spacing of bf16 values at the magnitude of each element of the
    f32 tensor ``x`` (2^(e - 7) for 2^e <= |x| < 2^(e + 1))."""
    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def flash_p_error(TF, TR, dev, d, seed=11):
    """The bf16 flash kernel's numerics at phase 3's flash shape (B=1,
    H=32, Hkv=4, Sq=Skv=512, causal) and head dim ``d``: its largest
    distance from the plain version in bf16 ulps (at the larger of the
    two magnitudes and 2^-8 of the row's largest; and with no floor, with
    the count of elements beyond one ulp), the plain version's own
    largest distance from the correctly rounded f64 value, and the mean
    absolute error of each against an f64 evaluation of the same function
    on the same bf16 inputs."""
    import math
    gen = torch.Generator(device=dev).manual_seed(seed + d)
    b, h, hk, s = 1, 32, 4, 512
    bf = torch.bfloat16
    q = torch.randn((b, h, s, d), generator=gen, device=dev).to(bf)
    k = torch.randn((b, hk, s, d), generator=gen, device=dev).to(bf)
    v = torch.randn((b, hk, s, d), generator=gen, device=dev).to(bf)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    ones = torch.ones((s,), dtype=torch.int32, device=dev)
    out = TF.flash_attention_bhsd(q, k, v, pos, pos, ones).float()
    plain = TR.flash_attention_ref(q, k, v, pos, pos, ones).float()
    kr = k.double().repeat_interleave(h // hk, 1)
    vr = v.double().repeat_interleave(h // hk, 1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) / math.sqrt(d)
    sc = sc.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1), vr)
    # ulps at each element's magnitude, but at no less than 2^-8 of its
    # row's largest (below that an output is a near-cancelling f32 sum
    # whose rounding exceeds the bf16 ulp); raw: with no floor
    floor = plain.abs().amax(-1, keepdim=True) * 2.0 ** -8
    top = torch.maximum(out.abs(), plain.abs())
    ulps = (out - plain).abs() / bf16_ulp(torch.maximum(top, floor))
    raw = (out - plain).abs() / bf16_ulp(top)
    # the plain version's own distance from the correctly rounded f64
    # value, in ulps with no floor
    rb = ref.to(torch.bfloat16).float()
    own = (plain - rb).abs() / bf16_ulp(torch.maximum(plain.abs(),
                                                      rb.abs()))
    err = float((out.double() - ref).abs().mean())
    plain_err = float((plain.double() - ref).abs().mean())
    return dict(max_ulps=float(ulps.max()), raw_max_ulps=float(raw.max()),
                raw_over_1ulp=int((raw > 1).sum()),
                plain_f64_max_ulps=float(own.max()), mean_err=err,
                plain_mean_err=plain_err, ratio=err / plain_err)


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
        sdpa = functools.partial(F.scaled_dot_product_attention, qs, kg, vg,
                                 attn_mask=mask)
        lib = bench(sdpa, flush)
        keys = int((pos.long() + 1).sum())
        nbytes = (2 * b * h * d + 4 * b * hk * d + 2 * keys * hk * d) * el \
            + 4 * (b + int(((pos.long() + page) // page).sum()))
        bnd, by = bound_ms(nbytes, 4 * keys * hk * g * d, dtype)
        results[("fused_paged_decode", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by,
            device_ms=device_ms(lambda: TP.fused_paged_decode_grouped(
                q, kn, vn, kpk, vpk, bt, pos, theta=5e6), flush),
            library_device_ms=device_ms(sdpa, flush),
            splits=TP.fused_paged_decode_grouped.last_split[0],
            shape=f"B={b} Hkv={hk} G={g} D={d} P={page} NB={nb} pos<=1000")

        # -- paged prefill: S=256 at offset 0 and 256, 1024-token table;
        #    S=600 at offset 0 (the serve's longest prompt) -------------
        b, nb = 1, 64
        n = nb + 1
        bt = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        kp, vp = rnd((n, page, hk, d), dtype), rnd((n, page, hk, d), dtype)
        for name, s, offsets in (("paged_prefill", 256, (0, 256)),
                                 ("paged_prefill_s600", 600, (0,))):
            q = rnd((b, hk, g, s, d), dtype)
            for offset in offsets:
                out = TP.paged_prefill_attention_grouped(q, kp, vp, bt,
                                                         offset)
                ref = TR.paged_prefill_attention_ref(q, kp, vp, bt, offset)
                err = assert_close(f"{name} offset={offset}", out, ref,
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
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bnd, bound_by=by,
                splits=splits_of(dtype, TP.prefill_split(
                    b, hk, g, s, page, nb, offset)),
                shape=f"B=1 Hkv={hk} G={g} S={s} offset={offset} D={d} "
                f"P={page} NB={nb}")

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
        sdpa = functools.partial(F.scaled_dot_product_attention, q, kr, vr,
                                 is_causal=True)
        lib = bench(sdpa, flush)
        pairs = s * (s + 1) // 2
        nbytes = (2 * b * h * s * d + 2 * b * hk * s * d) * el + 12 * s
        bnd, by = bound_ms(nbytes, 4 * pairs * h * d, dtype)
        results[("flash_attention", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by,
            device_ms=device_ms(lambda: TF.flash_attention_bhsd(
                q, k, v, qp, qp, ones), flush),
            library_device_ms=device_ms(sdpa, flush),
            splits=splits_of(dtype, TF.flash_split(b, h, s, s)),
            shape=f"B=1 H={h} Hkv={hk} Sq=Skv={s} causal D={d}")
        if dtype == torch.bfloat16:
            # P stays f32 through P V (as bf16 hi + lo): within one ulp of
            # the plain version, no further from f64 than it
            for dd in (64, 128):
                e = flash_p_error(TF, TR, dev, dd)
                print(f"[kernels] flash numerics bf16 D={dd}: max "
                      f"{e['max_ulps']:.3g} ulps from the plain version "
                      f"({e['raw_max_ulps']:.3g} with no floor, "
                      f"{e['raw_over_1ulp']} elements beyond one; the "
                      f"plain version {e['plain_f64_max_ulps']:.3g} from "
                      f"the rounded f64); "
                      f"mean |err| vs f64 {e['mean_err']:.4g}, plain "
                      f"{e['plain_mean_err']:.4g} (ratio "
                      f"{e['ratio']:.4f})")
                check(e["max_ulps"] <= 1.0 and e["ratio"] <= 1.1,
                      f"bf16 flash at D={dd} strays from the f32-P "
                      f"reference: {e}")
                results[("flash_attention", dtype)][f"numerics_d{dd}"] = e

        # -- flash at the dense chunked-prefill continuation: a chunk of Sq
        #    queries at pos_base 128 attends a 1024-row ring (rows
        #    128..1023 not yet written: negative positions, k_valid 0) and
        #    its own Sq keys.  Sq=128 is the serve's chunk (timed); at
        #    Sq=64 the bf16 launch splits 4 ways and two splits hold no
        #    valid key at all (their partial rows must add nothing) -----
        base, ring = 128, 1024
        ridx = torch.arange(ring, device=dev)
        rpos = (base - 1) - torch.remainder((base - 1) - ridx, ring)
        empties = {}
        for sq in (64, 128):
            skv = ring + sq
            q = rnd((1, h, sq, d), dtype)
            k, v = rnd((1, hk, skv, d), dtype), rnd((1, hk, skv, d), dtype)
            qp = (base + torch.arange(sq, device=dev)).to(torch.int32)
            kp = torch.cat([rpos, base + torch.arange(sq, device=dev)]).to(
                torch.int32)
            kv = torch.cat([rpos >= 0, torch.ones(sq, dtype=torch.bool,
                                                  device=dev)]).to(
                torch.int32)
            out = TF.flash_attention_bhsd(q, k, v, qp, kp, kv)
            ref = TR.flash_attention_ref(q, k, v, qp, kp, kv)
            err = assert_close(f"flash_attention continuation Sq={sq} "
                               f"Skv={skv}", out, ref, dtype)
            check(bool(torch.isfinite(out).all()),
                  f"flash continuation Sq={sq}: non-finite output")
            splits, per = TF.flash_split(1, h, sq, skv)
            empties[sq] = sum(int(kv[z * per:(z + 1) * per].sum()) == 0
                              for z in range(splits))
            print(f"[kernels] flash_attention continuation Sq={sq} "
                  f"{str(dtype)[6:]}: bf16 plan {splits} key splits of "
                  f"{per}, {empties[sq]} without a valid key")
        check(empties[64] > 0, "the Sq=64 continuation must leave a bf16 "
                               "key split without a valid key")
        ms = bench(lambda: TF.flash_attention_bhsd(q, k, v, qp, kp, kv),
                   flush)
        plain = bench(lambda: TR.flash_attention_ref(q, k, v, qp, kp, kv),
                      flush)
        kr = k.repeat_interleave(g, 1).contiguous()
        vr = v.repeat_interleave(g, 1).contiguous()
        mask = (kv.bool()[None, :] & (kp[None, :] <= qp[:, None]))
        sdpa = functools.partial(F.scaled_dot_product_attention, q, kr, vr,
                                 attn_mask=mask)
        lib = bench(sdpa, flush)
        # the function needs only the base + sq valid K/V rows (no query
        # attends an unwritten ring row), and every row's k_pos / k_valid
        pairs = sq * base + sq * (sq + 1) // 2
        nbytes = (2 * h * sq * d + 2 * hk * (base + sq) * d) * el \
            + 4 * (sq + 2 * skv)
        bnd, by = bound_ms(nbytes, 4 * pairs * h * d, dtype)
        results[("flash_attention_cont", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by,
            device_ms=device_ms(lambda: TF.flash_attention_bhsd(
                q, k, v, qp, kp, kv), flush),
            library_device_ms=device_ms(sdpa, flush),
            splits=splits_of(dtype, TF.flash_split(1, h, sq, skv)),
            shape=f"B=1 H={h} Hkv={hk} Sq={sq} Skv={skv} pos_base={base} "
            f"ring rows {base}..{ring - 1} invalid D={d}")

        # -- paged prefill at the plan serve's mid-table chunks: S=48 at
        #    offsets 48 and 96 and at 56 (a chunk starting mid-page) ------
        b, nb, s = 1, 64, 48
        bt = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        kp, vp = rnd((nb + 1, page, hk, d), dtype), \
            rnd((nb + 1, page, hk, d), dtype)
        q = rnd((b, hk, g, s, d), dtype)
        for offset in (48, 56, 96):
            out = TP.paged_prefill_attention_grouped(q, kp, vp, bt, offset)
            ref = TR.paged_prefill_attention_ref(q, kp, vp, bt, offset)
            e = assert_close(f"paged_prefill S={s} offset={offset}", out,
                             ref, dtype)
            if offset == 96:
                err = e
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
        sdpa = functools.partial(F.scaled_dot_product_attention, qs, kg, vg,
                                 attn_mask=mask)
        lib = bench(sdpa, flush)
        t = offset + s
        pairs = s * offset + s * (s + 1) // 2
        nbytes = (2 * hk * g * s * d + 2 * t * hk * d) * el \
            + 4 * (-(-t // page))
        bnd, by = bound_ms(nbytes, 4 * pairs * hk * g * d, dtype)
        results[("paged_prefill_s48", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            bound_ms=bnd, bound_by=by,
            device_ms=device_ms(lambda: TP.paged_prefill_attention_grouped(
                q, kp, vp, bt, offset), flush),
            library_device_ms=device_ms(sdpa, flush),
            splits=splits_of(dtype, TP.prefill_split(
                b, hk, g, s, page, nb, offset)),
            shape=f"B=1 Hkv={hk} G={g} S={s} offset={offset} (also 48, "
            f"56) D={d} P={page} NB={nb}")
        print_rows(results, dtype, ("fused_paged_decode", "paged_prefill",
                                    "paged_prefill_s600", "flash_attention",
                                    "flash_attention_cont",
                                    "paged_prefill_s48"))
    return results


def splits_of(dtype, plan):
    """Key splits of a launch: the bf16 engine's plan at 132 SMs (the
    wrappers ask the card; an H100 SXM has 132), one in f32."""
    return plan[0] if dtype == torch.bfloat16 else 1


def print_rows(results, dtype, names):
    for name in names:
        r = results[(name, dtype)]
        dev = ""
        if "device_ms" in r:
            dev = (f" [device {fmt_ms(r['device_ms'])} ms, sdpa device "
                   f"{fmt_ms(r['library_device_ms'])} ms]")
        print(f"[kernels] {name} {str(dtype)[6:]} ({r['shape']}): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"{r.get('library', 'sdpa')} {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), splits "
              f"{r.get('splits', 1)}{dev}")


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
        sdpa = functools.partial(F.scaled_dot_product_attention, qs, kg, vg,
                                 attn_mask=mask)
        lib = bench(sdpa, flush)
        keys = int((pos.long() + 1).sum())
        nbytes = window_bytes(keys, b, el, d + 4,
                              int(((pos.long() + page) // page).sum())) \
            + 2 * b * hk * d * el
        bnd, by = bound_ms(nbytes, 4 * keys * hk * g * d, dtype)
        results[("fused_paged_decode_int8", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
            bound_ms=bnd, bound_by=by,
            device_ms=device_ms(lambda: TP.fused_paged_decode_grouped(
                q, kn, vn, mine[0], mine[1], bt, pos, theta=5e6,
                k_scales=mine[2], v_scales=mine[3]), flush),
            library_device_ms=device_ms(sdpa, flush),
            splits=TP.fused_paged_decode_grouped.last_split[0],
            shape=f"B={b} Hkv={hk} G={g} D={d} P={page} NB={nb} pos<=1000 "
            f"int8 pools")

        # -- int8 paged prefill: S=256 at offset 0 and 256; S=600 at 0 ----
        b, nb = 1, 64
        n = nb + 1
        bt = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        kp, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        vp, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        sc = dict(k_scales=ks, v_scales=vs)
        kg, vg = gathered(kp, vp, ks, vs, bt, dtype)
        for name, s, offsets in (("paged_prefill_int8", 256, (0, 256)),
                                 ("paged_prefill_int8_s600", 600, (0,))):
            q = rnd((b, hk, g, s, d), dtype)
            for offset in offsets:
                out = TP.paged_prefill_attention_grouped(q, kp, vp, bt,
                                                         offset, **sc)
                ref = TR.paged_prefill_attention_ref(q, kp, vp, bt, offset,
                                                     **sc)
                err = assert_close(f"{name} offset={offset}", out, ref,
                                   dtype)
            ms = bench(lambda: TP.paged_prefill_attention_grouped(
                q, kp, vp, bt, offset, **sc), flush)
            pl = bench(lambda: TR.paged_prefill_attention_ref(
                q, kp, vp, bt, offset, **sc), flush)
            mask = (torch.arange(nb * page, device=dev)[None, :]
                    <= offset + torch.arange(s, device=dev)[:, None])
            qs = q.reshape(b, h, s, d)
            lib = bench(lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask), flush)
            t = offset + s
            pairs = s * offset + s * (s + 1) // 2
            nbytes = window_bytes(t, s, el, d + 4, -(-t // page))
            bnd, by = bound_ms(nbytes, 4 * pairs * hk * g * d, dtype)
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
                bound_ms=bnd, bound_by=by,
                splits=splits_of(dtype, TP.prefill_split(
                    b, hk, g, s, page, nb, offset)),
                shape=f"B=1 Hkv={hk} G={g} S={s} offset={offset} D={d} "
                f"P={page} NB={nb} int8 pools")

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
        splits = splits_of(dtype, TP.prefill_split(b, hk, g, s, page, nb))
        check(dtype != torch.bfloat16 or splits > 1,
              "the bf16 verify window must split its keys")
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
                bound_ms=bnd, bound_by=by, splits=splits,
                shape=f"B={b} Hkv={hk} G={g} S={s} offsets 100-1000 D={d} "
                f"P={page} NB={nb} {pool} pools")
        # one live slot at offset 1000: the bf16 launch takes 16 splits of
        # one tile, most of them past the slot's window (checked only)
        one = torch.tensor([1000], dtype=torch.int32, device=dev)
        for pools, sc in (((kp, vp), dict(k_scales=ks, v_scales=vs)),
                          ((TR.dequantize_int8(kp, ks).to(dtype),
                            TR.dequantize_int8(vp, vs).to(dtype)), {})):
            out = TP.paged_verify_attention_grouped(q[:1], *pools, bt[:1],
                                                    one, **sc)
            ref = TR.paged_verify_attention_ref(q[:1], *pools, bt[:1], one,
                                                **sc)
            assert_close(f"paged_verify B=1 offset=1000 "
                         f"{'int8' if sc else 'fp'} pools, splits "
                         f"{splits_of(dtype, TP.prefill_split(1, hk, g, s, page, nb))}",
                         out, ref, dtype)
        print_rows(results, dtype, ("fused_paged_decode_int8",
                                    "paged_prefill_int8",
                                    "paged_prefill_int8_s600",
                                    "paged_verify", "paged_verify_fp"))
    return results


def hybrid_kernel_phase(dev, flush, results):
    """Phase 3, the jamba hybrid's kernels: the unfused paged decode
    (jamba's rope-free attention: B=4, Hkv=8, G=8, D=128, page 16,
    64-entry tables, lengths up to 1000; its key splits printed) on fp
    and int8 pools in f32 and bf16, then the same with an empty slot
    (length 0: the uniform mean of V over its table, as the Pallas kernel
    and both references give), a one-key slot and one past the table,
    held to the plain version and the empty slot also to that mean; the
    linear scan (f32 only) at mamba's decode shape (N=4, S=1,
    F=d_inner*d_state=262,144, with h0) and at N=1, S=512 (no h0) on its
    vector path, and at an odd F (262,143) on its scalar path, whose
    states must equal the plain version's bit for bit; and the fused
    selective scan (mamba's prefill) at serve-hybrid's longest admission
    (N=1, S=600, d_inner 16,384, d_state 16, no h0) and a batched one with
    h0 (N=4, S=100), whose y and h_last must lie within 1e-5 of the plain
    version's, timed beside the materialized route it replaces on the
    same tensors (``was_ms``: exp, the products, the linear scan kernel
    and the C contraction).  SDPA over the gathered (dequantized) K/V is
    the attention's library yardstick; ``torch.addcmul(b, a, h0)``
    computes the scan at S = 1; no single PyTorch call computes either
    scan over S > 1.  Each row gives the profiler's device time beside
    its yardstick's."""
    from repro_torch.kernels import linear_scan as TS
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels import selective_scan as SS
    F = torch.nn.functional
    hk, g, d, page, b, nb = 8, 8, 128, 16, 4, 64
    h = hk * g
    n = b * nb + 1
    gen = torch.Generator(device=dev).manual_seed(4)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    lengths = torch.tensor([1000, 17, 512, 256], dtype=torch.int32,
                           device=dev)
    bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
        b, nb).to(torch.int32)
    kq, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
    vq, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
    keys = int(lengths.long().sum())
    tables = int(((lengths.long() + page - 1) // page).sum())
    mask = (torch.arange(nb * page, device=dev)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        q = rnd((b, hk, g, d), dtype)
        for pool in ("fp", "int8"):
            if pool == "int8":
                pools, sc, row_bytes = (kq, vq), dict(k_scales=ks,
                                                      v_scales=vs), d + 4
            else:
                pools = (TR.dequantize_int8(kq, ks).to(dtype),
                         TR.dequantize_int8(vq, vs).to(dtype))
                sc, row_bytes = {}, d * el
            out = TP.paged_attention_grouped(q, *pools, bt, lengths, **sc)
            ref = TR.paged_attention_ref(q, *pools, bt, lengths, **sc)
            torch.cuda.synchronize()
            err = assert_close(f"paged_attention {pool} pools", out, ref,
                               dtype)
            ms = bench(lambda: TP.paged_attention_grouped(
                q, *pools, bt, lengths, **sc), flush)
            pl = bench(lambda: TR.paged_attention_ref(
                q, *pools, bt, lengths, **sc), flush)
            kg = (TR.dequantize_int8(kq, ks) if sc else pools[0].float())
            vg = (TR.dequantize_int8(vq, vs) if sc else pools[1].float())
            kg = kg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
            vg = vg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
            kg = kg.repeat_interleave(g, 1).to(dtype).contiguous()
            vg = vg.repeat_interleave(g, 1).to(dtype).contiguous()
            qs = q.reshape(b, h, 1, d)
            sdpa = functools.partial(F.scaled_dot_product_attention, qs,
                                     kg, vg, attn_mask=mask)
            lib = bench(sdpa, flush)
            dev_ms = device_ms(lambda: TP.paged_attention_grouped(
                q, *pools, bt, lengths, **sc), flush)
            lib_dev = device_ms(sdpa, flush)
            nbytes = 2 * b * h * d * el + 2 * keys * hk * row_bytes \
                + 4 * (tables + b)
            bnd, by = bound_ms(nbytes, 4 * keys * hk * g * d, dtype)
            name = "paged_attention" if pool == "fp" else \
                "paged_attention_int8"
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
                bound_ms=bnd, bound_by=by, device_ms=dev_ms,
                library_device_ms=lib_dev,
                splits=TP.paged_attention_grouped.last_split[0],
                split_keys=TP.paged_attention_grouped.last_split[1],
                shape=f"B={b} Hkv={hk} G={g} "
                f"D={d} P={page} NB={nb} lengths<=1000 {pool} pools")

            # an empty slot, one key, and a slot past its table
            edge = torch.tensor([0, 1, nb * page + 76, 512],
                                dtype=torch.int32, device=dev)
            out = TP.paged_attention_grouped(q, *pools, bt, edge, **sc)
            ref = TR.paged_attention_ref(q, *pools, bt, edge, **sc)
            torch.cuda.synchronize()
            results[(name, dtype)]["edge_max_abs_err"] = assert_close(
                f"paged_attention {pool} pools, lengths 0, 1 and past the "
                f"table", out, ref, dtype)
            vt = TR.dequantize_int8(vq, vs) if sc else pools[1].float()
            mean = vt[bt[0].long()].reshape(nb * page, hk, d).mean(0)
            assert_close(f"paged_attention {pool} pools, the empty slot "
                         f"against the mean of V over its table", out[0],
                         mean[:, None].expand(hk, g, d), dtype)

    for name, (n_, s_, f, with_h0, path) in (
            ("linear_scan", (4, 1, 262_144, True, "vector")),
            ("linear_scan_prefill", (1, 512, 262_144, False, "vector")),
            ("linear_scan_odd_f", (4, 1, 262_143, True, "scalar"))):
        a = torch.rand((n_, s_, f), generator=gen, device=dev) * 0.5 + 0.5
        bb = rnd((n_, s_, f))
        h0 = rnd((n_, f)) if with_h0 else None
        out = TS.linear_scan(a, bb, h0)
        ref = TR.linear_scan_ref(a, bb, h0)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        err = max_err(out, ref)
        took = TS.linear_scan.last_plan
        print(f"[kernels] {name} float32 N={n_} S={s_} F={f}: {took[0]} "
              f"path ({took[1]} threads, {took[2]} blocks a row); states "
              f"bit-equal to the plain version: {same} (max_abs_err {err})")
        check(same, f"{name}: the kernel's states differ from the plain "
                    f"version's")
        check(took[0] == path, f"{name}: took the {took[0]} path, not the "
                               f"{path} one")
        ms = bench(lambda: TS.linear_scan(a, bb, h0), flush)
        pl = bench(lambda: TR.linear_scan_ref(a, bb, h0), flush)
        dev_ms = device_ms(lambda: TS.linear_scan(a, bb, h0), flush)
        lib = lib_dev = None
        if s_ == 1:
            yard = functools.partial(torch.addcmul, bb, a, h0[:, None])
            lib = bench(yard, flush)
            lib_dev = device_ms(yard, flush)
        nbytes = 12 * n_ * s_ * f + (4 * n_ * f if with_h0 else 0)
        bnd, by = bound_ms(nbytes, 2 * n_ * s_ * f, torch.float32)
        results[(name, torch.float32)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
            bound_ms=bnd, bound_by=by, device_ms=dev_ms,
            library_device_ms=lib_dev, path=took[0],
            shape=f"N={n_} S={s_} F={f} {'with' if with_h0 else 'no'} h0")

    di, ds = 16_384, 16                 # jamba's d_inner and d_state
    a_mat = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).repeat(di, 1)
    for name, (n_, s_, with_h0) in (("mamba_scan_fused", (1, 600, False)),
                                    ("mamba_scan_fused_b4", (4, 100, True))):
        # delta as softplus(dt + dt_bias) gives it at jamba's init
        delta = F.softplus(rnd((n_, s_, di)) * 0.1 - 4.6)
        xs, bm, cm = rnd((n_, s_, di)), rnd((n_, s_, ds)), rnd((n_, s_, ds))
        h0 = rnd((n_, di, ds)) if with_h0 else None
        args = (delta, xs, bm, cm, a_mat, h0)
        y, hl = SS.mamba_scan_fused(*args)
        ry, rh = TR.mamba_scan_fused_ref(*args)
        torch.cuda.synchronize()
        err = max(max_err(y, ry), max_err(hl, rh))
        ok = all(torch.allclose(u, v, atol=1e-5, rtol=1e-5)
                 for u, v in ((y, ry), (hl, rh)))
        took = SS.mamba_scan_fused.last_plan
        print(f"[kernels] {name} float32 N={n_} S={s_} d_inner={di} "
              f"d_state={ds}: plan {took}; y and h_last max_abs_err="
              f"{err:.3g} (atol=rtol=1e-05) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name}: the kernel disagrees with its plain version")

        def was(delta=delta, xs=xs, bm=bm, cm=cm, h0=h0, n_=n_, s_=s_):
            """The route it replaces: (N, S, d_inner, d_state) tensors."""
            a = torch.exp(delta[..., None] * a_mat)
            b_ = (delta * xs)[..., None] * bm[:, :, None, :]
            h_all = TS.linear_scan(
                a.reshape(n_, s_, -1), b_.reshape(n_, s_, -1),
                None if h0 is None else h0.reshape(n_, -1))
            h_all = h_all.reshape(n_, s_, di, ds)
            return torch.matmul(h_all, cm[..., None])[..., 0], h_all[:, -1]
        wy, wh = was()
        torch.cuda.synchronize()
        check(all(torch.allclose(u, v, atol=1e-5, rtol=1e-5)
                  for u, v in ((wy, ry), (wh, rh))),
              f"{name}: the materialized route disagrees with the plain "
              f"version")
        del wy, wh
        ms = bench(lambda: SS.mamba_scan_fused(*args), flush)
        pl = bench(lambda: TR.mamba_scan_fused_ref(*args), flush, iters=5,
                   warmup=1)
        was_ms = bench(was, flush)
        dev_ms = device_ms(lambda: SS.mamba_scan_fused(*args), flush)
        was_dev = device_ms(was, flush)
        torch.cuda.empty_cache()
        nbytes = 4 * (3 * n_ * s_ * di + 2 * n_ * s_ * ds + di * ds
                      + (2 if with_h0 else 1) * n_ * di * ds)
        # 7 ops a state and step (delta*A, exp, (delta*x)*B, a*h, +, the
        # C product and sum) and delta*x a channel and step
        bnd, by = bound_ms(nbytes, n_ * s_ * di * (7 * ds + 1),
                           torch.float32)
        results[(name, torch.float32)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pl, library_ms=None,
            bound_ms=bnd, bound_by=by, device_ms=dev_ms,
            library_device_ms=None, was_ms=was_ms, was_device_ms=was_dev,
            plan=took, shape=f"N={n_} S={s_} d_inner={di} d_state={ds} "
            f"{'with' if with_h0 else 'no'} h0")
    for key in (("paged_attention", torch.float32),
                ("paged_attention", torch.bfloat16),
                ("paged_attention_int8", torch.float32),
                ("paged_attention_int8", torch.bfloat16),
                ("linear_scan", torch.float32),
                ("linear_scan_prefill", torch.float32),
                ("linear_scan_odd_f", torch.float32),
                ("mamba_scan_fused", torch.float32),
                ("mamba_scan_fused_b4", torch.float32)):
        r = results[key]
        lib = ("no single call" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (device "
                    f"{fmt_ms(r['library_device_ms'])})")
        plan = f", splits {r['splits']} of {r['split_keys']} keys" \
            if "splits" in r else ""
        plan += f", {r['path']} path" if "path" in r else ""
        was = (f", was {r['was_ms']:.4f} ms (device "
               f"{fmt_ms(r['was_device_ms'])})" if "was_ms" in r else "")
        print(f"[kernels] {key[0]} {str(key[1])[6:]} ({r['shape']}{plan}): "
              f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}{was}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def replica_kernel_phase(dev, flush, results):
    """Phase 3, the plans' decode replicas: a replica decodes only its own
    slots, so the plan path's decodes run at B=2 (serve-plan's 2 replicas
    of 2 slots: the fused decode, fp pools; the parity phase's int8 plan;
    the hybrid plan's unfused decode), where the bf16 launch splits its
    1024 keys 16 ways (fused, Hkv=4) or 8 ways (unfused, Hkv=8) against 4
    at B=8 and B=4.  The fused decode over fp and int8 pools at positions
    1000 and 300 (its written rows held to the plain version's, int8 rows
    and scales bit-equal), the unfused decode over fp pools at lengths
    1000 and 17, page 16, 64-entry tables, f32 and bf16; each timed beside
    SDPA on the gathered (dequantized) K/V."""
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    b, d, page, nb, g = 2, 128, 16, 64, 8
    n = b * nb + 1
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    names = ("fused_paged_decode_b2", "fused_paged_decode_int8_b2",
             "paged_attention_b2")
    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        for name in names:
            fused, int8 = name.startswith("fused"), "int8" in name
            hk = 4 if fused else 8
            h = hk * g
            pos = torch.tensor([1000, 300] if fused else [1000, 17],
                               dtype=torch.int32, device=dev)
            # keys attended: 0..pos (fused, the fresh key included) or
            # 0..length-1 (unfused)
            lens = pos.long() + (1 if fused else 0)
            bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
                b, nb).to(torch.int32)
            if int8:
                kp, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
                vp, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
                pools, row_bytes = [kp, vp, ks, vs], d + 4
                kg, vg = TR.dequantize_int8(kp, ks), TR.dequantize_int8(vp,
                                                                         vs)
            else:
                pools = [rnd((n, page, hk, d), dtype),
                         rnd((n, page, hk, d), dtype)]
                row_bytes = d * el
                kg, vg = pools[0].float(), pools[1].float()
            q = rnd((b, hk, g, d), dtype)
            fresh = (rnd((b, hk, d), dtype), rnd((b, hk, d), dtype))
            kernel = TP.fused_paged_decode_grouped if fused else \
                TP.paged_attention_grouped
            plain_fn = TR.fused_paged_decode_ref if fused else \
                TR.paged_attention_ref

            def call(fn, p, q=q, fresh=fresh, bt=bt, pos=pos, fused=fused):
                sc = dict(k_scales=p[2], v_scales=p[3]) if len(p) == 4 \
                    else {}
                if fused:
                    return fn(q, *fresh, p[0], p[1], bt, pos, theta=5e6,
                              **sc)[0]
                return fn(q, p[0], p[1], bt, pos, **sc)
            mine = [t.clone() for t in pools]
            theirs = [t.clone() for t in pools]
            out = call(kernel, mine)
            ref = call(plain_fn, theirs)
            torch.cuda.synchronize()
            splits = kernel.last_split
            err = assert_close(f"{name} (B={b}: {splits[0]} key splits of "
                               f"{splits[1]})", out, ref, dtype)
            for what, a, r in zip(("k_pages", "v_pages", "k_scales",
                                   "v_scales"), mine, theirs):
                if not fused:
                    break
                if int8:
                    same = torch.equal(a, r)
                    print(f"[kernels] {name} {str(dtype)[6:]} written {what} "
                          f"bit-equal: {same}")
                    check(same, f"{name} {what} differ from the plain "
                                f"version's ({dtype})")
                else:
                    err = max(err, assert_close(f"{name} {what}", a, r,
                                                dtype))
            ms = bench(lambda: call(kernel, mine), flush)
            pl = bench(lambda: call(plain_fn, theirs), flush)
            kg = kg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
            vg = vg[bt.long()].reshape(b, nb * page, hk, d).transpose(1, 2)
            kg = kg.repeat_interleave(g, 1).to(dtype).contiguous()
            vg = vg.repeat_interleave(g, 1).to(dtype).contiguous()
            mask = (torch.arange(nb * page, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            sdpa = functools.partial(F.scaled_dot_product_attention,
                                     q.reshape(b, h, 1, d), kg, vg,
                                     attn_mask=mask)
            lib = bench(sdpa, flush)
            # q in and out, the fresh k/v in (fused), every attended key
            # row once (the fused decode writes its fresh row and reads
            # the rest), the table entries walked and the positions
            keys = int(lens.sum())
            tables = int(((lens + page - 1) // page).sum())
            nbytes = (2 * b * h * d + (2 * b * hk * d if fused else 0)) \
                * el + 2 * keys * hk * row_bytes + 4 * (tables + b)
            bnd, by = bound_ms(nbytes, 4 * keys * hk * g * d, dtype)
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=pl, library_ms=lib,
                bound_ms=bnd, bound_by=by,
                device_ms=device_ms(lambda: call(kernel, mine), flush),
                library_device_ms=device_ms(sdpa, flush),
                splits=splits[0], split_keys=splits[1],
                shape=f"B={b} Hkv={hk} G={g} D={d} P={page} NB={nb} "
                f"{'pos' if fused else 'lengths'} {pos.tolist()} "
                f"{'int8' if int8 else 'fp'} pools")
        print_rows(results, dtype, names)
    return results


# the fused decode's layouts held to the plain version beside the split
# walk's padded G: (row suffix, Hkv, D, groups)
GROUP_LAYOUTS = (("", 8, 128, (6, 7)),      # nemotron-4-15b, yi-34b
                 ("", 16, 128, (1,)),       # qwen2-moe-a2.7b
                 ("_d64", 8, 64, (2,)))     # granite-moe-1b-a400m


def group_kernel_phase(dev, flush, results):
    """Phase 3, the new families' GQA groups: nemotron's 48/8 = 6 query
    heads per kv head and yi-34b's 56/8 = 7, which the split walk pads to
    8 rows, qwen2-moe's 16/16 = 1 and granite-moe's 16/8 = 2 at head_dim
    64.  The fused decode at each (B=4, page 16, 64-entry tables,
    positions up to 1000; Hkv=8, D=128 at G = 6 and 7, Hkv=16, D=128 at
    G=1, Hkv=8, D=64 at G=2) on fp pools in f32 and bf16 and on int8
    pools (written rows held to the plain version's, int8 rows and scales
    bit-equal); the unfused decode at G = 6 (lengths up to 1000) on fp
    pools; the paged prefill at G = 6, S = 256 (offsets 0 and 256,
    1024-key table); each timed beside its bound, its plain version and
    SDPA on the K/V gathered (and dequantized) beforehand.  Then, checked
    only: flash (S = 256, causal) and the paged prefill at G = 1
    (qwen2-moe's 16 heads on 16 kv heads) and flash at G = 6."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    page, b, nb = 16, 4, 64
    n = b * nb + 1
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    pos = torch.tensor([999, 17, 512, 1000], dtype=torch.int32, device=dev)
    bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
        b, nb).to(torch.int32)
    pools_of = {}
    for _, hk, d, _ in GROUP_LAYOUTS:
        if (hk, d) not in pools_of:
            kq, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
            vq, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
            pools_of[hk, d] = (kq, ks, vq, vs, TR.dequantize_int8(kq, ks),
                               TR.dequantize_int8(vq, vs))
    keys = int((pos.long() + 1).sum())
    tables = int(((pos.long() + page) // page).sum())
    mask = (torch.arange(nb * page, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]

    def sdpa_on(q, table, kpool, vpool, g, dtype, qmask):
        """SDPA over the K/V rows of ``table``, gathered in logical
        order."""
        bb, nbb = table.shape
        hk, d = kpool.shape[2:]
        kg = kpool[table.long()].reshape(bb, nbb * page, hk, d).transpose(
            1, 2)
        vg = vpool[table.long()].reshape(bb, nbb * page, hk, d).transpose(
            1, 2)
        kg = kg.repeat_interleave(g, 1).to(dtype).contiguous()
        vg = vg.repeat_interleave(g, 1).to(dtype).contiguous()
        return functools.partial(F.scaled_dot_product_attention, q, kg, vg,
                                 attn_mask=qmask)

    def row(name, dtype, launch, plain, sdpa, err, nbytes, ops, split,
            shape):
        bnd, by = bound_ms(nbytes, ops, dtype)
        results[(name, dtype)] = dict(
            max_abs_err=err, ms=bench(launch, flush),
            plain_ms=bench(plain, flush), library_ms=bench(sdpa, flush),
            bound_ms=bnd, bound_by=by, device_ms=device_ms(launch, flush),
            library_device_ms=device_ms(sdpa, flush), splits=split,
            shape=shape)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        names = []
        for suffix, hk, d, groups in GROUP_LAYOUTS:
            kq, ks, vq, vs, kf, vf = pools_of[hk, d]
            for g in groups:
                h = hk * g
                q, kn, vn = rnd((b, hk, g, d), dtype), \
                    rnd((b, hk, d), dtype), rnd((b, hk, d), dtype)
                for pool in ("fp", "int8"):
                    if pool == "int8":
                        pools, row_bytes = [kq, vq, ks, vs], d + 4
                    else:
                        pools, row_bytes = [kf.to(dtype), vf.to(dtype), None,
                                            None], d * el
                    mine = [None if t is None else t.clone() for t in pools]
                    ref_pools = [None if t is None else t.clone()
                                 for t in pools]
                    name = ("fused_paged_decode" + ("_int8" if pool == "int8"
                                                    else "")
                            + f"_g{g}{suffix}")

                    def launch(p=mine, q=q, kn=kn, vn=vn):
                        return TP.fused_paged_decode_grouped(
                            q, kn, vn, p[0], p[1], bt, pos, theta=1e4,
                            k_scales=p[2], v_scales=p[3])

                    def plain(p=ref_pools, q=q, kn=kn, vn=vn):
                        return TR.fused_paged_decode_ref(
                            q, kn, vn, p[0], p[1], bt, pos, theta=1e4,
                            k_scales=p[2], v_scales=p[3])
                    out, ref = launch()[0], plain()[0]
                    torch.cuda.synchronize()
                    err = assert_close(f"{name} out", out, ref, dtype)
                    for what, a, r in zip(("k_pages", "v_pages", "k_scales",
                                           "v_scales"), mine, ref_pools):
                        if a is None:
                            continue
                        if pool == "int8":
                            same = torch.equal(a, r)
                            print(f"[kernels] {name} {str(dtype)[6:]} "
                                  f"written {what} bit-equal: {same}")
                            check(same, f"{name} {what} differ from the "
                                        f"plain version's ({dtype})")
                        else:
                            assert_close(f"{name} {what}", a, r, dtype)
                    split = TP.fused_paged_decode_grouped.last_split[0]
                    # q read and out written, the fresh K/V rows read (in
                    # the activation dtype) and written (in the pool's),
                    # the cached rows read once, the tables and positions
                    nbytes = 2 * b * h * d * el + 2 * b * hk * d * el \
                        + 2 * b * hk * row_bytes \
                        + 2 * keys * hk * row_bytes + 4 * (b + tables)
                    row(name, dtype, launch, plain,
                        sdpa_on(q.reshape(b, h, 1, d), bt, kf, vf, g, dtype,
                                mask), err, nbytes, 4 * keys * hk * g * d,
                        split, f"B={b} Hkv={hk} G={g} D={d} P={page} "
                        f"NB={nb} pos<=1000 {pool} pools")
                    names.append(name)
        kf, vf = pools_of[8, 128][4:]
        hk, d = 8, 128

        # -- the unfused decode at G=6, fp pools, lengths pos + 1 --------
        g, h = 6, 6 * hk
        q = rnd((b, hk, g, d), dtype)
        kp_, vp_ = kf.to(dtype), vf.to(dtype)
        lengths = pos + 1
        out = TP.paged_attention_grouped(q, kp_, vp_, bt, lengths)
        ref = TR.paged_attention_ref(q, kp_, vp_, bt, lengths)
        torch.cuda.synchronize()
        err = assert_close("paged_attention_g6", out, ref, dtype)
        row("paged_attention_g6", dtype,
            lambda: TP.paged_attention_grouped(q, kp_, vp_, bt, lengths),
            lambda: TR.paged_attention_ref(q, kp_, vp_, bt, lengths),
            sdpa_on(q.reshape(b, h, 1, d), bt, kf, vf, g, dtype, mask), err,
            2 * b * h * d * el + 2 * keys * hk * d * el + 4 * (b + tables),
            4 * keys * hk * g * d,
            TP.paged_attention_grouped.last_split[0],
            f"B={b} Hkv={hk} G={g} D={d} P={page} NB={nb} lengths<=1001 "
            f"fp pools")

        # -- the paged prefill at G=6, S=256 at offsets 0 and 256 ---------
        s, tb = 256, bt[:1]
        q = rnd((1, hk, g, s, d), dtype)
        for offset in (0, 256):
            out = TP.paged_prefill_attention_grouped(q, kp_, vp_, tb, offset)
            ref = TR.paged_prefill_attention_ref(q, kp_, vp_, tb, offset)
            err = assert_close(f"paged_prefill_g6 offset={offset}", out, ref,
                               dtype)
        qmask = (torch.arange(nb * page, device=dev)[None, :]
                 <= offset + torch.arange(s, device=dev)[:, None])
        t = offset + s
        row("paged_prefill_g6", dtype,
            lambda: TP.paged_prefill_attention_grouped(q, kp_, vp_, tb,
                                                       offset),
            lambda: TR.paged_prefill_attention_ref(q, kp_, vp_, tb, offset),
            sdpa_on(q.reshape(1, h, s, d), tb, kf, vf, g, dtype, qmask), err,
            (2 * h * s * d + 2 * t * hk * d) * el + 4 * (-(-t // page)),
            4 * (s * offset + s * (s + 1) // 2) * h * d,
            splits_of(dtype, TP.prefill_split(1, hk, g, s, page, nb,
                                              offset)),
            f"B=1 Hkv={hk} G={g} S={s} offset={offset} (also 0) D={d} "
            f"P={page} NB={nb}")
        print_rows(results, dtype, names + ["paged_attention_g6",
                                            "paged_prefill_g6"])

        # -- checked only: flash at G=1 and 6, the paged prefill at G=1 ---
        qp = torch.arange(s, dtype=torch.int32, device=dev)
        ones = torch.ones((s,), dtype=torch.int32, device=dev)
        for heads, kvh in ((16, 16), (48, 8)):
            q, k, v = (rnd((1, heads, s, d), dtype),
                       rnd((1, kvh, s, d), dtype), rnd((1, kvh, s, d), dtype))
            out = TF.flash_attention_bhsd(q, k, v, qp, qp, ones)
            ref = TR.flash_attention_ref(q, k, v, qp, qp, ones)
            assert_close(f"flash_attention G={heads // kvh} (H={heads}, "
                         f"Hkv={kvh}, S={s})", out, ref, dtype)
        k1, v1 = rnd((nb + 1, page, 16, d), dtype), \
            rnd((nb + 1, page, 16, d), dtype)
        t1 = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        q = rnd((1, 16, 1, s, d), dtype)
        for offset in (0, 256):
            out = TP.paged_prefill_attention_grouped(q, k1, v1, t1, offset)
            ref = TR.paged_prefill_attention_ref(q, k1, v1, t1, offset)
            assert_close(f"paged_prefill G=1 (Hkv=16, S={s}) "
                         f"offset={offset}", out, ref, dtype)


GEMMA2 = "gemma2-9b"
# serve-gemma2's depth: 14 of 42 layers (7 local, 7 global), for the
# smoke's time (each layer kind and kernel stays)
SERVE_GEMMA2_LAYERS = 14


def gemma2_kernel_phase(dev, flush, results):
    """Phase 3, head_dim 256 at gemma2-9b's shapes (Hkv=8, G=2, D=256,
    page 16, softcap 50), f32 and bf16, each kernel against its plain
    version and timed beside its bound, the plain version and SDPA at the
    same shape and mask WITHOUT the softcap (no single PyTorch call
    applies a tanh softcap; the line says so): flash, causal with window
    4096, at Sq=Skv=4608 (the window bites for the last 512 queries);
    the paged prefill at S=600 from offset 0 and S=256 from offset 4096
    (fp pools; int8 pools at S=600); the fused decode at B=4, positions
    up to 6000 over 512-entry tables (fp and int8 pools, written rows
    held to the plain version's, int8 bit-equal); and the ring-view decode
    of the local layers (the unfused decode over B=4 rings of W=4096 rows,
    one W-row page a slot, lengths min(pos + 1, 4096) with one slot short
    of a full ring).  Queries are drawn at std 4 and K/V at std 1: scores
    of std 4 let a few keys dominate each row, so outputs are of order 1
    and a kernel that drops or misplaces a 64-key tile moves them by far
    more than the tolerance (at std-1 queries over 4,096 keys they are
    ~0.03, of the tolerance's own size).  Then, bf16 only, the int8
    prefill at S=600 with every input at std 2 (``int8_prefill_numerics``),
    where the plain version and the kernel round in different places."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import paged_attention as TP
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    cfg = REGISTRY[GEMMA2]
    hk, d, page, cap = cfg.num_kv_heads, cfg.head_dim, 16, \
        cfg.attn_logit_softcap
    g = cfg.num_heads // hk
    h, win = hk * g, cfg.window_size
    gen = torch.Generator(device=dev).manual_seed(23)
    lib_note = "sdpa without the softcap"

    def rnd(shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(dtype)

    def row(name, dtype, launch, plain, sdpa, err, nbytes, ops, split,
            shape):
        bnd, by = bound_ms(nbytes, ops, dtype)
        results[(name, dtype)] = dict(
            max_abs_err=err, ms=bench(launch, flush),
            plain_ms=bench(plain, flush, iters=5, warmup=1),
            library_ms=bench(sdpa, flush), bound_ms=bnd, bound_by=by,
            device_ms=device_ms(launch, flush),
            library_device_ms=device_ms(sdpa, flush), splits=split,
            shape=shape, library=lib_note)

    def gathered(table, kpool, vpool, dtype):
        """The pages of ``table`` in logical order, heads repeated G
        times, (B, H, T, D), for SDPA."""
        bb, nbb = table.shape
        kg = kpool[table.long()].reshape(bb, nbb * kpool.shape[1], hk, d)
        vg = vpool[table.long()].reshape(bb, nbb * vpool.shape[1], hk, d)
        return (kg.transpose(1, 2).repeat_interleave(g, 1).to(dtype)
                .contiguous(),
                vg.transpose(1, 2).repeat_interleave(g, 1).to(dtype)
                .contiguous())

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        names = []

        # -- flash: causal, window 4096, softcap 50, Sq = Skv = 4608 ------
        s = 4608
        q, k, v = rnd((1, h, s, d), dtype, QSTD), \
            rnd((1, hk, s, d), dtype), rnd((1, hk, s, d), dtype)
        qp = torch.arange(s, dtype=torch.int32, device=dev)
        ones = torch.ones((s,), dtype=torch.int32, device=dev)
        kw = dict(causal=True, window=win, softcap=cap)
        out = TF.flash_attention_bhsd(q, k, v, qp, qp, ones, **kw)
        ref = TR.flash_attention_ref(q, k, v, qp, qp, ones, **kw)
        torch.cuda.synchronize()
        err = assert_close("flash_attention_d256", out, ref, dtype)
        del out, ref
        rel = qp[:, None].long() - qp[None, :].long()
        fmask = (rel >= 0) & (rel < win)
        pairs = int(fmask.sum())
        kr = k.repeat_interleave(g, 1).contiguous()
        vr = v.repeat_interleave(g, 1).contiguous()
        row("flash_attention_d256", dtype,
            lambda: TF.flash_attention_bhsd(q, k, v, qp, qp, ones, **kw),
            lambda: TR.flash_attention_ref(q, k, v, qp, qp, ones, **kw),
            functools.partial(F.scaled_dot_product_attention, q, kr, vr,
                              attn_mask=fmask),
            err, (2 * h + 2 * hk) * s * d * el + 12 * s, 4 * pairs * h * d,
            splits_of(dtype, TF.flash_split(1, h, s, s)),
            f"B=1 H={h} Hkv={hk} Sq=Skv={s} D={d} causal window={win} "
            f"softcap={cap:g}")
        names.append("flash_attention_d256")
        del q, k, v, kr, vr, fmask, rel

        # -- paged prefill: S=600 at 0 (fp, int8), S=256 at 4096 (fp) -----
        nb = 288                                   # 4608 keys of table
        bt = torch.randperm(nb, generator=gen, device=dev)[None].to(
            torch.int32)
        kq, ks = TR.quantize_int8_rows(rnd((nb + 1, page, hk, d)))
        vq, vs = TR.quantize_int8_rows(rnd((nb + 1, page, hk, d)))
        kf, vf = TR.dequantize_int8(kq, ks), TR.dequantize_int8(vq, vs)
        kp, vp = kf.to(dtype), vf.to(dtype)
        kg, vg = gathered(bt, kf, vf, dtype)
        for name, s, offset, pool in (
                ("paged_prefill_d256", 600, 0, "fp"),
                ("paged_prefill_d256_s256", 256, 4096, "fp"),
                ("paged_prefill_int8_d256", 600, 0, "int8")):
            q = rnd((1, hk, g, s, d), dtype, QSTD)
            pools = (kp, vp) if pool == "fp" else (kq, vq)
            sc = {} if pool == "fp" else dict(k_scales=ks, v_scales=vs)

            def launch(q=q, offset=offset, pools=pools, sc=sc):
                return TP.paged_prefill_attention_grouped(
                    q, *pools, bt, offset, softcap=cap, **sc)

            def plain(q=q, offset=offset, pools=pools, sc=sc):
                return TR.paged_prefill_attention_ref(
                    q, *pools, bt, offset, softcap=cap, **sc)
            out, ref = launch(), plain()
            torch.cuda.synchronize()
            err = assert_close(f"{name} offset={offset}", out, ref, dtype)
            t = offset + s
            qmask = (torch.arange(nb * page, device=dev)[None, :]
                     <= offset + torch.arange(s, device=dev)[:, None])
            row_bytes = d * el if pool == "fp" else d + 4
            row(name, dtype, launch, plain,
                functools.partial(F.scaled_dot_product_attention,
                                  q.reshape(1, h, s, d), kg, vg,
                                  attn_mask=qmask),
                err, 2 * h * s * d * el + 2 * t * hk * row_bytes
                + 4 * -(-t // page),
                4 * (s * offset + s * (s + 1) // 2) * h * d,
                splits_of(dtype, TP.prefill_split(1, hk, g, s, page, nb,
                                                  offset)),
                f"B=1 Hkv={hk} G={g} S={s} offset={offset} D={d} P={page} "
                f"NB={nb} softcap={cap:g} {pool} pools")
            names.append(name)
        del kg, vg

        # -- fused decode: B=4, positions up to 6000, 512-entry tables ----
        b, nb = 4, 512                            # max_seq 8192
        n = b * nb + 1
        pos = torch.tensor([5999, 4095, 4096, 1234], dtype=torch.int32,
                           device=dev)
        bt = torch.randperm(b * nb, generator=gen, device=dev).reshape(
            b, nb).to(torch.int32)
        kq, ks = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        vq, vs = TR.quantize_int8_rows(rnd((n, page, hk, d)))
        kf, vf = TR.dequantize_int8(kq, ks), TR.dequantize_int8(vq, vs)
        keys = int((pos.long() + 1).sum())
        tables = int(((pos.long() + page) // page).sum())
        q, kn, vn = rnd((b, hk, g, d), dtype, QSTD), \
            rnd((b, hk, d), dtype), rnd((b, hk, d), dtype)
        kg, vg = gathered(bt, kf, vf, dtype)
        dmask = (torch.arange(nb * page, device=dev)[None, :]
                 <= pos[:, None].long())[:, None, None, :]
        for pool in ("fp", "int8"):
            name = "fused_paged_decode" + ("_int8" if pool == "int8" else
                                           "") + "_d256"
            if pool == "int8":
                pools, row_bytes = [kq, vq, ks, vs], d + 4
            else:
                pools, row_bytes = [kf.to(dtype), vf.to(dtype), None,
                                    None], d * el
            mine = [None if x is None else x.clone() for x in pools]
            refp = [None if x is None else x.clone() for x in pools]

            def launch(p=mine):
                return TP.fused_paged_decode_grouped(
                    q, kn, vn, p[0], p[1], bt, pos, theta=cfg.rope_theta,
                    softcap=cap, k_scales=p[2], v_scales=p[3])

            def plain(p=refp):
                return TR.fused_paged_decode_ref(
                    q, kn, vn, p[0], p[1], bt, pos, theta=cfg.rope_theta,
                    softcap=cap, k_scales=p[2], v_scales=p[3])
            out, ref = launch()[0], plain()[0]
            torch.cuda.synchronize()
            err = assert_close(f"{name} out", out, ref, dtype)
            for what, a, r in zip(("k_pages", "v_pages", "k_scales",
                                   "v_scales"), mine, refp):
                if a is None:
                    continue
                if pool == "int8":
                    same = torch.equal(a, r)
                    print(f"[kernels] {name} {str(dtype)[6:]} written "
                          f"{what} bit-equal: {same}")
                    check(same, f"{name} {what} differ from the plain "
                                f"version's ({dtype})")
                else:
                    assert_close(f"{name} {what}", a, r, dtype)
            split = TP.fused_paged_decode_grouped.last_split[0]
            row(name, dtype, launch, plain,
                functools.partial(F.scaled_dot_product_attention,
                                  q.reshape(b, h, 1, d), kg, vg,
                                  attn_mask=dmask),
                err, 2 * b * h * d * el + 2 * b * hk * d * el
                + 2 * b * hk * row_bytes + 2 * keys * hk * row_bytes
                + 4 * (b + tables), 4 * keys * hk * g * d, split,
                f"B={b} Hkv={hk} G={g} D={d} P={page} NB={nb} pos<=6000 "
                f"softcap={cap:g} {pool} pools")
            names.append(name)
            del mine, refp
        del kg, vg, kq, vq, kf, vf

        # -- the ring-view decode: B=4 rings of W=4096 rows, one W-row
        #    page a slot, lengths min(pos + 1, W) ---------------------------
        w = win
        kr, vr = rnd((b, w, hk, d), dtype), rnd((b, w, hk, d), dtype)
        table = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
        lengths = torch.tensor([4096, 4096, 1000, 4096], dtype=torch.int32,
                               device=dev)
        q = rnd((b, hk, g, d), dtype, QSTD)
        out = TP.paged_attention_grouped(q, kr, vr, table, lengths,
                                         softcap=cap)
        ref = TR.paged_attention_ref(q, kr, vr, table, lengths, softcap=cap)
        torch.cuda.synchronize()
        err = assert_close("paged_attention_ring_d256", out, ref, dtype)
        keys = int(lengths.long().sum())
        rmask = (torch.arange(w, device=dev)[None, :]
                 < lengths[:, None].long())[:, None, None, :]
        row("paged_attention_ring_d256", dtype,
            lambda: TP.paged_attention_grouped(q, kr, vr, table, lengths,
                                               softcap=cap),
            lambda: TR.paged_attention_ref(q, kr, vr, table, lengths,
                                           softcap=cap),
            functools.partial(
                F.scaled_dot_product_attention, q.reshape(b, h, 1, d),
                kr.transpose(1, 2).repeat_interleave(g, 1).contiguous(),
                vr.transpose(1, 2).repeat_interleave(g, 1).contiguous(),
                attn_mask=rmask),
            err, 2 * b * h * d * el + 2 * keys * hk * d * el + 8 * b,
            4 * keys * hk * g * d, TP.paged_attention_grouped.last_split[0],
            f"B={b} Hkv={hk} G={g} D={d} W={w} (one {w}-row page a slot) "
            f"lengths<=4096 softcap={cap:g}")
        names.append("paged_attention_ring_d256")
        del kr, vr
        print_rows(results, dtype, names)
        torch.cuda.empty_cache()

    # bf16 int8 prefill with every input at std 2: outputs near zero that
    # cancel terms up to ~8 leave the plain version and the kernel a few
    # hundredths apart, beyond 2e-2 absolute; both are held to an f64
    # evaluation in bf16 units at the terms' magnitude instead
    e = int8_prefill_numerics(TP, TR, dev, cfg, seed=23)
    print(f"[kernels] paged_prefill_int8_d256 numerics bf16, inputs at std "
          f"2: max |kernel - plain| {e['gap']:.3g}; from the f64 value the "
          f"kernel {e['max_ulps']:.3g} bf16 ulps at sum_j p_j |v_j| (its "
          f"rounding bound 1.5), the plain version "
          f"{e['plain_max_ulps']:.3g}; max |out| {e['max_out']:.3g}")
    check(e["max_ulps"] <= 2.0,
          f"bf16 int8 paged prefill at D=256 strays from f64 beyond its "
          f"rounding: {e}")
    results[("paged_prefill_int8_d256", torch.bfloat16)]["numerics_std2"] = e


QSTD = 4.0      # gemma2_kernel_phase's query std (K/V at 1): outputs ~ 1


def int8_prefill_numerics(TP, TR, dev, cfg, seed, s=600, std=2.0):
    """The bf16 int8 paged prefill at gemma2's shape (Hkv, G, D=256, page
    16, its softcap), S tokens from offset 0, q and K/V drawn at ``std``:
    the kernel's and the plain version's largest distance from an f64
    evaluation of the same function on the same (bf16 q, dequantized K/V)
    inputs, in bf16 ulps at m = sum_j p_j |v_j|, the magnitude of the
    terms each output sums.  The kernel rounds each p_j times its v scale
    to bf16 (at most half an ulp of m over the sum) and then its output
    (at most an ulp of m): 1.5 in all, checked at 2.  The plain version
    rounds p_j and v_j apart and sums in a bf16 GEMM; its distance is
    reported beside.  A dropped tile or a wrong mask moves a row by many
    ulps."""
    import math
    gen = torch.Generator(device=dev).manual_seed(seed)
    hk, d, page = cfg.num_kv_heads, cfg.head_dim, 16
    g, cap = cfg.num_heads // hk, cfg.attn_logit_softcap
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev) * std
    nb = -(-s // page)
    bt = torch.randperm(nb, generator=gen, device=dev)[None].to(torch.int32)
    kq, ks = TR.quantize_int8_rows(rnd(nb + 1, page, hk, d))
    vq, vs = TR.quantize_int8_rows(rnd(nb + 1, page, hk, d))
    q = rnd(1, hk, g, s, d).to(bf)
    sc = dict(k_scales=ks, v_scales=vs)
    out = TP.paged_prefill_attention_grouped(q, kq, vq, bt, 0, softcap=cap,
                                             **sc).float()
    plain = TR.paged_prefill_attention_ref(q, kq, vq, bt, 0, softcap=cap,
                                           **sc).float()
    idx = bt[0].long()
    k = (kq.double() * ks.double()[..., None])[idx].reshape(-1, hk, d)[:s]
    v = (vq.double() * vs.double()[..., None])[idx].reshape(-1, hk, d)[:s]
    sco = torch.einsum("hgsd,thd->hgst", q[0].double(), k) / math.sqrt(d)
    sco = cap * torch.tanh(sco / cap)
    causal = torch.arange(s, device=dev)[None, :] \
        <= torch.arange(s, device=dev)[:, None]
    p = torch.softmax(sco.masked_fill(~causal, float("-inf")), -1)
    ref = torch.einsum("hgst,thd->hgsd", p, v)[None]
    unit = bf16_ulp(torch.einsum("hgst,thd->hgsd", p, v.abs())[None]
                    .float()).double()
    return dict(gap=max_err(out, plain),
                max_ulps=float(((out.double() - ref).abs() / unit).max()),
                plain_max_ulps=float(((plain.double() - ref).abs()
                                      / unit).max()),
                max_out=float(ref.abs().max()))


MM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}     # by output dtype
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# The JAX kernel tests' tolerances (tests/test_kernels.py).  matmul: f32
# sums in another order; a bf16 output may round one ulp (at most 2^-7
# relative) apart.  norm: f32 reductions in another order; bf16 as above.
# Inputs are scaled so that outputs are of order 1 (w ~ N(0, 1/K)).

# name -> (M, K, N, activation, bias, x/w dtype, out_dtype): yi-6b's gate
# projection at 4 decode slots and at a 512-token prefill chunk, then a
# 4096-wide projection with each epilogue, and bf16 operands to f32
FRONT_DOOR_MATMULS = {
    "matmul_fused": (4, 4096, 11008, "silu", False, torch.bfloat16, None),
    "matmul_fused_prefill": (512, 4096, 11008, "silu", False,
                             torch.bfloat16, None),
    "matmul_fused_gelu_bias": (512, 4096, 4096, "gelu", True,
                               torch.bfloat16, None),
    "matmul_fused_gelu_bias_f32": (512, 4096, 4096, "gelu", True,
                                   torch.float32, None),
    "matmul_fused_relu2": (512, 4096, 4096, "relu2", False, torch.bfloat16,
                           None),
    "matmul_fused_none_bias": (512, 4096, 4096, "none", True,
                               torch.bfloat16, None),
    "matmul_fused_bf16_to_f32": (512, 4096, 11008, "silu", False,
                                 torch.bfloat16, torch.float32),
}
# name -> (R, D, kind, x dtype): rmsnorm at 4 decode rows and a 512-row
# prefill at yi-6b's and jamba's widths, bf16 x and f32 x (f32 scales, as
# the port's models keep them), and layernorm with a bias
FRONT_DOOR_NORMS = {
    "norm_onepass": (512, 4096, "rmsnorm", torch.bfloat16),
    "norm_onepass_r4": (4, 4096, "rmsnorm", torch.bfloat16),
    "norm_onepass_d8192": (512, 8192, "rmsnorm", torch.bfloat16),
    "norm_onepass_r4_d8192": (4, 8192, "rmsnorm", torch.bfloat16),
    "norm_onepass_f32": (512, 4096, "rmsnorm", torch.float32),
    "norm_onepass_f32_r4": (4, 4096, "rmsnorm", torch.float32),
    "norm_onepass_f32_d8192": (512, 8192, "rmsnorm", torch.float32),
    "norm_onepass_f32_r4_d8192": (4, 8192, "rmsnorm", torch.float32),
    "norm_onepass_layernorm_bias": (512, 8192, "layernorm", torch.bfloat16),
}


def mm_yardstick(x, w, bias, act, out_dtype):
    """(label, fn): the PyTorch calls that compute one front-door matmul
    (with a bias only where ``out_dtype`` is x's dtype, as in every case
    here), timed as its library yardstick and never called by the port."""
    F = torch.nn.functional
    post = {"none": None, "silu": F.silu,
            "relu2": lambda t: torch.square(F.relu(t)),
            "gelu": functools.partial(F.gelu, approximate="tanh")}[act]
    if out_dtype != x.dtype:
        label, mm = "mm(out_dtype)", functools.partial(
            torch.mm, x, w, out_dtype=out_dtype)
    elif bias is not None:
        label, mm = "addmm", functools.partial(torch.addmm, bias.to(x.dtype),
                                               x, w)
    else:
        label, mm = "matmul", functools.partial(torch.matmul, x, w)
    if post is None:
        return f"{label} (one call)", mm
    return f"{label} + {act} (two calls)", lambda: post(mm())


def front_door_phase(dev, flush, results):
    """Phase 3, the kernel front door: ``repro_torch.kernels.ops``'s
    ``matmul_fused`` and ``norm_onepass`` on CUDA tensors at the served
    models' widths (``FRONT_DOOR_MATMULS``, ``FRONT_DOOR_NORMS``), the two
    kernels' launch counters zeroed just before the calls and read just
    after (each must equal the number of calls); then every output against
    its plain version, and the times: the kernel through the door, the
    plain version, and the library yardstick, timed here only and never
    called by the port -- ``torch.addmm`` for none + bias, else
    ``torch.addmm``/``torch.matmul`` then the activation (two calls),
    ``F.rms_norm``/``F.layer_norm`` for the norms."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels.fused_matmul import matmul_fused
    from repro_torch.kernels.layernorm import norm_onepass
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(5)

    mm_in, norm_in = {}, {}
    for name, (m, k, n, act, with_bias, dt, out_dt) in \
            FRONT_DOOR_MATMULS.items():
        x = torch.randn((m, k), generator=gen, device=dev).to(dt)
        w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dt)
        bias = torch.randn((n,), generator=gen, device=dev) \
            if with_bias else None
        mm_in[name] = (x, w, bias, dict(activation=act, out_dtype=out_dt))
    for name, (r, d, kind, dt) in FRONT_DOOR_NORMS.items():
        x = (torch.randn((r, d), generator=gen, device=dev) * 3 + 1).to(dt)
        scale = torch.randn((d,), generator=gen, device=dev)
        bias = torch.randn((d,), generator=gen, device=dev) \
            if kind == "layernorm" else None
        norm_in[name] = (x, scale, bias, dict(kind=kind, eps=1e-6))

    # the front door's run: counters at 0 just before, read just after;
    # each matmul's path and K splits as the wrapper planned them
    matmul_fused.launches = norm_onepass.launches = 0
    outs, plans = {}, {}
    for name, (x, w, b, kw) in mm_in.items():
        outs[name] = ops.matmul_fused(x, w, b, **kw)
        plans[name] = matmul_fused.last_plan
    for name, (x, s, b, kw) in norm_in.items():
        outs[name] = ops.norm_onepass(x, s, b, **kw)
        plans[name] = norm_onepass.last_plan
    torch.cuda.synchronize()
    launches = {"matmul_fused": matmul_fused.launches,
                "norm_onepass": norm_onepass.launches}
    print(f"[front door] launches through kernels.ops: "
          f"{json.dumps(launches)} for {len(mm_in)} matmul and "
          f"{len(norm_in)} norm calls")
    check(launches == {"matmul_fused": len(mm_in),
                       "norm_onepass": len(norm_in)},
          f"front-door launches {launches} differ from the calls made")

    for name, (x, w, bias, kw) in mm_in.items():
        m, k = x.shape
        n = w.shape[1]
        act, out_dt = kw["activation"], kw["out_dtype"] or x.dtype
        ref = TR.matmul_fused_ref(x, w, bias, **kw)
        err = max_err(outs[name], ref)
        tol = MM_TOL[out_dt]
        ok = torch.allclose(outs[name].float(), ref.float(), atol=tol,
                            rtol=tol)
        print(f"[front door] {name} {str(x.dtype)[6:]}->{str(out_dt)[6:]}: "
              f"max_abs_err={err:.3g} (atol=rtol={tol}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version")
        ms = bench(lambda: ops.matmul_fused(x, w, bias, **kw), flush)
        plain = bench(lambda: TR.matmul_fused_ref(x, w, bias, **kw), flush)
        lib_name, lib_fn = mm_yardstick(x, w, bias, act, out_dt)
        lib = bench(lib_fn, flush)
        dev_ms = device_ms(lambda: ops.matmul_fused(x, w, bias, **kw), flush)
        lib_dev = device_ms(lib_fn, flush)
        el = x.element_size()
        nbytes = (m * k + k * n) * el + m * n * (
            torch.tensor([], dtype=out_dt).element_size()) \
            + (0 if bias is None else n * 4)
        bnd, by = bound_ms(nbytes, 2 * m * n * k, x.dtype)
        results[(name, x.dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            library=lib_name, bound_ms=bnd, bound_by=by,
            device_ms=dev_ms, library_device_ms=lib_dev,
            launches=launches["matmul_fused"], path=plans[name][0],
            splits=plans[name][1],
            shape=f"M={m} K={k} N={n} {act}"
                  f"{'' if bias is None else ' +bias'} "
                  f"{str(x.dtype)[6:]}->{str(out_dt)[6:]}")

    for name, (x, scale, bias, kw) in norm_in.items():
        r, d = x.shape
        ref = TR.norm_onepass_ref(x, scale, bias, **kw)
        err = max_err(outs[name], ref)
        tol = NORM_TOL[x.dtype]
        ok = torch.allclose(outs[name].float(), ref.float(), atol=tol,
                            rtol=tol)
        print(f"[front door] {name} {str(x.dtype)[6:]}: max_abs_err="
              f"{err:.3g} (atol=rtol={tol}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} disagrees with its plain version")
        ms = bench(lambda: ops.norm_onepass(x, scale, bias, **kw), flush)
        plain = bench(lambda: TR.norm_onepass_ref(x, scale, bias, **kw),
                      flush)
        ls = scale.to(x.dtype)
        if kw["kind"] == "layernorm":
            lib_name = "F.layer_norm (one call)"
            lib_fn = functools.partial(F.layer_norm, x, (d,), ls,
                                       bias.to(x.dtype), 1e-6)
        else:
            lib_name = "F.rms_norm (one call)"
            lib_fn = functools.partial(F.rms_norm, x, (d,), ls, 1e-6)
        lib = bench(lib_fn, flush)
        dev_ms = device_ms(lambda: ops.norm_onepass(x, scale, bias, **kw),
                           flush)
        lib_dev = device_ms(lib_fn, flush)
        el = x.element_size()
        nbytes = 2 * r * d * el + d * 4 * (1 if bias is None else 2)
        bnd, by = bound_ms(nbytes, 5 * r * d, torch.float32)
        results[(name, x.dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            library=lib_name, bound_ms=bnd, bound_by=by,
            device_ms=dev_ms, library_device_ms=lib_dev,
            launches=launches["norm_onepass"], path=plans[name][0],
            plan=plans[name][1:],
            shape=f"R={r} D={d} {kw['kind']}"
                  f"{'' if bias is None else ' +bias'} "
                  f"{str(x.dtype)[6:]} x, f32 scale")
    for name in (*mm_in, *norm_in):
        r = results[(name, (mm_in.get(name) or norm_in[name])[0].dtype)]
        plan = f", path {r['path']}, splits {r['splits']}" \
            if "splits" in r else f", path {r['path']}, (vectors, threads " \
            f"a row, rows a block, blocks) {r['plan']}"
        print(f"[front door] {name} ({r['shape']}{plan}): {r['ms']:.4f} ms "
              f"(device {fmt_ms(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, {r['library']} {r['library_ms']:.4f} "
              f"ms (device {fmt_ms(r['library_device_ms'])}), bound "
              f"{r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return launches


def repair_phase(dev, flush):
    """Phase 3, the f32 accumulators the model keeps in bf16
    (``models.layers.matmul_f32``: ``torch.mm(..., out_dtype=float32)`` on
    CUDA) against the product of the operands widened to f32, at full
    width: yi-6b's MLP hidden product (4 and 512 tokens, K = 4096,
    N = 11008) and LM head (4 tokens, N = 64000), and jamba's mamba x
    projection (512 tokens, d_inner 16384 -> dt_rank + 2 d_state = 544).
    Also times the head both ways: the widened form is what the port's
    LM head ran before, and its cost fell on every decode tick."""
    from repro_torch.models.layers import matmul_f32
    gen = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    out = {}
    for name, (m, k, n) in (("mlp hidden, 4 tokens", (4, 4096, 11008)),
                            ("mlp hidden, 512 tokens", (512, 4096, 11008)),
                            ("lm head, 4 tokens", (4, 4096, 64000)),
                            ("mamba x_proj, 512 tokens", (512, 16384, 544))):
        x = torch.randn((1, m, k), generator=gen, device=dev).to(bf)
        w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(bf)
        got = matmul_f32(x, w)
        ref = torch.matmul(x.float(), w.float())
        torch.cuda.synchronize()
        err = max_err(got, ref)
        ok = got.dtype == torch.float32 and torch.allclose(
            got, ref, atol=MM_TOL[torch.float32], rtol=MM_TOL[torch.float32])
        ms = bench(lambda: matmul_f32(x, w), flush)
        widened = bench(lambda: torch.matmul(x.float(), w.float()), flush)
        print(f"[repair] {name}: matmul_f32 (bf16 operands, f32 "
              f"accumulator) vs the f32-widened product max_abs_err="
              f"{err:.3g} (atol=rtol={MM_TOL[torch.float32]}) "
              f"{'ok' if ok else 'MISMATCH'}; {ms:.4f} ms, widened "
              f"{widened:.4f} ms")
        check(ok, f"matmul_f32 ({name}) differs from the widened product")
        out[name] = dict(max_abs_err=err, ms=ms, widened_ms=widened)
    return out


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


def run_schedule(eng, sched, request_cls, swaps=()):
    """Serve ``sched``, entries (prompt, max_new, submit_tick[, eos]),
    forcing ``eng.replan(plan)`` at the ticks of ``swaps``, entries
    (tick, ServingPlan or None)."""
    pending = sorted(enumerate(sched), key=lambda x: x[1][2])
    swaps = sorted(swaps, key=lambda x: x[0])
    tick, busy = 0, True
    while busy or pending or swaps:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _, *eos) = pending.pop(0)
            eng.submit(request_cls(uid, prompt, max_new,
                                   eos_token=eos[0] if eos else None))
        while swaps and swaps[0][0] <= tick:
            eng.replan(swaps.pop(0)[1])
        busy = eng.tick()
        tick += 1
    return {r.uid: r for r in eng.done}


def compare_streams(label, got, refs, gaps):
    """Every stream of ``got`` ({uid: Request or tokens}) must equal
    ``refs`` ({uid: tokens}); on a difference the reference's top-2 logit
    gap at that step is printed (``gaps[uid][step]``) and the check
    fails."""
    for uid, ref in refs.items():
        mine = getattr(got[uid], "out_tokens", got[uid])
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
    produce is checked for finiteness and, for plain decode steps of a
    sync engine, each slot's top-2 logit gap is recorded per (uid, token
    index).  An overlapped engine records no gap: reading one back would
    sync the host with every step."""
    finite, gaps = [], {}
    record_gaps = not eng._overlap

    def serve_step(params, cache, tokens, cache_index, block_tables=None):
        live = [(s, r.uid, len(r.out_tokens))
                for s, r in enumerate(eng._slot_req)
                if r is not None and record_gaps]
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


def unwatch(eng):
    """Give a watched engine its own steps back (the watch's gap records
    sync the host, which the sync counts must not see)."""
    from repro_torch.serving import engine as E
    if eng.plan is not None:
        del eng._rt.walk, eng._rt.head
        return
    eng.serve_step = E.make_serve_step(eng.model)
    if eng._spec_k:
        eng._verify_step = E.make_verify_step(eng.model)
    if eng.paged:
        eng._prefill_suffix_paged = E.make_prefill_suffix_paged_step(
            eng.model, eng.max_seq)


def watch_plan_engine(eng):
    """Wrap a plan engine's runtime steps (each replica's stage walk and
    the prefill head) so that every logit they produce is checked for
    finiteness."""
    finite = []
    watch_runtimes(eng, finite)
    return finite


def watch_all(eng, model, max_seq):
    """``watch_engine`` and ``watch_runtimes`` together, for an engine
    that re-plans between the monolithic point and plans."""
    finite, _ = watch_engine(eng, model, max_seq)
    watch_runtimes(eng, finite)
    return finite


def watch_runtimes(eng, finite):
    """Wrap the stage walk and the prefill head of every plan runtime the
    engine holds or builds later (a re-plan builds them on demand), so
    that every logit they produce is checked for finiteness."""
    def watch(rt):
        def watched(fn):
            def call(*args, **kw):
                logits = fn(*args, **kw)
                finite.append(torch.isfinite(logits).all())
                return logits
            return call
        rt.walk, rt.head = watched(rt.walk), watched(rt.head)
    for rt in eng._rt_cache.values():
        watch(rt)
    runtime_for = eng._runtime_for

    def watched_runtime_for(splan):
        new = splan not in eng._rt_cache
        rt = runtime_for(splan)
        if new:
            watch(rt)
        return rt
    eng._runtime_for = watched_runtime_for


@contextlib.contextmanager
def tally_calls(name, key):
    """Tally the calls of the dispatch front door's ``name`` (which the
    model looks up at every call, and which calls its kernel's wrapper
    once) by ``key(*args)`` while the block runs.  The wrappers' launch
    counts are untouched: this only sorts the launches they count by
    shape."""
    from repro_torch.backend import dispatch as module
    tally = collections.Counter()
    fn = getattr(module, name)

    def call(*args, **kw):
        tally[key(*args)] += 1
        return fn(*args, **kw)
    setattr(module, name, call)
    try:
        yield tally
    finally:
        setattr(module, name, fn)


def run_engine(label, model, params, sched, path, max_seq, slots, swaps=(),
               **kw):
    """One engine (monolithic, or plan-driven with ``plan=``) over
    ``sched``, the launch counters of the kernels in ``path`` zeroed just
    before and read just after; each must have launched, every logit must
    be finite, and an overlapped engine must end with nothing in flight.
    With ``swaps`` ((tick, plan) entries) the engine is re-planned at
    those ticks, and each swap must have happened.  Returns (engine,
    {uid: Request}, launches)."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(model, params, slots=slots, max_seq=max_seq, **kw)
    if swaps:
        finite = watch_all(eng, model, max_seq)
    elif eng.plan is not None:
        finite = watch_plan_engine(eng)
    else:
        finite, _ = watch_engine(eng, model, max_seq)
    for fn in path.values():
        fn.launches = 0
    got = run_schedule(eng, sched, Request, swaps)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in path.items()}
    if swaps:
        st = eng.stats()
        print(f"[replan] {label}: {len(got)} requests, replans "
              f"{st['replans']}, migrations {st['migrations']} (copies "
              f"{st['migration_copies']}), ends on {st['plan_label']}; "
              f"chunks per admission {eng.prefill_chunk_counts}, launches "
              f"{json.dumps(launches)}")
        check(st["replans"] == len(swaps),
              f"{label}: {st['replans']} re-plans for {len(swaps)} swaps")
    else:
        tag = "[plan]" if eng.plan is not None else "[overlap]"
        print(f"{tag} {label}: {len(got)} requests, chunks per admission "
              f"{eng.prefill_chunk_counts}, launches {json.dumps(launches)}")
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a kernel of the path never launched: {launches}")
    check(eng._overlap == bool(kw.get("overlap")) and not eng._inflight,
          f"{label}: the engine did not run the runtime it was given")
    return eng, got, launches


def plan_parity_phase(dev, kernels):
    """Phase 4, plans: f32 yi-6b at full width, 2 layers, through
    ``uniform_plan(2, 2, n_microbatches=2)`` lowered for 4 slots and chunk
    16 (2 stages, 2 decode replicas): the dense and the paged engine must
    give the one-shot gold's streams (chunks of 16, 14, 2 and 1 tokens;
    dense continuations through flash with unwritten ring rows masked,
    paged chunks at mid-table offsets); paged int8 pools with speculate=4
    must give the monolithic int8 engine's streams without speculation,
    on a schedule whose streams make the drafter propose."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.plan import lower_serving, uniform_plan
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(REGISTRY["yi-6b"], num_layers=2,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    splan = lower_serving(uniform_plan(cfg.num_groups, 2, n_microbatches=2),
                          slots=4, chunk=16)
    print(f"[plan] {splan.describe()}")
    rng = np.random.default_rng(3)
    v = cfg.vocab_size

    def toks(n):
        return rng.integers(1, v, n).astype(np.int32)

    prefix = toks(64)
    sched = [(np.concatenate([prefix, toks(16)]), 4, 0),
             (toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
             (np.concatenate([prefix, toks(30)]), 10, 3),   # warm prefix
             (toks(70), 9, 5)]
    max_seq = 256
    golds, gaps = {}, {}
    for uid, (prompt, max_new, _) in enumerate(sched):
        golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                      max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    launches = {}
    # (B, S, H, D) queries and keys
    with tally_calls("dispatch_flash_attention",
                     lambda q, k, *_: (q.shape[1], k.shape[1])) as tally:
        _, got, launches["dense"] = run_engine(
            "dense fp", model, params, sched,
            {"flash_attention": kernels["flash_attention"]}, max_seq,
            splan.slots, plan=splan)
    compare_streams("plan dense fp vs one-shot gold", got, golds, gaps)
    # a continuation attends the ring's rows beside its own keys
    cont = sum(n for (sq, skv), n in tally.items() if skv > sq)
    flash_shapes = {f"Sq={sq} Skv={skv}": n
                    for (sq, skv), n in sorted(tally.items())}
    print(f"[plan] dense fp: flash launches by shape "
          f"{json.dumps(flash_shapes)}: {cont} continuation chunks, "
          f"{launches['dense']['flash_attention'] - cont} chunk-0 passes")
    eng, got, launches["paged"] = run_engine(
        "paged fp", model, params, sched,
        {k: kernels[k] for k in ("fused_paged_decode", "paged_prefill")},
        max_seq, splan.slots, plan=splan, paged=True, page_size=16)
    compare_streams("plan paged fp vs one-shot gold", got, golds, gaps)
    st = eng.cache_stats()
    check(st["prefill_compute_hits"] >= 1
          and st["reused_prefill_tokens"] >= 64,
          "plan paged: the warm admission did not reuse the prefix")

    # speculation: redraw the prompts' last 8 tokens (as phase 4 does)
    # until the monolithic int8 streams make the drafter propose
    base = sched
    for attempt in range(16):
        redraw = np.random.default_rng(200 + attempt)
        sched = [(np.concatenate([p[:-8], redraw.integers(1, v, 8)]).astype(
            np.int32), m + 8, t) for p, m, t in base]
        eng = ServingEngine(model, params, slots=4, max_seq=max_seq,
                            paged=True, page_size=16, kv_dtype="int8")
        ref = {u: r.out_tokens
               for u, r in run_schedule(eng, sched, Request).items()}
        if would_draft(sched, ref):
            break
    else:
        check(False, "no schedule variant makes the drafter propose")
    eng, got, launches["int8_spec"] = run_engine(
        "paged int8 speculate=4", model, params, sched,
        {"fused_paged_decode": kernels["fused_paged_decode"],
         "paged_prefill": kernels["paged_prefill"],
         "paged_verify": kernels["paged_verify"]},
        max_seq, splan.slots, plan=splan, paged=True, page_size=16,
        kv_dtype="int8", speculate=4)
    compare_streams("plan paged int8 speculate=4 vs monolithic int8 "
                    "speculate=0", got, ref, {})
    spec = {k: eng.stats()[k] for k in ("spec_steps", "spec_proposed",
                                        "spec_accepted", "tokens_per_step")}
    print(f"[plan] paged int8 speculate=4 (variant {attempt}): "
          f"{json.dumps(spec)}")
    check(spec["spec_steps"] > 0, "plan int8 speculate=4: nothing verified")
    del eng, params
    torch.cuda.empty_cache()
    return dict(launches=launches, spec=spec,
                flash_shapes=flash_shapes, flash_continuations=cont)


def eos_schedule(golds, sched):
    """``sched`` with one request retiring on EOS: the first request
    whose gold stream has, from index 2 on and before its last token, a
    token it has not emitted before; that token is its EOS.  Returns
    (schedule, golds cut at that token, the request's uid)."""
    for uid, g in golds.items():
        j = next((i for i in range(2, len(g) - 1) if g[i] not in g[:i]),
                 None)
        if j is not None:
            out = [(p, m, t, g[j] if u == uid else None)
                   for u, (p, m, t) in enumerate(sched)]
            return out, {**golds, uid: g[:j + 1]}, uid
    check(False, "no gold stream has a fresh token to retire on")


def overlap_parity_phase(dev, kernels):
    """Phase 4, overlap: f32 yi-6b at full width, 2 layers, served with
    ``overlap=True`` (decode step N+1 dispatched before step N drains):
    monolithic dense and paged, and ``uniform_plan(2, 2,
    n_microbatches=2)`` at chunk 16, dense and paged, on parity_phase's
    staggered schedule (4 slots; a warm-prefix admission), and the paged
    engines, monolithic and plan, on a readmission schedule (5 requests
    through 2 slots, one retiring on EOS).  Every stream must equal the
    one-shot gold, and each path's kernels must have launched.  Then one
    traced paged plan run (sync, so that its steps are ``decode`` spans)
    must give the untraced run's streams, and its Perfetto object must
    validate."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.obs import to_perfetto, validate_perfetto
    from repro_torch.plan import lower_serving, uniform_plan
    cfg = dataclasses.replace(REGISTRY["yi-6b"], num_layers=2,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    v = cfg.vocab_size

    def toks(n):
        return rng.integers(1, v, n).astype(np.int32)

    prefix = toks(64)             # parity_phase's schedule, drawn alike
    sched = [(np.concatenate([prefix, toks(16)]), 4, 0),
             (toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
             (np.concatenate([prefix, toks(30)]), 10, 3),   # warm prefix
             (toks(70), 9, 5)]
    readmit = [(toks(40), 6, 0), (toks(25), 10, 0), (toks(60), 5, 1),
               (toks(18), 8, 2), (toks(33), 7, 3)]
    max_seq = 256
    golds, gaps = {}, {}
    for name, sc in (("staggered", sched), ("readmit", readmit)):
        golds[name], gaps[name] = {}, {}
        for uid, (prompt, max_new, _) in enumerate(sc):
            golds[name][uid], lgs = gold_decode(model, params, prompt,
                                                max_new, max_seq)
            gaps[name][uid] = [top2_gap(x) for x in lgs]
    readmit, golds["readmit"], eos_uid = eos_schedule(golds["readmit"],
                                                      readmit)
    flash = {"flash_attention": kernels["flash_attention"]}
    paged = {k: kernels[k] for k in ("fused_paged_decode", "paged_prefill")}
    pkw = dict(paged=True, page_size=16)
    plan4 = lower_serving(uniform_plan(cfg.num_groups, 2, n_microbatches=2),
                          slots=4, chunk=16)
    plan2 = lower_serving(uniform_plan(cfg.num_groups, 2, n_microbatches=2),
                          slots=2, chunk=16)
    runs = [("mono dense", "staggered", flash, 4, {}),
            ("mono paged", "staggered", paged, 4, pkw),
            ("plan dense", "staggered", flash, 4, {"plan": plan4}),
            ("plan paged", "staggered", paged, 4, {"plan": plan4, **pkw}),
            ("mono paged readmission + EOS", "readmit", paged, 2, pkw),
            ("plan paged readmission + EOS", "readmit", paged, 2,
             {"plan": plan2, **pkw})]
    launches, streams = {}, {}
    for label, name, path, slots, kw in runs:
        sc = sched if name == "staggered" else readmit
        eng, got, launches[label] = run_engine(
            f"f32 {label} overlap", model, params, sc, path, max_seq, slots,
            overlap=True, **kw)
        compare_streams(f"f32 {label} overlap vs one-shot gold", got,
                        golds[name], gaps[name])
        streams[label] = {u: r.out_tokens for u, r in got.items()}
    eos_len = len(streams["mono paged readmission + EOS"][eos_uid])
    print(f"[overlap] the EOS request (uid {eos_uid}) retired after "
          f"{eos_len} tokens of its {readmit[eos_uid][1]}")
    check(eos_len < readmit[eos_uid][1], "the EOS request ran to its budget")

    eng, got, _ = run_engine("f32 plan paged traced", model, params, sched,
                             paged, max_seq, 4, plan=plan4, trace=True,
                             **pkw)
    compare_streams("f32 plan paged traced vs untraced", got,
                    streams["plan paged"], gaps["staggered"])
    obj = to_perfetto(eng._tr)
    names = ("prefill_chunk", "decode", "admit", "retire", "submit")
    problems = validate_perfetto(obj, require_names=names)
    print(f"[overlap] traced plan run: {eng._tr.events} records, "
          f"{len(obj['traceEvents'])} trace events, problems {problems}")
    check(not problems, f"the traced plan run's Perfetto object: {problems}")
    del eng, params
    torch.cuda.empty_cache()
    return dict(launches=launches, eos_tokens=eos_len,
                trace_records=len(obj["traceEvents"]))


def rebalance_run(label, model, params, reqs, plan, path, max_seq, golds,
                  gaps):
    """Two requests ((prompt, max_new, uid) in ``reqs``) decode on slots 0
    and 1 of a 4-slot paged monolithic engine; then ``replan(plan)``, a
    plan whose replica 0 is slots [0, 1]: the load 2|0 forces one slot to
    move.  The pool's blocks in use, copy-on-writes and evictions must be
    unchanged by the swap, and the streams equal ``golds``.  Returns the
    engine's re-plan counters and the launches of ``path``."""
    from repro_torch.serving import Request, ServingEngine
    t0 = time.perf_counter()
    eng = ServingEngine(model, params, slots=4, max_seq=max_seq, paged=True,
                        page_size=16)
    finite = watch_all(eng, model, max_seq)
    for fn in path.values():
        fn.launches = 0
    for prompt, max_new, uid in reqs:
        eng.submit(Request(uid, prompt, max_new))
    while eng.queue:
        eng.tick()
    active = [s for s in range(4) if eng._slot_req[s] is not None]
    check(active == [0, 1], f"{label}: active slots {active}, not [0, 1]")
    pool = eng._pager.pool

    def counters():
        return (pool.blocks_in_use, pool.cow_copies, pool.evictions)
    before = counters()
    eng.replan(plan)
    after = counters()
    moved = [s for s in range(4) if eng._slot_req[s] is not None]
    got = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in path.items()}
    st = eng.stats()
    out = {k: st[k] for k in ("migrations", "migration_copies")}
    print(f"[replan] {label}: slots {active} -> {moved} on {plan.label}; "
          f"migrations {out['migrations']} (copies "
          f"{out['migration_copies']}); pool (blocks in use, cow copies, "
          f"evictions) {before} -> {after}; launches {json.dumps(launches)};"
          f" {time.perf_counter() - t0:.1f} s")
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a kernel of the path never launched: {launches}")
    check(after == before, f"{label}: the swap moved pool blocks")
    check(moved[1] >= 2 and out["migrations"] >= 1,
          f"{label}: no slot moved to replica 1")
    compare_streams(f"{label} vs one-shot gold", got,
                    {u: golds[u] for _, _, u in reqs}, gaps)
    return dict(**out, launches=launches)


def replan_parity_phase(dev, kernels):
    """Phase 4, live re-planning: f32 yi-6b at full width, 2 layers, on
    parity_phase's weights and staggered schedule (4 slots), with the
    ladder mono, ``uniform_plan(2, 2, n_microbatches=1)`` (narrow) and
    ``uniform_plan(2, 2, n_microbatches=4)`` (wide) at chunk 16.  Forced
    swaps mono -> narrow -> wide -> mono mid-traffic, dense, paged and
    paged overlapped, must give the one-shot gold's streams; paged swaps
    copy nothing, dense ones one row a migration.  A rebalance onto a
    2-replica plan with both active slots on replica 0 must move one slot
    by a block-table handoff (pool counters unchanged).  Swaps in the
    middle of a chunked prefill, narrow -> mono and narrow -> wide, must
    give the gold's streams (the old pipeline dropped when dry after
    mono).  Then each plan's ``measure_plan`` round-trip error at batch
    4 x 128 must stay below 1e-4."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.plan import lower_serving, uniform_plan
    from repro_torch.plan.validate import measure_plan
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(REGISTRY["yi-6b"], num_layers=2,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    v = cfg.vocab_size

    def toks(n):
        return rng.integers(1, v, n).astype(np.int32)

    prefix = toks(64)             # parity_phase's schedule, drawn alike
    sched = [(np.concatenate([prefix, toks(16)]), 4, 0),
             (toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
             (np.concatenate([prefix, toks(30)]), 10, 3),   # warm prefix
             (toks(70), 9, 5)]
    max_seq = 256
    golds, gaps = {}, {}
    for uid, (prompt, max_new, _) in enumerate(sched):
        golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                      max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    G = cfg.num_groups
    narrow = lower_serving(uniform_plan(G, 2, n_microbatches=1), slots=4,
                           chunk=16)
    wide = lower_serving(uniform_plan(G, 2, n_microbatches=4), slots=4,
                         chunk=16)
    swaps = [(2, narrow), (6, wide), (12, None)]
    flash = {"flash_attention": kernels["flash_attention"]}
    paged = {k: kernels[k] for k in ("fused_paged_decode", "paged_prefill")}
    pkw = dict(paged=True, page_size=16)
    out = {}
    for label, path, kw in (("dense", flash, {}), ("paged", paged, pkw),
                            ("paged overlap", paged,
                             dict(overlap=True, **pkw))):
        eng, got, launches = run_engine(
            f"f32 {label} mono -> narrow -> wide -> mono", model, params,
            sched, path, max_seq, 4, swaps=swaps, **kw)
        compare_streams(f"f32 {label} re-planned vs one-shot gold", got,
                        golds, gaps)
        st = eng.stats()
        out[label] = dict(launches=launches, **{
            k: st[k] for k in ("replans", "migrations", "migration_copies")})
        if kw:
            check(st["migration_copies"] == 0,
                  f"{label}: a paged swap copied {st['migration_copies']} "
                  f"rows")
        else:
            check(st["migration_copies"] == st["migrations"],
                  "dense: a migration did not move its row")

    out["rebalance"] = rebalance_run(
        "f32 paged rebalance", model, params,
        [(sched[1][0], sched[1][1], 1), (sched[3][0], sched[3][1], 3)],
        lower_serving(uniform_plan(G, 2, n_microbatches=2), slots=4,
                      chunk=16), paged, max_seq, golds, gaps)
    check(out["rebalance"]["migrations"] == 1
          and out["rebalance"]["migration_copies"] == 0,
          "paged rebalance: not one zero-copy migration")

    for to, target in (("mono", None), ("wide", wide)):
        label = f"f32 paged mid-prefill narrow -> {to}"
        eng = ServingEngine(model, params, slots=4, max_seq=max_seq,
                            plan=narrow, **pkw)
        finite = watch_all(eng, model, max_seq)
        for fn in paged.values():
            fn.launches = 0
        eng.submit(Request(1, sched[1][0], sched[1][1]))
        while eng._slot_req[0] is None:
            eng.tick()
        eng.submit(Request(2, sched[2][0], sched[2][1]))
        eng.tick()
        item = eng._pf.items[0] if eng._pf.items else None
        check(item is not None and item.next_chunk < len(item.chunks),
              f"{label}: the long prompt is not mid-prefill")
        at = item.next_chunk
        eng.replan(target)
        draining = eng._pf is not None and eng._pf.busy
        got = {r.uid: r for r in eng.run()}
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in paged.items()}
        print(f"[replan] {label}: swapped with {at} of "
              f"{len(item.chunks)} chunks injected; item runtime kept "
              f"{item.rt is not eng._rt}; old pipeline draining "
              f"{draining}, dropped when dry {eng._pf is None}; launches "
              f"{json.dumps(launches)}")
        check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
        check(all(n > 0 for n in launches.values()),
              f"{label}: a kernel of the path never launched: {launches}")
        check(to != "mono" or (draining and eng._pf is None),
              f"{label}: the old pipeline did not drain and drop")
        compare_streams(f"{label} vs one-shot gold", got,
                        {u: golds[u] for u in (1, 2)}, gaps)
        out[f"mid_prefill_{to}"] = launches

    # the measured side: each plan's stage round trip in f32
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(4).integers(1, v, (4, 128)), device=dev)}
    errs = {}
    for st_n, m in ((1, 1), (2, 1), (2, 2), (2, 4)):
        plan = uniform_plan(G, st_n, n_microbatches=m)
        meas = measure_plan(model, params, batch, plan, repeat=1)
        errs[f"{st_n}s x M{m}"] = meas["max_abs_err"]
        check(meas["max_abs_err"] < 1e-4,
              f"measure_plan {st_n} stages, M={m}: round-trip error "
              f"{meas['max_abs_err']:.3g}")
    print(f"[replan] f32 measure_plan round-trip max |logit error| at "
          f"4 x 128 (tolerance 1e-4): {json.dumps(errs)}")
    out["measure_plan_err"] = errs
    del eng, params
    torch.cuda.empty_cache()
    return out


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


HYBRID = "jamba-1.5-large-398b-dense-ffn"
LOGIT_TOL = 1e-3
# f32 logits of the paged path against Model.forward on the same tokens:
# the two sum in different orders (paged prefill + unfused decode kernels
# and per-step scans against flash attention and one scan over the whole
# sequence) through 8 layers of width 8192; logits are of order 1-10.


def hybrid_parity_phase(dev, kernels):
    """Phase 4, the hybrid: jamba-dense-ffn at full width cut to one
    period (8 layers: 7 mamba, 1 attention), f32.  A staggered schedule
    (one request sharing a 64-token prefix with an earlier one) through
    the dense and the paged engine must give the one-shot gold's streams;
    the warm admission must share the prefix's blocks without reusing
    their compute; a paged prefill + unfused decode must give the logits
    of ``Model.forward`` on the same tokens; and int8 pools must give the
    fp run's first tokens.  Then the same schedule through a 1-stage plan
    with 2 decode replicas and chunk 16 on the paged engine (chunked mamba:
    the selective scan from the state the previous chunk left; the unfused
    decode per replica) must give the gold's streams too, and so must the
    paged engine with ``overlap=True``."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.plan import lower_serving, uniform_plan
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(REGISTRY[HYBRID], num_layers=8,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    nparam = model.param_count(params)
    print(f"[parity] hybrid f32, 8 layers: {nparam / 1e9:.3f} B params, "
          f"{nparam * 4 / 1e9:.1f} GB")
    rng = np.random.default_rng(2)
    v = cfg.vocab_size

    def toks(n):
        return rng.integers(1, v, n).astype(np.int32)

    prefix = toks(64)
    sched = [(np.concatenate([prefix, toks(16)]), 4, 0),
             (toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
             (np.concatenate([prefix, toks(30)]), 10, 3),   # shares 4 blocks
             (toks(70), 9, 5)]
    max_seq = 256
    golds, gaps = {}, {}
    for uid, (prompt, max_new, _) in enumerate(sched):
        golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                      max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    streams = {}
    for label, kw in (("dense", {}),
                      ("paged fp", dict(paged=True, page_size=16)),
                      ("paged int8", dict(paged=True, page_size=16,
                                          kv_dtype="int8"))):
        eng = ServingEngine(model, params, slots=4, max_seq=max_seq, **kw)
        finite, _ = watch_engine(eng, model, max_seq)
        got = run_schedule(eng, sched, Request)
        check(bool(torch.stack(finite).all()), f"hybrid {label}: non-finite "
                                               f"logits")
        check(eng.prefill_bucket == 1, "the hybrid must prefill at the "
                                       "exact prompt length")
        streams[label] = {u: r.out_tokens for u, r in got.items()}
        if label == "paged int8":
            firsts = all(streams[label][u][0] == golds[u][0] for u in golds)
            agree = sum(streams[label][u] == golds[u] for u in golds)
            print(f"[parity] hybrid paged int8: first tokens equal the fp "
                  f"gold's: {firsts}; streams equal in full: {agree} of "
                  f"{len(golds)} (printed, not checked: int8 rounds K/V)")
            check(firsts, "hybrid int8: a first token differs from fp's")
            continue
        compare_streams(f"hybrid {label} vs one-shot gold", got, golds,
                        gaps)
        if label == "paged fp":
            st = eng.cache_stats()
            print(f"[parity] hybrid paged warm admission: prefix_hits "
                  f"{st['prefix_hits']}, prefill_compute_hits "
                  f"{st['prefill_compute_hits']}, reused tokens "
                  f"{st['reused_prefill_tokens']}")
            check(st["prefix_hits"] >= 4 and st["prefill_compute_hits"] == 0
                  and st["reused_prefill_tokens"] == 0,
                  "hybrid warm prefix: blocks must be shared without "
                  "compute reuse")

    splan = lower_serving(uniform_plan(cfg.num_groups, 1, n_microbatches=2),
                          slots=4, chunk=16)
    print(f"[plan] hybrid: {splan.describe()}")
    hybrid_path = {k: kernels[k] for k in ("mamba_scan_fused", "linear_scan",
                                           "paged_attention",
                                           "paged_prefill")}
    _, got, plan_launches = run_engine(
        "hybrid paged fp", model, params, sched, hybrid_path, max_seq,
        splan.slots, plan=splan, paged=True, page_size=16)
    compare_streams("hybrid plan paged fp vs one-shot gold", got, golds,
                    gaps)
    # the overlapped runtime on the hybrid: unfused decode and linear scan
    # dispatched a step ahead of the drain
    _, got, overlap_launches = run_engine(
        "hybrid paged fp overlap", model, params, sched, hybrid_path,
        max_seq, 4, paged=True, page_size=16, overlap=True)
    compare_streams("hybrid paged fp overlap vs one-shot gold", got, golds,
                    gaps)

    # a live re-plan: mono -> the 1-stage, 2-replica plan while both
    # active slots sit on replica 0 moves one slot, and its mamba state
    # (conv and SSM) is a dense row that is copied
    replan = rebalance_run(
        "hybrid f32 paged rebalance", model, params,
        [(sched[1][0], sched[1][1], 1), (sched[3][0], sched[3][1], 3)],
        splan, {k: hybrid_path[k] for k in ("paged_attention", "linear_scan",
                                            "mamba_scan_fused")},
        max_seq, golds, gaps)
    check(replan["migration_copies"] == replan["migrations"] >= 1,
          "hybrid rebalance: the migration did not copy its mamba row")

    # paged prefill + unfused decode against the full forward
    prompt, new = sched[2][0], 4
    nb = max_seq // 16
    cache = model.init_paged_cache(1, max_seq, page_size=16, num_blocks=nb)
    bt = np.arange(nb, dtype=np.int32)[None]
    logits, cache = model.prefill_suffix_paged(
        params, cache, prompt[None], 0, 0, len(prompt), max_seq, bt, bt)
    seq = list(prompt)
    worst = 0.0
    for step in range(new + 1):
        ref, _ = model.forward(params, {"tokens": np.asarray(seq)[None]})
        mine, ref = logits[0, -1], ref[0, -1]
        err = float((mine - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        worst = max(worst, err / scale)
        check(err <= LOGIT_TOL * scale,
              f"hybrid paged logits at step {step} differ from "
              f"Model.forward by {err:.3g} (scale {scale:.3g})")
        if step == new:
            break
        tok = int(mine.argmax())
        seq.append(tok)
        logits, cache = model.decode_step(
            params, cache, np.array([[tok]], np.int32),
            torch.tensor([len(seq) - 1], device=dev), block_tables=bt)
    print(f"[parity] hybrid paged prefill + {new} unfused decode steps vs "
          f"Model.forward: max |logit error| / max(1, max |logit|) = "
          f"{worst:.3g} (tolerance {LOGIT_TOL})")
    del params, cache
    torch.cuda.empty_cache()
    return dict(logit_rel_err=worst,
                int8_equal_fp_gold=sum(streams["paged int8"][u] == golds[u]
                                       for u in golds),
                plan_launches=plan_launches,
                overlap_launches=overlap_launches, replan=replan)


# (arch, layers: 0 = the published depth) of the family parity runs
GRANITE = "granite-moe-1b-a400m"
FAMILIES = (("qwen2-moe-a2.7b", 2), ("nemotron-4-15b", 2), ("yi-34b", 2),
            (GRANITE, 0))


def family_parity_phase(dev, kernels):
    """Phase 4, the MoE and non-llama dense families in f32 at published
    width: qwen2-moe-a2.7b (60 experts top-4 and a shared expert, G=1),
    nemotron-4-15b (LayerNorm, relu2, G=6) and yi-34b (G=7) at 2 layers,
    granite-moe-1b-a400m (32 experts top-8, tied head, head_dim 64, G=2)
    at its full 24.  parity-f32's staggered schedule (6 requests, one
    sharing a 64-token prefix) through the paged engine must give the
    one-shot gold's streams; a paged prefill + decode must give
    ``Model.forward``'s logits.  MoE engines, built with ``speculate=4``,
    must prefill at the exact prompt length, reuse no prefix compute and
    not speculate, and a plan engine (``uniform_plan(groups, 2)``, 2
    replicas, chunk 16) must prefill each prompt in one chunk and give the
    gold's streams.  Each also runs the schedule on int8 pools (the fused
    decode's int8 mode at G = 1, 6, 7 and 2): nemotron's and yi-34b's
    first tokens must equal the fp gold's; the MoE streams must be whole
    and finite (int8 K/V flips top-k routing choices, so they leave the
    fp gold).  (The MoE models' forward check runs at a
    drop-free capacity: a full forward's capacity drops differ from the
    drop-free decode steps'.)"""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.plan import lower_serving, uniform_plan
    out = {}
    path = {k: kernels[k] for k in ("fused_paged_decode", "paged_prefill")}
    for arch, layers in FAMILIES:
        base = REGISTRY[arch]
        cfg = dataclasses.replace(base, num_layers=layers or base.num_layers,
                                  dtype="float32", param_dtype="float32")
        moe = cfg.moe is not None
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(1))
        nparam = model.param_count(params)
        print(f"[parity] {arch} f32, {cfg.num_layers} layers: "
              f"{nparam / 1e9:.3f} B params, {nparam * 4 / 1e9:.1f} GB, "
              f"G={cfg.num_heads // cfg.num_kv_heads}, head_dim "
              f"{cfg.head_dim}")
        rng = np.random.default_rng(3)
        v = cfg.vocab_size

        def toks(m):
            return rng.integers(1, v, m).astype(np.int32)

        prefix = toks(64)
        sched = [(np.concatenate([prefix, toks(16)]), 4, 0),
                 (toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
                 (np.concatenate([prefix, toks(30)]), 10, 3),
                 (toks(70), 9, 5)]
        max_seq = 256
        golds, gaps = {}, {}
        for uid, (prompt, max_new, _) in enumerate(sched):
            golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                          max_seq)
            gaps[uid] = [top2_gap(x) for x in lgs]
        res = {}
        eng, got, res["launches"] = run_engine(
            f"{arch} paged fp", model, params, sched, path, max_seq, 4,
            paged=True, page_size=16, speculate=4 if moe else 0)
        compare_streams(f"{arch} paged fp vs one-shot gold", got, golds,
                        gaps)
        st = eng.cache_stats()
        print(f"[parity] {arch}: prefill_bucket {eng.prefill_bucket}, "
              f"suffix reuse {eng._suffix_reuse}, speculate "
              f"{eng._spec_k}, warm admissions "
              f"{st['prefill_compute_hits']} (prefix hits "
              f"{st['prefix_hits']})")
        if moe:
            check(eng.prefill_bucket == 1 and not eng._suffix_reuse
                  and eng._spec_k == 0 and st["prefill_compute_hits"] == 0,
                  f"{arch}: an MoE engine must prefill at the exact length, "
                  f"without compute reuse or speculation")
            splan = lower_serving(uniform_plan(cfg.num_groups, 2,
                                               n_microbatches=2),
                                  slots=4, chunk=16)
            peng, got, res["plan_launches"] = run_engine(
                f"{arch} plan paged fp", model, params, sched, path,
                max_seq, splan.slots, plan=splan, paged=True, page_size=16)
            compare_streams(f"{arch} plan paged fp vs one-shot gold", got,
                            golds, gaps)
            res["plan_chunks"] = peng.prefill_chunk_counts
            check(peng.prefill_chunk_counts == [1] * len(sched),
                  f"{arch}: the plan engine chunked an MoE prefill: "
                  f"{peng.prefill_chunk_counts}")
            del peng
        else:
            check(st["prefill_compute_hits"] >= 1,
                  f"{arch}: the warm prefix reused no compute")
        _, got, res["int8_launches"] = run_engine(
            f"{arch} paged int8", model, params, sched, path, max_seq, 4,
            paged=True, page_size=16, kv_dtype="int8")
        firsts = all(got[u].out_tokens[0] == golds[u][0] for u in golds)
        agree = sum(got[u].out_tokens == golds[u] for u in golds)
        print(f"[parity] {arch} paged int8: first tokens equal the fp "
              f"gold's: {firsts}; streams equal in full: {agree} of "
              f"{len(golds)} (printed, not checked: int8 rounds K/V)")
        if moe:
            # int8 K/V moves the router's inputs, and one flipped top-k
            # choice moves the logits past far more than a near tie: the
            # plain versions on the CPU leave the fp gold as far, so the
            # MoE streams are held to be whole and finite only
            check(all(len(got[u].out_tokens) == sched[u][1] for u in golds),
                  f"{arch} int8: a stream ended short")
        else:
            check(firsts, f"{arch} int8: a first token differs from fp's")
        del eng

        # paged prefill + decode against the full forward.  A forward over
        # n tokens routes them at capacity ceil(1.25 n / E) per round,
        # which can drop tokens that the drop-free decode steps keep; so
        # MoE models run this check at a drop-free capacity factor (E: a
        # round's capacity is n), on the same weights
        if moe:
            model = build_model(dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(cfg.moe.num_experts))),
                device=dev)
        prompt, new = sched[2][0], 4
        nb = max_seq // 16
        cache = model.init_paged_cache(1, max_seq, page_size=16,
                                       num_blocks=nb)
        bt = np.arange(nb, dtype=np.int32)[None]
        logits, cache = model.prefill_suffix_paged(
            params, cache, prompt[None], 0, 0, len(prompt), max_seq, bt, bt)
        seq = list(prompt)
        worst = 0.0
        for step in range(new + 1):
            ref, aux = model.forward(params,
                                     {"tokens": np.asarray(seq)[None]})
            mine, ref = logits[0, -1], ref[0, -1]
            err = float((mine - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            worst = max(worst, err / scale)
            check(err <= LOGIT_TOL * scale,
                  f"{arch} paged logits at step {step} differ from "
                  f"Model.forward by {err:.3g} (scale {scale:.3g})")
            if step == new:
                break
            tok = int(mine.argmax())
            seq.append(tok)
            logits, cache = model.decode_step(
                params, cache, np.array([[tok]], np.int32),
                torch.tensor([len(seq) - 1], device=dev), block_tables=bt)
        res["logit_rel_err"] = worst
        res["aux"] = float(aux)
        check(bool(torch.isfinite(aux)) and (float(aux) > 0) == moe,
              f"{arch}: forward's aux loss {float(aux)}")
        print(f"[parity] {arch} paged prefill + {new} decode steps vs "
              f"Model.forward{' (drop-free capacity)' if moe else ''}: max "
              f"|logit error| / max(1, max |logit|) = {worst:.3g} "
              f"(tolerance {LOGIT_TOL}); forward aux {float(aux):.6g}")
        out[arch] = res
        del params, cache, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


GEMMA2_PARITY_LAYERS = 4      # two (local, global) groups: the 2-stage plan


def gemma2_parity_phase(dev, kernels):
    """Phase 4, gemma2-9b in f32 at published width and 4 layers (two
    (local, global) periods, so that a 2-stage plan has a group a stage;
    1.71 B parameters, 6.8 GB), on prompts of 4,000-4,600 tokens: the
    prefills of the prompts past 4,096 tokens wrap the 4,096-row rings
    and mask with the window, and the 4,090-token prompt crosses position
    4,096 while it decodes.  The dense and the paged engine (4 slots, page
    16; built with ``speculate=4``, which gemma2's rings turn off) must
    give the one-shot gold's streams (dense prefill through flash with the
    window, lock-step decode); int8 pools must give whole, finite streams
    with the rings kept in f32 at 4,096 rows; a 2-stage plan (2 replicas,
    chunk 256) must prefill each prompt longer than the ring in one
    chunk, as JAX's plan path does, the others in chunks of 256 that
    continue over the ring, and give the gold's streams.
    Every kernel of each run's path must launch: flash (every dense
    prefill, the local layers' paged one), the unfused decode (the local
    layers' per-slot decode over the ring view) and, paged, the paged
    prefill and the fused decode (the global layers')."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.plan import lower_serving, uniform_plan
    cfg = dataclasses.replace(REGISTRY[GEMMA2],
                              num_layers=GEMMA2_PARITY_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    nparam = model.param_count(params)
    print(f"[parity] {GEMMA2} f32, {cfg.num_layers} layers: "
          f"{nparam / 1e9:.3f} B params, {nparam * 4 / 1e9:.2f} GB, window "
          f"{cfg.window_size}, softcaps {cfg.attn_logit_softcap:g} / "
          f"{cfg.final_logit_softcap:g}, head_dim {cfg.head_dim}")
    rng = np.random.default_rng(4)

    def toks(m):
        return rng.integers(1, cfg.vocab_size, m).astype(np.int32)

    sched = [(toks(4090), 12, 0), (toks(4100), 8, 0), (toks(4600), 6, 0),
             (toks(4000), 10, 1), (toks(4333), 5, 2)]
    max_seq = 4672
    golds, gaps = {}, {}
    for uid, (prompt, max_new, _) in enumerate(sched):
        golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                      max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    out = {}
    dense_path = {k: kernels[k] for k in ("flash_attention",
                                          "paged_attention")}
    paged_path = {k: kernels[k] for k in ("flash_attention", "paged_prefill",
                                          "fused_paged_decode",
                                          "paged_attention")}
    eng, got, out["dense_launches"] = run_engine(
        f"{GEMMA2} dense f32", model, params, sched, dense_path, max_seq, 4,
        speculate=4)
    compare_streams(f"{GEMMA2} dense f32 vs one-shot gold", got, golds,
                    gaps)
    check(eng._ring_min == cfg.window_size and eng._spec_k == 0,
          f"{GEMMA2}: the dense engine's ring guard or speculation gate")
    eng, got, out["launches"] = run_engine(
        f"{GEMMA2} paged f32", model, params, sched, paged_path, max_seq, 4,
        paged=True, page_size=16, speculate=4)
    compare_streams(f"{GEMMA2} paged f32 vs one-shot gold", got, golds,
                    gaps)
    check(not eng._suffix_reuse and eng._spec_k == 0,
          f"{GEMMA2}: the paged engine reused prefix compute or speculated")
    eng, got, out["int8_launches"] = run_engine(
        f"{GEMMA2} paged int8", model, params, sched, paged_path, max_seq, 4,
        paged=True, page_size=16, kv_dtype="int8")
    ring = eng._cache["b0"]["kv"]["k"]
    print(f"[parity] {GEMMA2} paged int8: local rings {tuple(ring.shape)} "
          f"{str(ring.dtype)[6:]}, global pools "
          f"{str(eng._cache['b1']['kv']['k_pages'].dtype)[6:]}")
    check(ring.dtype == torch.float32 and ring.shape[2] == cfg.window_size,
          f"{GEMMA2} int8: the rings are not f32 rows of the window")
    check(all(len(got[u].out_tokens) == sched[u][1] for u in golds),
          f"{GEMMA2} int8: a stream ended short")
    firsts = all(got[u].out_tokens[0] == golds[u][0] for u in golds)
    agree = sum(got[u].out_tokens == golds[u] for u in golds)
    print(f"[parity] {GEMMA2} paged int8: first tokens equal the fp gold's: "
          f"{firsts}; streams equal in full: {agree} of {len(golds)} "
          f"(printed, not checked: int8 rounds K/V)")
    del eng
    splan = lower_serving(uniform_plan(cfg.num_groups, 2, n_microbatches=2),
                          slots=4, chunk=256)
    peng, got, out["plan_launches"] = run_engine(
        f"{GEMMA2} plan paged f32", model, params, sched, paged_path,
        max_seq, splan.slots, plan=splan, paged=True, page_size=16)
    compare_streams(f"{GEMMA2} plan paged f32 vs one-shot gold", got, golds,
                    gaps)
    out["plan_chunks"] = peng.prefill_chunk_counts
    # a prompt longer than the ring wraps it in one chunk; a shorter one
    # streams in chunks of 256 (continuations over the ring)
    want = [1 if len(p) > cfg.window_size else -(-len(p) // splan.chunk)
            for p, _, _ in sched]
    print(f"[parity] {GEMMA2} plan: chunks per admission "
          f"{peng.prefill_chunk_counts} (prompt lengths "
          f"{[len(p) for p, _, _ in sched]})")
    check(peng.prefill_chunk_counts == want,
          f"{GEMMA2}: the plan's chunks {peng.prefill_chunk_counts} are not "
          f"{want} (one chunk a prompt longer than the ring)")
    del peng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def serve_run(label, model, params, prompts, kernels, new=64, max_seq=1024,
              **engine_kw):
    """Serve ``prompts`` at full size, the kernels' launch counters set to
    0 just before and read just after, and the peak device memory over
    the serve.  Returns (engine, results)."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(model, params, slots=4, max_seq=max_seq, paged=True,
                        page_size=16, **engine_kw)
    gaps = {}
    if eng.plan is not None:
        finite = watch_plan_engine(eng)
    else:
        finite, gaps = watch_engine(eng, model, max_seq)
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
    # the watch wrappers make engine <-> closure cycles: collect them, so
    # that no earlier phase's weights stay allocated into this peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, new))
    done = {r.uid: r for r in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in kernels.items()}
    st = eng.stats()
    cs = st["cache"]           # a dense engine (xlstm) has no pool keys
    ttft = sorted(st["ttft_s"])
    # the first wave: the requests admitted into the 4 empty slots
    wave = sorted(done[u].t_first - done[u].t_submit for u in range(4))
    tick = st["phase_time_s"]["decode"] / max(st["decode_steps"], 1)
    print(f"[serve] {label}: {len(done)} requests, {st['gen_tokens']} "
          f"tokens in {wall:.3f} s: {st['gen_tokens'] / wall:.2f} tok/s; "
          f"TTFT p50 {ttft[len(ttft) // 2]:.4f} s, max {ttft[-1]:.4f} s; "
          f"decode steps {st['decode_steps']}, tick {tick * 1e3:.2f} ms; "
          f"warm admissions {cs.get('prefill_compute_hits', 0)} (reused "
          f"{cs.get('reused_prefill_tokens', 0)} tokens); layout "
          f"{cs['layout']}")
    print(f"[serve] {label}: spec steps {st['spec_steps']}, "
          f"acceptance_rate {st['acceptance_rate']:.4f}, tokens_per_step "
          f"{st['tokens_per_step']:.4f}, kv {cs.get('kv_dtype', 'dense')} "
          f"kv_capacity_x {cs.get('kv_capacity_x', 1.0):.4f}; drafting "
          f"{draft_s[0]:.4f} s of host time")
    print(f"[serve] {label}: phase_time_s {json.dumps(st['phase_time_s'])}; "
          f"runtime {'overlap' if eng._overlap else 'sync'}")
    print(f"[serve] {label}: prefill phase "
          f"{st['phase_time_s']['prefill']:.4f} s; first-wave TTFT "
          f"{json.dumps([round(t, 4) for t in wave])} s; peak device memory "
          f"{peak:.3f} GB")
    print(f"[serve] {label}: launches on the path: {json.dumps(launches)}")
    check(len(done) == len(prompts)
          and all(len(done[u].out_tokens) == new for u in done),
          f"{label}: not every request finished its {new} tokens")
    check(bool(torch.stack(finite).all()), f"{label}: non-finite logits")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a kernel of the path never launched: {launches}")
    return eng, dict(
        launches=launches, tok_s=st["gen_tokens"] / wall, wall_s=wall,
        ttft_s=ttft, first_wave_ttft_s=wave, peak_memory_gb=peak,
        phase_time_s=st["phase_time_s"], tick_s=tick,
        prefill_chunk_counts=eng.prefill_chunk_counts,
        draft_s=draft_s[0],
        decode_steps=st["decode_steps"], cache=st["cache"],
        spec={k: st[k] for k in ("spec_steps", "spec_proposed",
                                 "spec_accepted", "acceptance_rate",
                                 "tokens_per_step")},
        utilization=st["utilization"],
        first_tokens=[done[u].out_tokens[0] for u in sorted(done)],
        streams={u: done[u].out_tokens for u in sorted(done)}, gaps=gaps)


def dispatch_without_sync(label, eng, prompts, request_cls):
    """One overlapped decode dispatch of a served engine under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync anywhere in
    it (a blocking copy, a read of a device value) raises, and the check
    fails.  Four short requests give the step its slots."""
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(300 + uid, p[:100], 8))
    while not (eng.active and eng._inflight):
        eng.tick()
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._dispatch_decode()
    except RuntimeError as e:
        err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[syncs] {label}: one overlapped dispatch ({eng.active} active "
          f"slots) under sync debug mode 'error': "
          f"{'no host sync' if err is None else err}")
    check(err is None, f"{label}: the overlapped dispatch synced the host")
    eng.run()


def syncs_per_tick(label, eng, prompts, request_cls):
    """Host syncs a decode tick, counted by
    ``torch.cuda.set_sync_debug_mode("warn")`` over a window of four
    requests of 16 tokens (admitted before the window), with the Python
    line that each sync came from.  Waits on a CUDA event (the overlapped
    drain's) are not what the mode counts.  Printed, not checked."""
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(200 + uid, p[:100], 16))
    while eng.queue or (eng._pf is not None and eng._pf.busy):
        eng.tick()
    torch.cuda.synchronize()
    ticks = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            busy = True
            while busy:
                busy = eng.tick()
                ticks += 1
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    n = sum(sites.values())
    print(f"[syncs] {label}: {n} host syncs in {ticks} decode ticks "
          f"({n / ticks:.2f} a tick); by site "
          f"{json.dumps(sites.most_common(8))}")
    return dict(syncs=n, ticks=ticks, per_tick=n / ticks,
                sites=dict(sites.most_common(8)))


def trace_window(label, eng, prompts, request_cls):
    """Trace a short served window of a served engine (tracing enabled
    mid-serve) and write its Perfetto JSON to ``chiprun_out/``; the
    object must validate with the window's spans present."""
    from repro_torch.obs import to_perfetto, validate_perfetto
    tr = eng.enable_trace()
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(400 + uid, p[:100], 16))
    eng.run()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{label}_trace.json")
    eng.write_trace(path)
    with open(path) as f:
        obj = json.load(f)
    names = ("prefill" if eng.plan is None else "prefill_chunk", "admit",
             "retire", "submit",
             *(("decode_dispatch", "drain") if eng._overlap else
               ("decode",)))
    problems = validate_perfetto(obj, require_names=names)
    print(f"[trace] {label}: {tr.events} records ({tr.dropped} dropped) "
          f"written to chiprun_out/{label}_trace.json; problems {problems}")
    check(not problems and len(obj["traceEvents"])
          == len(to_perfetto(tr)["traceEvents"]),
          f"{label}: the trace file does not validate: {problems}")
    return dict(records=tr.events, path=f"chiprun_out/{label}_trace.json")


def print_overlap(name, ov, base):
    """An overlapped serve's numbers beside its sync run's."""
    def p50(t):
        return t[len(t) // 2]
    rows = [("tok/s", ov["tok_s"], base["tok_s"], ""),
            ("TTFT p50", p50(ov["ttft_s"]), p50(base["ttft_s"]), " s"),
            ("TTFT max", ov["ttft_s"][-1], base["ttft_s"][-1], " s"),
            ("prefill phase", ov["phase_time_s"]["prefill"],
             base["phase_time_s"]["prefill"], " s"),
            ("host tick", ov["tick_s"] * 1e3, base["tick_s"] * 1e3, " ms"),
            ("host_sync bucket", ov["phase_time_s"]["host_sync"],
             base["phase_time_s"]["host_sync"], " s"),
            ("device busy share", ov["profile"]["busy_share"],
             base["profile"]["busy_share"], ""),
            ("device ms per tick", sum(ov["profile"]["per_tick_ms"].values()),
             sum(base["profile"]["per_tick_ms"].values()), " ms"),
            ("peak device memory", ov["peak_memory_gb"],
             base["peak_memory_gb"], " GB"),
            ("warm admissions", ov["cache"]["prefill_compute_hits"],
             base["cache"]["prefill_compute_hits"], ""),
            ("reused prefix tokens", ov["cache"]["reused_prefill_tokens"],
             base["cache"]["reused_prefill_tokens"], "")]
    for key, a, b, unit in rows:
        ratio = f" ({a / b:.3f}x)" if b else ""
        print(f"[serve] {name}, {key}: {a:.4f} vs {b:.4f}{unit}{ratio}")


def design_points_phase(dev, model, params, cfg):
    """Phase 5, measured design points: full-size yi-6b (bf16) on one
    batch of 4 x 128 tokens.  ``measured_design_points`` for a 1-stage
    plan and 2-stage uniform plans at M = 1, 2, 4 (host wall seconds to
    the device's completion), each beside ``predict_plan(hw=H100)``; then
    the spatial width that ``lower(n_microbatches="auto", measure_with=
    ...)`` picks for the 2-stage ``ssr_dse`` cut."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import build_graph, ssr_dse
    from repro_torch.core.assignment import contiguous_assignment
    from repro_torch.core.hw import H100
    from repro_torch.plan import lower, uniform_plan
    from repro_torch.plan.validate import measured_design_points, \
        predict_plan
    t0 = time.perf_counter()
    G = cfg.num_groups
    graph = build_graph(cfg, ShapeConfig("measure", 128, 4, "prefill"))
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(5).integers(1, cfg.vocab_size, (4, 128)),
        device=dev)}
    plans = [uniform_plan(G, 1, n_microbatches=1)] + [
        uniform_plan(G, 2, n_microbatches=m) for m in (1, 2, 4)]
    pts = measured_design_points(model, params, batch, graph, plans)
    rows = []
    for plan, pt in zip(plans, pts):
        pred = predict_plan(plan, graph, hw=H100)
        rows.append(dict(
            plan=f"{plan.n_stages} stages x M{plan.total_microbatches}",
            strategy=pt.strategy, measured_latency_s=pt.latency,
            measured_tflops=pt.throughput_tops, detail=pt.detail,
            predicted_latency_s=pred["latency_s"],
            predicted_makespan_s=pred["makespan_s"],
            predicted_tflops=pred["throughput_tops"]))
        print(f"[points] {rows[-1]['plan']} ({pt.strategy}): measured "
              f"makespan {pt.latency:.6f} s, {pt.throughput_tops:.3f} "
              f"TFLOP/s ({pt.detail}); predict_plan(hw=H100) makespan "
              f"{pred['makespan_s']:.6f} s, latency {pred['latency_s']:.6f}"
              f" s, {pred['throughput_tops']:.3f} TFLOP/s")
        check(pt.source == "measured" and pt.latency > 0
              and np.isfinite(pt.throughput_tops),
              f"design point {rows[-1]['plan']}: {pt}")
    _, _, assign = ssr_dse(graph, contiguous_assignment(graph, 2, 8).acc_of,
                           8, n_batches=2)
    auto = lower(assign, graph, mesh_devices=8, n_microbatches="auto",
                 measure_with=(model, params, batch))
    print(f"[points] lower(n_microbatches='auto', measure_with=...) on the "
          f"{auto.n_stages}-stage ssr_dse cut (groups "
          f"{[(st.first_group, st.n_groups) for st in auto.stages]}): "
          f"M={auto.n_microbatches}")
    check(4 % auto.n_microbatches == 0, f"auto width {auto.n_microbatches}")
    secs = time.perf_counter() - t0
    print(f"[points] phase {secs:.1f} s")
    return dict(rows=rows, auto_m=auto.n_microbatches, seconds=secs)


def serve_adapt_run(dev, model, params, cfg, prompts, kernels, fp, pl):
    """Phase 5, serve-adapt: serve-full's model, weights, engine and
    prompts with ``adapt=AdaptiveConfig(plans=_adaptive_ladder(cfg, None,
    4, 128))`` (measured profiles).  ``warm_replans()`` then
    ``reset_stats()``; the 8 prompts as one burst, and when they are
    drained a tail of 8 requests of 16 prompt and 16 new tokens, one every
    ``interval_ticks`` ticks.  Every request must retire with its budget,
    every logit be finite, the controller score at least once, no swap
    copy a row, and the path's kernels launch.  Its numbers print beside
    serve-full's and serve-plan's."""
    from repro_torch.launch.serve import _adaptive_ladder
    from repro_torch.serving import AdaptiveConfig, Request, ServingEngine
    t_phase = time.perf_counter()
    adapt = AdaptiveConfig(plans=_adaptive_ladder(cfg, None, 4, 128))
    eng = ServingEngine(model, params, slots=4, max_seq=1024, paged=True,
                        page_size=16, adapt=adapt)
    finite = watch_all(eng, model, 1024)
    ctl = eng._ctl
    scored = [0]
    observe = ctl.observe

    def counted(e):
        decision = observe(e)
        scored[0] += ctl.last_scores is not None
        return decision
    ctl.observe = counted
    t0 = time.perf_counter()
    eng.warm_replans()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    eng.reset_stats()
    profiles = {(c.label if c is not None else "mono"): dataclasses.asdict(
        ctl._profiles[c]) for c in ctl.cfg.plans}
    for label, prof in profiles.items():
        print(f"[adapt] profile {label}: prefill_tok_s "
              f"{prof['prefill_tok_s']:.6f}, first_latency_s "
              f"{prof['first_latency_s']:.6f}, decode_tick_s "
              f"{prof['decode_tick_s']:.6f}, interfere_s "
              f"{prof['interfere_s']:.6f} (measured {prof['measured']})")
    print(f"[adapt] warm_replans {warm_s:.2f} s (probes and one request "
          f"per candidate)")
    for fn in kernels.values():
        fn.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, 64))
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    burst = eng.stats()
    n_dec = len(ctl.decisions)
    # the tail: short requests trickling in after the burst
    rng = np.random.default_rng(6)
    tail = [rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
            for _ in range(8)]
    t1 = time.perf_counter()
    tick, i, busy = 0, 0, True
    while i < len(tail) or busy:
        if i < len(tail) and tick % adapt.interval_ticks == 0:
            eng.submit(Request(100 + i, tail[i], 16))
            i += 1
        busy = eng.tick()
        tick += 1
    torch.cuda.synchronize()
    tail_wall = time.perf_counter() - t1
    st = eng.stats()
    launches = {name: fn.launches for name, fn in kernels.items()}
    done = {r.uid: r for r in eng.done}
    ttft = sorted(burst["ttft_s"])
    tail_ttft = sorted(done[100 + j].t_first - done[100 + j].t_submit
                       for j in range(len(tail)))
    tick_s = burst["phase_time_s"]["decode"] / max(burst["decode_steps"], 1)
    tail_gen = st["gen_tokens"] - burst["gen_tokens"]
    res = dict(
        profiles=profiles, warm_s=warm_s, decisions=list(ctl.decisions),
        burst_decisions=n_dec, scored_ticks=scored[0],
        replans=st["replans"], migrations=st["migrations"],
        migration_copies=st["migration_copies"],
        tok_s=burst["gen_tokens"] / wall, wall_s=wall, ttft_s=ttft,
        tick_s=tick_s, phase_time_s=burst["phase_time_s"],
        tail_tok_s=tail_gen / tail_wall, tail_ttft_s=tail_ttft,
        tail_ticks=tick, final_plan=st["plan_label"], launches=launches)
    print(f"[adapt] decisions (tick, from, to): {ctl.decisions} "
          f"({n_dec} in the burst); scored ticks {scored[0]}; replans "
          f"{st['replans']}, migrations {st['migrations']} (copies "
          f"{st['migration_copies']}); ends on {st['plan_label']}")
    print(f"[adapt] burst: {burst['requests']} requests, "
          f"{burst['gen_tokens']} tokens in {wall:.3f} s; "
          f"phase_time_s {json.dumps(burst['phase_time_s'])}")
    print(f"[adapt] tail: {len(tail)} requests of 16 + 16 tokens, one "
          f"every {adapt.interval_ticks} ticks: {tail_gen} tokens in "
          f"{tail_wall:.3f} s ({tick} ticks), {tail_gen / tail_wall:.2f} "
          f"tok/s; TTFT p50 {tail_ttft[len(tail_ttft) // 2]:.4f} s, max "
          f"{tail_ttft[-1]:.4f} s")
    print(f"[adapt] launches on the path: {json.dumps(launches)}")

    def p50(t):
        return t[len(t) // 2]
    for key, a, b, c, unit in (
            ("tok/s", res["tok_s"], fp["tok_s"], pl["tok_s"], ""),
            ("TTFT p50", p50(ttft), p50(fp["ttft_s"]), p50(pl["ttft_s"]),
             " s"),
            ("TTFT max", ttft[-1], fp["ttft_s"][-1], pl["ttft_s"][-1], " s"),
            ("decode tick, host", tick_s * 1e3, fp["tick_s"] * 1e3,
             pl["tick_s"] * 1e3, " ms")):
        print(f"[serve] serve-adapt vs serve-full vs serve-plan ("
              f"{SERVE_PLAN_LAYERS} layers), {key}: "
              f"{a:.4f} vs {b:.4f} vs {c:.4f}{unit}")
    check(len(done) == len(prompts) + len(tail)
          and all(len(done[u].out_tokens) == 64 for u in range(len(prompts)))
          and all(len(done[100 + j].out_tokens) == 16
                  for j in range(len(tail))),
          "serve-adapt: not every request finished its budget")
    check(bool(torch.stack(finite).all()), "serve-adapt: non-finite logits")
    check(scored[0] >= 1, "serve-adapt: the controller never scored")
    check(st["migration_copies"] == 0,
          f"serve-adapt: {st['migration_copies']} rows copied on paged "
          f"yi-6b")
    check(all(n > 0 for n in launches.values()),
          f"serve-adapt: a kernel of the path never launched: {launches}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[adapt] serve-adapt {res['seconds']:.1f} s")
    del eng
    torch.cuda.empty_cache()
    return res


def lap_timer(prefix):
    """``lap(label)``: prints and keeps (``lap.times``) the wall seconds
    since the previous lap, or since the timer was made."""
    last = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        lap.times[label] = now - last[0]
        last[0] = now
        print(f"{prefix} {label} {lap.times[label]:.1f} s")
    lap.times = {}
    return lap


# serve-int8-spec's depth: 16 of yi-6b's 32 layers, for the smoke's time
# (at 32 it was the slowest cell with serve-plan's two)
SERVE_INT8_SPEC_LAYERS = 16
# serve-plan's and serve-plan-overlap's depth: 16 of 32, for the smoke's
# time (at 32 they were its slowest cells)
SERVE_PLAN_LAYERS = 16


def serve_phase(dev, kernels):
    """Phase 5: full-size yi-6b bf16 served on the same weights -- the fp
    paged engine (serve-full, then one full-size forward through the
    flash kernel), overlapped, under a plan, adaptive, and the paged
    engine with int8 pools and speculate=4 on prompts that repeat a
    segment (``SERVE_INT8_SPEC_LAYERS`` deep: the first groups of the
    same weights)."""
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
    lap = lap_timer("[serve] cell")
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
    unwatch(eng)
    syncs = {"serve-full": syncs_per_tick("serve-full", eng, prompts[4:],
                                          Request)}
    del eng
    torch.cuda.empty_cache()
    lap("serve-full")

    # serve-overlap: serve-full's model, requests and engine, overlapped
    paged = {k: kernels[k] for k in ("fused_paged_decode", "paged_prefill")}
    eng, ov = serve_run("fp paged overlap", model, params, prompts, paged,
                        overlap=True)
    ov["profile"] = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    dispatch_without_sync("serve-overlap", eng, prompts[4:], Request)
    syncs["serve-overlap"] = syncs_per_tick("serve-overlap", eng,
                                            prompts[4:], Request)
    ov["trace"] = trace_window("serve_overlap", eng, prompts[4:], Request)
    print_overlap("serve-overlap vs serve-full", ov, fp)
    compare_streams("serve-overlap vs serve-full (bf16)", ov["streams"],
                    fp["streams"], fp["gaps"])
    del eng
    torch.cuda.empty_cache()
    lap("serve-overlap")

    # serve-plan: the same model (its first SERVE_PLAN_LAYERS layers),
    # requests and engine under the launcher's --strategy hybrid:2
    # --replicas 2 --chunk 128 (stages and replicas share the card)
    from repro_torch.launch.serve import _build_serving_plan
    # at SERVE_PLAN_LAYERS: the first groups of the same weights (no copy)
    pmodel = build_model(dataclasses.replace(
        cfg, num_layers=SERVE_PLAN_LAYERS), device=dev)
    pparams = {**params, "stack": params["stack"][:SERVE_PLAN_LAYERS]}
    splan = _build_serving_plan(pmodel.cfg, "hybrid:2", 4, 2, 128, 1024)
    print(f"[serve] plan hybrid:2:\n{splan.describe()}")
    def chunk_kind(q, kp, vp, bt, offset, *_):     # q (B, S, H, D)
        s = q.shape[1]
        return (f"{'S=128' if s == 128 else 'S<128'} at "
                f"{'offset 0' if int(offset) == 0 else 'offset > 0'}")
    with tally_calls("dispatch_paged_prefill_attention",
                     chunk_kind) as chunk_shapes:
        eng, pl = serve_run("plan hybrid:2 paged", pmodel, pparams, prompts,
                            {k: kernels[k] for k in ("fused_paged_decode",
                                                     "paged_prefill")},
                            plan=splan)
    pl["prefill_shapes"] = dict(chunk_shapes)
    pl["prefill_continuations"] = sum(
        n for k, n in chunk_shapes.items() if k.endswith("offset > 0"))
    print(f"[serve] plan hybrid:2 paged: paged-prefill launches by chunk "
          f"{json.dumps(dict(sorted(chunk_shapes.items())))}")
    pl["plan"] = splan.describe()
    pl["profile"] = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    syncs["serve-plan"] = syncs_per_tick("serve-plan", eng, prompts[4:],
                                         Request)
    for key, unit in (("tok_s", ""), ("tick_s", " s"), ("peak_memory_gb",
                                                         " GB")):
        print(f"[serve] serve-plan ({SERVE_PLAN_LAYERS} layers) vs "
              f"serve-full ({cfg.num_layers}), {key}: {pl[key]:.4f} vs "
              f"{fp[key]:.4f}{unit}")
    print(f"[serve] serve-plan ({SERVE_PLAN_LAYERS} layers) vs serve-full "
          f"({cfg.num_layers}), TTFT p50/max: "
          f"{pl['ttft_s'][len(pl['ttft_s']) // 2]:.4f}/{pl['ttft_s'][-1]:.4f}"
          f" vs {fp['ttft_s'][len(fp['ttft_s']) // 2]:.4f}/"
          f"{fp['ttft_s'][-1]:.4f} s; prefill phase "
          f"{pl['phase_time_s']['prefill']:.4f} vs "
          f"{fp['phase_time_s']['prefill']:.4f} s; device ms per decode "
          f"tick {pl['profile']['per_tick_ms']['gemm']:.4f} (gemm) of "
          f"{sum(pl['profile']['per_tick_ms'].values()):.4f} vs "
          f"{fp['profile']['per_tick_ms']['gemm']:.4f} of "
          f"{sum(fp['profile']['per_tick_ms'].values()):.4f}")
    del eng
    torch.cuda.empty_cache()
    lap("serve-plan")

    # serve-plan-overlap: serve-plan, overlapped
    eng, plo = serve_run("plan hybrid:2 paged overlap", pmodel, pparams,
                         prompts, paged, plan=splan, overlap=True)
    plo["profile"] = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    dispatch_without_sync("serve-plan-overlap", eng, prompts[4:], Request)
    syncs["serve-plan-overlap"] = syncs_per_tick(
        "serve-plan-overlap", eng, prompts[4:], Request)
    print_overlap("serve-plan-overlap vs serve-plan", plo, pl)
    compare_streams("serve-plan-overlap vs serve-plan (bf16)",
                    plo["streams"], pl["streams"], {})
    del eng
    torch.cuda.empty_cache()
    lap("serve-plan-overlap")

    points = design_points_phase(dev, model, params, cfg)
    lap("design points")
    adapt = serve_adapt_run(dev, model, params, cfg, prompts, paged, fp, pl)
    lap("serve-adapt")

    int8_kernels = {"fused_paged_decode_int8": kernels["fused_paged_decode"],
                    "paged_prefill_int8": kernels["paged_prefill"],
                    "paged_verify": kernels["paged_verify"]}
    prompts = serve_prompts(cfg, 1, repeat_segment=True)
    # serve-int8-spec at SERVE_INT8_SPEC_LAYERS: the first groups of the
    # same weights (no copy)
    model = build_model(dataclasses.replace(
        cfg, num_layers=SERVE_INT8_SPEC_LAYERS), device=dev)
    params = {**params, "stack": params["stack"][:SERVE_INT8_SPEC_LAYERS]}
    eng, q8 = serve_run("int8 speculate=4", model, params, prompts,
                        int8_kernels, kv_dtype="int8", speculate=4)
    q8["profile"] = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    syncs["serve-int8-spec"] = syncs_per_tick("serve-int8-spec", eng,
                                              prompts[4:], Request)
    lap("serve-int8-spec")
    return dict(fp=fp, int8_spec=q8, plan=pl, overlap=ov, plan_overlap=plo,
                points=points, adapt=adapt, syncs=syncs, cell_s=lap.times,
                launches={**fp["launches"], **q8["launches"]})


def serve_hybrid_phase(dev, kernels):
    """Phase 5, serve-hybrid: jamba-dense-ffn at full width, 16 layers
    (2 periods: 14 mamba, 2 attention), bf16, random weights from
    ``torch.Generator`` seed 0, served by the paged engine with
    serve-full's engine size and request shape; then a profiled decode
    window."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    cfg = dataclasses.replace(REGISTRY[HYBRID], num_layers=16)
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    print(f"[serve] {HYBRID} bf16, 16 layers: {nparam / 1e9:.3f} B params, "
          f"{nparam * 2 / 1e9:.1f} GB, init {time.perf_counter() - t0:.1f} s")
    for fn in kernels.values():
        fn.launches = 0
    path = {k: kernels[k] for k in ("paged_attention", "linear_scan",
                                    "mamba_scan_fused", "paged_prefill")}
    prompts = serve_prompts(cfg, 0, repeat_segment=False)
    eng, hy = serve_run("hybrid paged", model, params, prompts, path)
    check(eng.prefill_bucket == 1 and not eng._suffix_reuse
          and eng._spec_k == 0, "the hybrid engine must prefill at the "
          "exact length, without compute reuse or speculation")
    hy["profile"] = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    hy["syncs"] = syncs_per_tick("serve-hybrid", eng, prompts[4:], Request)
    return hy


# serve-moe's and serve-nemotron's depths: half their layers (24 and 32),
# for the smoke's time
SERVE_FAMILY_LAYERS = {"qwen2-moe-a2.7b": 12, "nemotron-4-15b": 16}


def serve_family_phase(dev, kernels, arch, label):
    """Phase 5, serve-moe and serve-nemotron: ``arch`` at published width
    and ``SERVE_FAMILY_LAYERS`` deep, bf16, random weights from
    ``torch.Generator`` seed 0,
    served by serve-full's engine and requests (4 slots, max_seq 1024,
    page 16, 8 prompts of 100-600 tokens, four sharing a 256-token prefix,
    64 new tokens each), the fused decode's and the paged prefill's launch
    counters zeroed just before and read just after; then a profiled
    decode window (with the MoE expert products' device time, read from
    the profile's batched-matmul ops) and the host syncs a tick.  The weights are freed before it returns."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    cfg = dataclasses.replace(REGISTRY[arch],
                              num_layers=SERVE_FAMILY_LAYERS[arch])
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    print(f"[serve] {label}: {arch} bf16 published width, {cfg.num_layers} "
          f"layers, G={cfg.num_heads // cfg.num_kv_heads}: "
          f"{nparam / 1e9:.3f} B params, {nparam * 2 / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    path = {k: kernels[k] for k in ("fused_paged_decode", "paged_prefill")}
    prompts = serve_prompts(cfg, 0, repeat_segment=False)
    eng, r = serve_run(label, model, params, prompts, path)
    r["params"] = nparam
    if cfg.moe is not None:
        check(eng.prefill_bucket == 1 and not eng._suffix_reuse
              and eng._spec_k == 0, f"{label}: the MoE engine must prefill "
              f"at the exact length, without compute reuse or speculation")
    r["profile"] = profile_decode(
        eng, prompts[4:], Request,
        experts=cfg.moe.num_experts if cfg.moe is not None else None)
    unwatch(eng)
    r["syncs"] = syncs_per_tick(label, eng, prompts[4:], Request)
    p = r["profile"]
    print(f"[serve] {label}: tok/s {r['tok_s']:.2f}; TTFT p50 "
          f"{r['ttft_s'][len(r['ttft_s']) // 2]:.4f} s, max "
          f"{r['ttft_s'][-1]:.4f} s; host tick {r['tick_s'] * 1e3:.2f} ms; "
          f"device {p['busy_ms_per_tick']:.4f} ms a tick (busy share "
          f"{p['busy_share']:.3f}), MoE expert products "
          f"{p['expert_ms_per_tick']:.4f} ms a tick "
          f"({p['expert_share']:.3f} of the device time); peak memory "
          f"{r['peak_memory_gb']:.3f} GB; host syncs a tick "
          f"{r['syncs']['per_tick']:.2f}")
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return r


def gemma2_serve_prompts(cfg, seed):
    """serve-gemma2's 8 prompts of 1,000-6,000 tokens: four share a
    256-token prefix (1,000, 2,200, 3,400 and 4,060 tokens; the last
    crosses position 4,096 while it decodes 64 tokens), four are longer
    than the 4,096-token window (4,500, 5,000, 5,600 and 6,000)."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    prefix = rng.integers(1, v, 256)
    out = [np.concatenate([prefix, rng.integers(1, v, n - 256)])
           for n in (1000, 2200, 3400, 4060)]
    out += [rng.integers(1, v, n) for n in (4500, 5000, 5600, 6000)]
    return [p.astype(np.int32) for p in out]


def serve_gemma2_phase(dev, kernels):
    """Phase 5, serve-gemma2: gemma2-9b at published width,
    ``SERVE_GEMMA2_LAYERS`` of its 42 layers (half local, half global,
    head_dim 256), bf16, random weights
    from ``torch.Generator`` seed 0, served by serve-full's engine (paged,
    4 slots, page 16) at max_seq 8192: 8 prompts of 1,000-6,000 tokens
    (``gemma2_serve_prompts``), 64 new tokens each, the four kernels'
    launch counters zeroed just before and read just after (flash for the
    local layers' prefill, the paged prefill and the fused decode for the
    global layers', the unfused decode over the local rings); then a
    profiled decode window and the host syncs a tick.  The weights are
    freed before it returns."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    label = "serve-gemma2"
    cfg = dataclasses.replace(REGISTRY[GEMMA2],
                              num_layers=SERVE_GEMMA2_LAYERS)
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    print(f"[serve] {label}: {GEMMA2} bf16 published width, "
          f"{cfg.num_layers} layers, G={cfg.num_heads // cfg.num_kv_heads}, "
          f"head_dim "
          f"{cfg.head_dim}, window {cfg.window_size}: {nparam / 1e9:.3f} B "
          f"params, {nparam * 2 / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    path = {k: kernels[k] for k in ("flash_attention", "paged_prefill",
                                    "fused_paged_decode", "paged_attention")}
    prompts = gemma2_serve_prompts(cfg, 0)
    eng, r = serve_run(label, model, params, prompts, path, max_seq=8192)
    r["params"] = nparam
    r["prompt_lengths"] = [len(p) for p in prompts]
    check(not eng._suffix_reuse and eng._spec_k == 0
          and eng._ring_min == cfg.window_size,
          f"{label}: gemma2's engine must keep its ring guard, without "
          f"compute reuse or speculation")
    r["profile"] = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    r["syncs"] = syncs_per_tick(label, eng, prompts[4:], Request)
    p = r["profile"]
    print(f"[serve] {label}: tok/s {r['tok_s']:.2f}; TTFT p50 "
          f"{r['ttft_s'][len(r['ttft_s']) // 2]:.4f} s, max "
          f"{r['ttft_s'][-1]:.4f} s; prefill phase "
          f"{r['phase_time_s']['prefill']:.4f} s; host tick "
          f"{r['tick_s'] * 1e3:.2f} ms; device {p['busy_ms_per_tick']:.4f} "
          f"ms a tick (busy share {p['busy_share']:.3f}), by class "
          f"{json.dumps({k: round(v, 4) for k, v in p['per_tick_ms'].items()})}"
          f"; peak memory {r['peak_memory_gb']:.3f} GB; host syncs a tick "
          f"{r['syncs']['per_tick']:.2f}")
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# the encoders: the paper's ViTs and whisper-base
# ---------------------------------------------------------------------------

VITS = ("deit-t", "deit-160", "deit-256", "lv-vit-t")
WHISPER = "whisper-base"
VIT_BATCHES = (1, 3, 6, 256)   # paper_tables.py's batches, and a large one
VIT_PROFILED = (1, 256)        # the batches with a profiled window (each
#                                window costs ~6 s of host time)
WHISPER_FRAMES = 1500          # 30 s of audio at whisper's 50 frames/s
WHISPER_CTX = 448              # whisper's text context: the decoder's max_seq
WHISPER_PROMPT = 4
# (row, B, H, Sq, Skv, D, causal, valid keys): flash at the encoders'
# shapes; the self-decode row's query sits at position 67 (the last step
# of 64 tokens after a 4-token prompt) over a 448-row cache
ENCODER_FLASH = (
    ("flash_attention_vit_d64", 6, 3, 197, 197, 64, False, 197),
    ("flash_attention_vit_d40", 6, 4, 197, 197, 40, False, 197),
    ("flash_attention_vit_d60", 6, 4, 197, 197, 60, False, 197),
    ("flash_attention_whisper_enc", 4, 8, 1500, 1500, 64, False, 1500),
    ("flash_attention_whisper_cross", 4, 8, 1, 1500, 64, False, 1500),
    ("flash_attention_whisper_self", 4, 8, 1, 448, 64, True, 68),
)


def flash_key(q, k, v):
    """A flash front-door call's (Sq, Skv, D), model layout (B, S, H, D)."""
    return (q.shape[1], k.shape[1], q.shape[-1])


def encoder_flash_inputs(row, dtype, gen, dev):
    """Flash's inputs at an ``ENCODER_FLASH`` row: q at std ``QSTD`` and
    k, v at std 1 from ``gen`` (B, H, S, D); positions (one query at the
    last valid key's position when Sq = 1); the valid-key mask; and
    SDPA's ``attn_mask`` for the same keys (None when all are valid)."""
    _, b, h, sq, skv, d, _, nvalid = row

    def rnd(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(dtype)
    q = rnd((b, h, sq, d), QSTD)
    k, v = rnd((b, h, skv, d)), rnd((b, h, skv, d))
    kp = torch.arange(skv, dtype=torch.int32, device=dev)
    qp = (torch.full((sq,), nvalid - 1, dtype=torch.int32, device=dev)
          if sq == 1 else torch.arange(sq, dtype=torch.int32, device=dev))
    kv = (kp < nvalid).to(torch.int32)
    mask = None if nvalid == skv else (kp < nvalid)[None, None, None, :]
    return (q, k, v, qp, kp, kv), mask


def encoder_kernel_phase(dev, flush, results):
    """Phase 3, the encoders' flash shapes (``ENCODER_FLASH``), f32 and
    bf16, against the plain version on the same CUDA tensors: the ViTs'
    non-causal Sq=Skv=197 at B=6 with H=Hkv (deit-t at D=64, deit-160 at
    D=40, lv-vit-t at D=60: the bf16 tile padded to 48 and 64 columns),
    whisper's encoder (B=4, H=8, Sq=Skv=1500, D=64), its cross decode (one
    query against 1500 cached frames, split in bf16) and its dense
    self-decode (one query over a 448-row cache, 68 rows valid).  Queries
    are drawn at std 4 (``QSTD``): at std 1 over 197-1500 non-causal keys
    the softmax is nearly flat and the outputs are as small as the bf16
    tolerance.  Each row is timed beside its bound, the plain version and
    non-causal SDPA on the same K/V (with the self-decode's mask; at
    D=60 SDPA takes a non-flash backend), with device times and the bf16
    key splits."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(29)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        names = []
        for row in ENCODER_FLASH:
            name, b, h, sq, skv, d, causal, nvalid = row
            args, mask = encoder_flash_inputs(row, dtype, gen, dev)
            q, k, v = args[:3]
            out = TF.flash_attention_bhsd(*args, causal=causal)
            ref = TR.flash_attention_ref(*args, causal=causal)
            torch.cuda.synchronize()
            err = assert_close(name, out, ref, dtype)
            top = float(ref.abs().max())
            check(top > 0.5, f"{name}: outputs of at most {top:.3g} are "
                             f"too small to test a tolerance of 2e-2")
            # the function needs only the nvalid K/V rows (the kernel
            # skips tiles with no admissible key), and every row's k_pos
            # and k_valid
            bnd, by = bound_ms((2 * b * h * sq * d + 2 * b * h * nvalid * d)
                               * el + 4 * (sq + 2 * skv),
                               4 * b * h * sq * nvalid * d, dtype)

            def launch(args=args, causal=causal):
                return TF.flash_attention_bhsd(*args, causal=causal)

            def plain(args=args, causal=causal):
                return TR.flash_attention_ref(*args, causal=causal)
            sdpa = functools.partial(F.scaled_dot_product_attention, q, k,
                                     v, attn_mask=mask)
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=bench(launch, flush),
                plain_ms=bench(plain, flush, iters=5, warmup=1),
                library_ms=bench(sdpa, flush), bound_ms=bnd, bound_by=by,
                device_ms=device_ms(launch, flush, bound=bnd),
                library_device_ms=device_ms(sdpa, flush, bound=bnd),
                splits=splits_of(dtype, TF.flash_split(b, h, sq, skv)),
                key=(sq, skv, d), max_out=top,
                shape=f"B={b} H=Hkv={h} Sq={sq} Skv={skv} D={d} "
                f"{'causal' if causal else 'non-causal'}, {nvalid} keys "
                f"valid, max |out| {top:.3g}")
            names.append(name)
            del q, k, v, args, out, ref
        print_rows(results, dtype, names)
        torch.cuda.empty_cache()


def params_to(params, device):
    """A copy of a param tree (dicts and lists of tensors) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def encoder_parity_phase(dev, kernels):
    """Phase 4, f32: each paper ViT at published width and depth (12
    layers), random weights from ``torch.Generator`` seed 0 on the card
    and the same weights copied to the host, ``Model.forward`` on a batch
    of 6 images of 196 patch embeddings (numpy seed 0): the card's logits
    within 1e-4 of the host's plain forward, relative to the largest
    logit, the top-1 classes equal wherever the host's top-2 gap exceeds
    that error, and flash launched once a layer.  Then whisper-base at
    published size (6 + 6 layers, vocab 51,865): B=2, 1500 encoder
    frames, a 4-token prompt, max_seq 448; prefill + 31 greedy
    ``decode_step``s on the card must give the host's 32 tokens a stream.
    The host runs the plain versions (the card's machine has no JAX)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    flash = kernels["flash_attention"]
    f32 = dict(dtype="float32", param_dtype="float32")
    out = {}
    for arch in VITS:
        cfg = dataclasses.replace(REGISTRY[arch], **f32)
        model, host = build_model(cfg, device=dev), build_model(cfg, "cpu")
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        emb = np.random.default_rng(0).standard_normal(
            (6, 196, cfg.d_model)).astype(np.float32)
        flash.launches = 0
        got, _ = model.forward(params, {"embeds": emb})
        torch.cuda.synchronize()
        launches = flash.launches
        want, _ = host.forward(params_to(params, "cpu"), {"embeds": emb})
        got = got.cpu()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        top = torch.topk(want, 2, dim=-1).values
        decided = (top[:, 0] - top[:, 1]) > err * scale
        same = bool((got.argmax(-1) == want.argmax(-1))[decided].all())
        print(f"[parity] {arch} f32 ({cfg.num_layers} layers, head_dim "
              f"{cfg.head_dim}, B=6 x 197 positions): max |card - host| / "
              f"max |logit| "
              f"{err:.3g} (max |logit| {scale:.3g}); top-1 equal on "
              f"{int(decided.sum())} of 6 decided rows: {same}; flash "
              f"launches {launches}")
        check(bool(torch.isfinite(got).all()), f"{arch}: non-finite logits")
        check(err <= 1e-4, f"{arch}: f32 logits {err:.3g} from the host's")
        check(same, f"{arch}: top-1 classes differ from the host's")
        check(launches == cfg.num_layers,
              f"{arch}: {launches} flash launches for {cfg.num_layers} "
              f"layers")
        out[arch] = dict(rel_err=err, max_logit=scale, launches=launches,
                         decided=int(decided.sum()))
        del model, params
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(REGISTRY[WHISPER], **f32)
    model, host = build_model(cfg, device=dev), build_model(cfg, "cpu")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    hp = params_to(params, "cpu")
    r = np.random.default_rng(1)
    enc = r.standard_normal((2, WHISPER_FRAMES, cfg.d_model)).astype(
        np.float32)
    prompt = r.integers(0, cfg.vocab_size, (2, WHISPER_PROMPT)).astype(
        np.int32)

    def greedy(m, p, n=32):
        logits, cache = m.prefill(p, {"enc_embeds": enc,
                                      "dec_tokens": prompt}, WHISPER_CTX)
        toks, gaps, fin = [], [], True
        for t in range(WHISPER_PROMPT, WHISPER_PROMPT + n):
            last = logits[:, -1].float()
            fin = fin and bool(torch.isfinite(last).all())
            top = torch.topk(last, 2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            toks.append(last.argmax(-1))
            if len(toks) == n:
                break
            logits, cache = m.decode_step(p, cache, toks[-1][:, None], t)
        return (torch.stack(toks, 1).cpu(), float(torch.stack(gaps).min()),
                fin)
    flash.launches = 0
    got, _, fin = greedy(model, params)
    torch.cuda.synchronize()
    launches = flash.launches
    want, gap, _ = greedy(host, hp)
    same = torch.equal(got, want)
    print(f"[parity] {WHISPER} f32 ({cfg.num_layers} + {cfg.num_layers} "
          f"layers, B=2, {WHISPER_FRAMES} frames, {WHISPER_PROMPT}-token "
          f"prompt, max_seq {WHISPER_CTX}): "
          f"32 greedy tokens a stream equal to the host's: {same} (host's "
          f"smallest top-2 gap {gap:.3g}); flash launches {launches}")
    check(fin, f"{WHISPER}: non-finite logits")
    check(same, f"{WHISPER}: greedy streams differ from the host's: "
                f"{got.tolist()} vs {want.tolist()}")
    check(launches > 0, f"{WHISPER}: flash never launched")
    out[WHISPER] = dict(equal=same, min_gap=gap, launches=launches,
                        tokens=got.tolist())
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_forward(fn, reps=10):
    """Device time (ms) of one call of ``fn``, its share of the window's
    wall time, and the CUDA kernels it launches, from ``torch.profiler``
    over ``reps`` back-to-back calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, kernels = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            busy += evt.self_device_time_total / 1e6
            kernels += evt.count
    return dict(device_ms=busy * 1e3 / reps, busy_share=busy / wall,
                kernels=kernels / reps, wall_ms=wall * 1e3 / reps)


def event_ms(fn, iters=20, warmup=3):
    """Median ms of ``fn`` between CUDA events, warm (no L2 flush: a
    server runs the same weights call after call)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def encoder_run_phase(dev, kernels, card):
    """Phase 5, bf16, random weights from ``torch.Generator`` seed 0:
    each paper ViT's ``Model.forward`` at published size over B = 1, 3, 6
    (``benchmarks/paper_tables.py``'s batches) and 256 images of 196 patch
    embeddings (drawn on the card): ms a batch (CUDA events, median of
    20, warm), images/s, and at B = 1 and 256 (``VIT_PROFILED``) device
    time and busy share and kernels a forward from a profiled window of
    10, and beside them the port's ``core
    prediction for the same graph and batch on one H100
    (``simulate(build_graph(cfg, vit_shape(B)), sequential_assignment(g,
    1), hw=H100)``: printed, never checked).  Then whisper-base at B=4,
    1500 frames, 64 greedy tokens from a 4-token prompt (max_seq 448):
    encode ms, prefill ms (encode included), ms a decode step, tok/s,
    peak memory, finite logits.  Flash's launch counter is zeroed before
    each model and read after (it must launch), and the front door's
    calls are sorted by (Sq, Skv, D) for the kernel rows' launches."""
    from repro_torch.configs import REGISTRY, vit_shape
    from repro_torch.core import (H100, build_graph, sequential_assignment,
                                  simulate)
    from repro_torch.models import build_model
    flash = kernels["flash_attention"]
    out = {"vit": {}}
    with tally_calls("dispatch_flash_attention", flash_key) as tally:
        for arch in VITS:
            cfg = REGISTRY[arch]
            model = build_model(cfg, device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            params = model.init(gen)
            flash.launches = 0
            rows = {}
            for b in VIT_BATCHES:
                emb = torch.randn((b, 196, cfg.d_model), generator=gen,
                                  device=dev).to(torch.bfloat16)

                def fwd(emb=emb):
                    return model.forward(params, {"embeds": emb})[0]
                logits = fwd()
                torch.cuda.synchronize()
                check(logits.shape == (b, cfg.vocab_size)
                      and bool(torch.isfinite(logits).all()),
                      f"{arch} B={b}: bad logits")
                ms = event_ms(fwd)
                g = build_graph(cfg, vit_shape(b))
                pred = simulate(g, sequential_assignment(g, 1), 1, hw=H100)
                rows[b] = dict(ms=ms, images_s=b / ms * 1e3,
                               pred_ms=pred.latency * 1e3)
                dev_txt = "not profiled"
                if b in VIT_PROFILED:
                    prof = profile_forward(fwd)
                    rows[b].update(prof)
                    dev_txt = (f"device {prof['device_ms']:.4f} ms a "
                               f"forward (busy share "
                               f"{prof['busy_share']:.3f}), "
                               f"{prof['kernels']:.0f} kernels a forward")
                print(f"[run] {arch} bf16 B={b}: {ms:.4f} ms a batch, "
                      f"{b / ms * 1e3:.1f} images/s; {dev_txt}; core "
                      f"predicts {pred.latency * 1e3:.4f} ms (sequential, "
                      f"1 chip, hw=H100) ({card})")
            torch.cuda.synchronize()
            check(flash.launches > 0, f"{arch}: flash never launched")
            out["vit"][arch] = dict(rows=rows, launches=flash.launches)
            del model, params
            torch.cuda.empty_cache()

        cfg = REGISTRY[WHISPER]
        model = build_model(cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen)
        b, n = 4, 64
        enc = torch.randn((b, WHISPER_FRAMES, cfg.d_model), generator=gen,
                          device=dev).to(torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab_size, (b, WHISPER_PROMPT),
                               generator=gen, device=dev)
        batch = {"enc_embeds": enc, "dec_tokens": prompt}
        flash.launches = 0
        torch.cuda.reset_peak_memory_stats()
        enc_ms = event_ms(lambda: model.encode(params, enc), iters=5,
                          warmup=1)
        pre_ms = event_ms(lambda: model.prefill(params, batch, WHISPER_CTX),
                          iters=5, warmup=1)
        logits, cache = model.prefill(params, batch, WHISPER_CTX)
        toks = [logits[:, -1].argmax(-1)]
        finite = [torch.isfinite(logits).all()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(WHISPER_PROMPT, WHISPER_PROMPT + n - 1):
            logits, cache = model.decode_step(params, cache,
                                              toks[-1][:, None], t)
            toks.append(logits[:, -1].argmax(-1))
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ok = bool(torch.stack(finite).all())
        step_ms = dec_s * 1e3 / (n - 1)
        w = dict(encode_ms=enc_ms, prefill_ms=pre_ms, step_ms=step_ms,
                 tok_s=b * (n - 1) / dec_s,
                 e2e_tok_s=b * n / (dec_s + pre_ms / 1e3),
                 peak_memory_gb=peak, finite=ok, launches=flash.launches)
        print(f"[run] {WHISPER} bf16 B={b}, {WHISPER_FRAMES} frames, {n} "
              f"greedy tokens from a {WHISPER_PROMPT}-token prompt: encode "
              f"{enc_ms:.4f} ms, prefill {pre_ms:.4f} ms (encode "
              f"included), {step_ms:.4f} ms a decode step, "
              f"{w['tok_s']:.1f} tok/s decoding ({w['e2e_tok_s']:.1f} with "
              f"the prefill), peak memory {peak:.3f} GB, finite logits "
              f"{ok}; flash launches {flash.launches} ({card})")
        check(ok, f"{WHISPER}: non-finite logits")
        check(flash.launches > 0, f"{WHISPER}: flash never launched")
        out[WHISPER] = w
        del model, params, cache
    out["tally"] = {f"{k[0]}x{k[1]}xD{k[2]}": n for k, n in tally.items()}
    # a row's launches: the calls at its (Sq, Skv, D), whatever B and H
    # (deit-t's H=3 and deit-256's H=4 both count for the D=64 row)
    out["launches"] = {row[0]: tally.get((row[3], row[4], row[5]), 0)
                       for row in ENCODER_FLASH}
    total = sum(v["launches"] for v in out["vit"].values()) \
        + out[WHISPER]["launches"]
    print(f"[run] flash launches by (Sq, Skv, D): {json.dumps(out['tally'])}"
          f" ({total} counted by the wrapper)")
    check(sum(tally.values()) == total,
          "the front door's calls and flash's launches disagree")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the last families: xlstm-125m, qwen2-vl-72b, jamba's MoE period
# ---------------------------------------------------------------------------

XLSTM = "xlstm-125m"
XLSTM_PARITY_LAYERS = 4        # one period of 12, for the smoke's time
SERVE_XLSTM_LAYERS = 4         # the same cut for serve-xlstm
VLM = "qwen2-vl-72b"
JAMBA_MOE = "jamba-1.5-large-398b-8e"
VLM_TEXT = 64                  # text tokens before and after the image
VLM_GRID = (16, 24)            # the image's patch grid (384 positions)
VLM_RUN_LAYERS = 32            # of 80: 4.98 + 32 x 1.755 GB in bf16
VLM_PARITY_LAYERS = 2          # ~17 GB in f32
VLM_CTX = 1024                 # the decode's dense cache rows
VLM_STEPS = 32
# (row, B, H, Hkv, Sq, Skv, D, query position, valid keys): qwen2-vl's
# causal prefill over the 512-position prompt, and its lock-step decode's
# last step (position 543 after 32 steps) over the 1024-row cache
VLM_FLASH = (
    ("flash_attention_vlm_prefill", 2, 64, 8, 512, 512, 128, None, 512),
    ("flash_attention_vlm_decode", 2, 64, 8, 1, 1024, 128, 543, 544),
)


def vlm_kernel_phase(dev, flush, results):
    """Phase 3, qwen2-vl's flash shapes (``VLM_FLASH``): the causal
    prefill (B=2, H=64, Hkv=8, Sq=Skv=512, D=128) and one lock-step
    decode query at position 543 over a 1024-row cache whose first 544
    rows are valid (``flash_shape_rows``)."""
    flash_shape_rows(dev, flush, results, VLM_FLASH, 31)


# phase 11's flash: a rank's heads of yi-6b at model=2 (H=16, Hkv=2), the
# rank's 2 rows of a microbatch of the bf16 plan (B=8 in 4 microbatches),
# causal S=512, forward only
PLAN_MESH_FLASH = (
    ("flash_attention_tp2_fwd", 2, 16, 2, 512, 512, 128, None, 512),
)


def flash_shape_rows(dev, flush, results, rows, seed):
    """Phase 3, flash at ``rows`` (name, B, H, Hkv, Sq, Skv, D, query
    position or None for Sq = Skv from 0, valid keys), f32 and bf16,
    against the plain version on the same CUDA tensors.  Queries at std 4
    (``QSTD``), K/V at std 1.  Each row is timed beside its bound (the
    valid K/V rows read once; 4·D operations an admissible pair), the
    plain version and SDPA on K/V repeated to H heads beforehand (causal,
    or with the valid-key mask), with device times and the bf16 key
    splits."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        el = torch.tensor([], dtype=dtype).element_size()
        names = []
        for name, b, h, hk, sq, skv, d, qpos, nvalid in rows:
            q = rnd((b, h, sq, d), dtype, QSTD)
            k, v = rnd((b, hk, skv, d), dtype), rnd((b, hk, skv, d), dtype)
            kp = torch.arange(skv, dtype=torch.int32, device=dev)
            qp = (kp[:sq] if qpos is None else
                  torch.full((sq,), qpos, dtype=torch.int32, device=dev))
            kv = (kp < nvalid).to(torch.int32)
            args = (q, k, v, qp, kp, kv)
            out = TF.flash_attention_bhsd(*args, causal=True)
            ref = TR.flash_attention_ref(*args, causal=True)
            torch.cuda.synchronize()
            err = assert_close(name, out, ref, dtype)
            kr = k.repeat_interleave(h // hk, 1).contiguous()
            vr = v.repeat_interleave(h // hk, 1).contiguous()
            if qpos is None:
                sdpa = functools.partial(F.scaled_dot_product_attention, q,
                                         kr, vr, is_causal=True)
                pairs = sq * (sq + 1) // 2
            else:
                sdpa = functools.partial(
                    F.scaled_dot_product_attention, q, kr, vr,
                    attn_mask=(kp < nvalid)[None, None, None, :])
                pairs = nvalid
            bnd, by = bound_ms((2 * b * h * sq * d + 2 * b * hk * nvalid * d)
                               * el + 4 * (sq + 2 * skv),
                               4 * b * h * pairs * d, dtype)

            def launch(args=args):
                return TF.flash_attention_bhsd(*args, causal=True)

            def plain(args=args):
                return TR.flash_attention_ref(*args, causal=True)
            results[(name, dtype)] = dict(
                max_abs_err=err, ms=bench(launch, flush),
                plain_ms=bench(plain, flush, iters=5, warmup=1),
                library_ms=bench(sdpa, flush), bound_ms=bnd, bound_by=by,
                device_ms=device_ms(launch, flush, bound=bnd),
                library_device_ms=device_ms(sdpa, flush, bound=bnd),
                splits=splits_of(dtype, TF.flash_split(b, h, sq, skv)),
                key=(sq, skv, d),
                shape=f"B={b} H={h} Hkv={hk} Sq={sq} Skv={skv} D={d} "
                f"causal, {nvalid} keys valid")
            names.append(name)
            del q, k, v, kr, vr, args, out, ref
        print_rows(results, dtype, names)
        torch.cuda.empty_cache()


def mrope_positions(before, grid_h, grid_w, after, batch=1):
    """(3, B, S) M-RoPE positions as Qwen2-VL lays them out: ``before``
    text tokens at t = h = w = index, a grid_h x grid_w image at t =
    start, h = start + row, w = start + col, then ``after`` text tokens
    from the largest position + 1."""
    t = list(range(before))
    h, w = list(t), list(t)
    for row in range(grid_h):
        for col in range(grid_w):
            t.append(before)
            h.append(before + row)
            w.append(before + col)
    nxt = max(t + h + w) + 1
    for i in range(after):
        for s in (t, h, w):
            s.append(nxt + i)
    pos = np.asarray([t, h, w], np.int64)[:, None]
    return np.broadcast_to(pos, (3, batch, pos.shape[-1])).copy()


def vlm_prompt(table, d, batch, seed):
    """qwen2-vl's prompt: 64 text tokens through the embedding table
    ``table``, a 16 x 24 grid of patch embeddings drawn from numpy
    ``seed`` at the table's scale (N(0, 1/d)), 64 text tokens; f32
    embeds (B, 512, d) on the table's device and the (3, B, 512)
    positions."""
    r = np.random.default_rng(seed)
    gh, gw = VLM_GRID
    ids = torch.from_numpy(r.integers(0, table.shape[0],
                                      (batch, 2 * VLM_TEXT))).to(
                                          table.device)
    patches = torch.from_numpy((r.standard_normal((batch, gh * gw, d))
                                / np.sqrt(d)).astype(np.float32)).to(
                                    table.device)
    text = table[ids].to(torch.float32)
    emb = torch.cat([text[:, :VLM_TEXT], patches, text[:, VLM_TEXT:]], 1)
    return emb, mrope_positions(VLM_TEXT, gh, gw, VLM_TEXT, batch)


def vlm_parity_phase(dev, kernels):
    """Phase 4, qwen2-vl-72b in f32 at published width and 2 layers
    (~17 GB), random weights from ``torch.Generator`` seed 0 on the card
    and the same weights copied to the host: B=1, the 512-position
    prompt (``vlm_prompt``, M-RoPE positions on distinct streams).
    ``forward``'s logits within 1e-4 of the host's plain forward,
    relative to the largest logit; ``prefill`` + 16 ``decode_step``s
    (positions (3, 1, 1), all three streams at the next text position)
    give the host's 17 greedy tokens; swapping the h and w streams moves
    the logits; flash launched once a layer a call."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    flash = kernels["flash_attention"]
    cfg = dataclasses.replace(REGISTRY[VLM], num_layers=VLM_PARITY_LAYERS,
                              dtype="float32", param_dtype="float32")
    model, host = build_model(cfg, device=dev), build_model(cfg, "cpu")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    hp = params_to(params, "cpu")
    nparam = model.param_count(params)
    print(f"[parity] {VLM} f32, {cfg.num_layers} layers: {nparam / 1e9:.3f} "
          f"B params, {nparam * 4 / 1e9:.1f} GB; init and host copy "
          f"{time.perf_counter() - t0:.1f} s")
    emb, pos = vlm_prompt(hp["embed"]["table"], cfg.d_model, 1, 0)
    batch = {"embeds": emb, "positions": pos}
    flash.launches = 0
    got, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    fwd_launches = flash.launches
    swapped, _ = model.forward(params, {"embeds": emb,
                                        "positions": pos[[0, 2, 1]]})
    t0 = time.perf_counter()
    want, _ = host.forward(hp, batch)
    host_s = time.perf_counter() - t0
    got, swapped = got.cpu(), swapped.cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    moved = float((swapped - got).abs().max()) / scale
    ok = bool(torch.isfinite(got).all())
    print(f"[parity] {VLM} f32 forward (B=1, {emb.shape[1]} positions: "
          f"{VLM_TEXT} text, a {VLM_GRID[0]}x{VLM_GRID[1]} image, "
          f"{VLM_TEXT} text): max |card - host| / max |logit| {err:.3g} "
          f"(max |logit| {scale:.3g}); h and w swapped move the logits by "
          f"{moved:.3g} of it; flash launches {fwd_launches}; host "
          f"forward {host_s:.1f} s")
    check(ok, f"{VLM}: non-finite logits")
    check(err <= 1e-4, f"{VLM}: f32 logits {err:.3g} from the host's")
    check(moved > 1e-3, f"{VLM}: swapping the h and w streams moved the "
                        f"logits by only {moved:.3g}")
    check(fwd_launches == cfg.num_layers,
          f"{VLM}: {fwd_launches} flash launches for {cfg.num_layers} "
          f"layers")
    del got, want, swapped

    def greedy(m, p, n=16):
        logits, cache = m.prefill(p, batch, VLM_CTX)
        toks, gaps, fin = [], [], True
        nxt = int(pos.max()) + 1
        for i in range(n + 1):
            last = logits[:, -1].float()
            fin = fin and bool(torch.isfinite(last).all())
            gaps.append(top2_gap(last[0]))
            toks.append(int(last[0].argmax()))
            if i == n:
                break
            logits, cache = m.decode_step(
                p, cache, np.array([[toks[-1]]], np.int32),
                emb.shape[1] + i,
                positions=np.full((3, 1, 1), nxt + i, np.int64))
        return toks, min(gaps), fin
    flash.launches = 0
    mine, _, fin = greedy(model, params)
    torch.cuda.synchronize()
    launches = flash.launches
    t0 = time.perf_counter()
    ref, gap, _ = greedy(host, hp)
    host_s = time.perf_counter() - t0
    same = mine == ref
    print(f"[parity] {VLM} f32 prefill + 16 decode steps: 17 greedy tokens "
          f"equal to the host's: {same} (host's smallest top-2 gap "
          f"{gap:.3g}); flash launches {launches}; host {host_s:.1f} s")
    check(fin, f"{VLM}: non-finite decode logits")
    check(same, f"{VLM}: greedy stream differs from the host's: {mine} vs "
                f"{ref}")
    check(launches == 17 * cfg.num_layers,
          f"{VLM}: {launches} flash launches for 17 calls of "
          f"{cfg.num_layers} layers")
    del model, params, hp, host
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rel_err=err, hw_swap_rel=moved, max_logit=scale,
                equal=same, min_gap=gap, tokens=mine,
                launches=fwd_launches + launches)


def xlstm_parity_phase(dev, kernels):
    """Phase 4, xlstm-125m in f32 at published width and one period of
    depth (``XLSTM_PARITY_LAYERS``: 3 mLSTM and 1 sLSTM layers of its 12;
    d_model 768, tied head; the smoke's time), random weights from
    ``torch.Generator`` seed 0: serve-full's first 4 prompts (300-600
    tokens, a shared 256-token prefix), 32 greedy tokens each.  The
    streams of the dense engine, a ``paged=True`` engine (which must run
    dense: no KV to page), the ``hybrid:2`` plan engine (2 replicas,
    chunk 128: the chunks carry the mLSTM and sLSTM state), the
    overlapped engine and a forced re-plan that migrates one slot's state
    row must each equal the one-shot gold; every engine prefills at the
    exact prompt length, and the paged one, built with ``speculate=4``,
    speculates nothing.  No
    kernel is on this path: the recurrences are plain PyTorch, as JAX
    keeps them jnp."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.serve import _build_serving_plan
    from repro_torch.models import build_model
    from repro_torch.plan import lower_serving, uniform_plan
    from repro_torch.serving import Request, ServingEngine
    cfg = dataclasses.replace(REGISTRY[XLSTM], dtype="float32",
                              param_dtype="float32",
                              num_layers=XLSTM_PARITY_LAYERS)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    nparam = model.param_count(params)
    print(f"[parity] {XLSTM} f32, {cfg.num_layers} layers: "
          f"{nparam / 1e6:.1f} M params, {nparam * 4 / 1e9:.2f} GB")
    prompts = serve_prompts(cfg, 0, repeat_segment=False)[:4]
    max_seq, new = 1024, 32
    sched = [(p, new, 0) for p in prompts]
    t0 = time.perf_counter()
    golds, gaps = {}, {}
    for uid, p in enumerate(prompts):
        golds[uid], lgs = gold_decode(model, params, p, new, max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    print(f"[parity] {XLSTM} gold: prompts {[len(p) for p in prompts]} "
          f"tokens, {time.perf_counter() - t0:.1f} s")
    splan = _build_serving_plan(cfg, "hybrid:2", 4, 2, 128, max_seq)
    out = {}
    for label, kw in (("dense", {}),
                      ("paged speculate=4", dict(paged=True, page_size=16,
                                                 speculate=4)),
                      ("plan hybrid:2", dict(plan=splan)),
                      ("overlap", dict(overlap=True))):
        t0 = time.perf_counter()
        eng, got, _ = run_engine(f"{XLSTM} f32 {label}", model, params,
                                 sched, {}, max_seq, 4, **kw)
        compare_streams(f"{XLSTM} f32 {label} vs one-shot gold", got, golds,
                        gaps)
        st = eng.cache_stats()
        out[label] = dict(seconds=time.perf_counter() - t0,
                          chunks=eng.prefill_chunk_counts,
                          spec_steps=eng.stats()["spec_steps"])
        print(f"[parity] {XLSTM} {label}: prefill_bucket "
              f"{eng.prefill_bucket}, paged {eng.paged}, layout "
              f"{st['layout']}, spec steps {out[label]['spec_steps']}, "
              f"chunks per admission {eng.prefill_chunk_counts}, "
              f"{out[label]['seconds']:.1f} s")
        check(eng.prefill_bucket == 1, f"{XLSTM}: padded prefill")
        check(not eng.paged and st["layout"] == "dense",
              f"{XLSTM} {label}: the engine did not run dense")
        if "plan" in kw:
            check(all(c > 1 for c in eng.prefill_chunk_counts),
                  f"{XLSTM}: the plan did not chunk the prompts")
        if "speculate" in kw:
            check(eng._spec_k == 0 and out[label]["spec_steps"] == 0,
                  f"{XLSTM}: the engine speculated")
        del eng

    # a live re-plan: mono -> a 1-stage plan of 2 replicas while both
    # active slots sit on replica 0 moves one slot, whose mLSTM and sLSTM
    # state is a dense row that is copied
    eng = ServingEngine(model, params, slots=4, max_seq=max_seq)
    finite = watch_all(eng, model, max_seq)
    for uid in (0, 1):
        eng.submit(Request(uid, prompts[uid], new))
    while eng.queue:
        eng.tick()
    active = [s for s in range(4) if eng._slot_req[s] is not None]
    eng.replan(lower_serving(uniform_plan(cfg.num_groups, 1,
                                          n_microbatches=2),
                             slots=4, chunk=128))
    moved = [s for s in range(4) if eng._slot_req[s] is not None]
    got = {r.uid: r for r in eng.run()}
    st = eng.stats()
    print(f"[replan] {XLSTM} f32 rebalance: slots {active} -> {moved}; "
          f"migrations {st['migrations']} (copies "
          f"{st['migration_copies']})")
    check(bool(torch.stack(finite).all()), f"{XLSTM} re-plan: non-finite "
                                           f"logits")
    check(active == [0, 1] and moved[1] >= 2 and st["replans"] == 1,
          f"{XLSTM} re-plan: slots {active} -> {moved}")
    check(st["migration_copies"] == st["migrations"] >= 1,
          f"{XLSTM} re-plan: the migration did not copy its state row")
    compare_streams(f"{XLSTM} f32 re-plan vs one-shot gold", got,
                    {u: golds[u] for u in (0, 1)}, gaps)
    out["replan"] = {k: st[k] for k in ("migrations", "migration_copies")}
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mixer_prefill(model, params, cfg, j, s, card):
    """One ``s``-token prompt through pattern slot ``j``'s mixer of group
    0 alone, from a zeroed state (an admission's), bf16: ms (CUDA events,
    median of 3), and the kernels a call launches (profiled)."""
    from repro_torch.models import transformer as T
    blk = cfg.block_pattern[j]
    _, apply, shape = T.RECURRENT[blk.mixer]
    x = torch.randn((1, s, cfg.d_model), device=params["embed"]["table"]
                    .device).to(torch.bfloat16)
    state = {n: torch.zeros(shp, device=x.device)
             for n, shp in shape(cfg, 1).items()}
    p = params["stack"][0][f"b{j}"]["mixer"]

    def fn():
        return apply(p, x, cfg, state=state)[0]
    ms = event_ms(fn, iters=3, warmup=1)
    prof = profile_forward(fn, reps=1)
    print(f"[serve] serve-xlstm: one {s}-token prefill through a "
          f"{blk.mixer} layer: {ms:.3f} ms, {prof['kernels']:.0f} kernels "
          f"({prof['kernels'] / s:.1f} a step), device "
          f"{prof['device_ms']:.3f} ms (busy share "
          f"{prof['busy_share']:.3f}) ({card})")
    return dict(ms=ms, kernels=prof["kernels"], device_ms=prof["device_ms"],
                busy_share=prof["busy_share"])


def serve_xlstm_phase(dev, kernels, card):
    """Phase 5, serve-xlstm: xlstm-125m at published width, one period
    (``SERVE_XLSTM_LAYERS``: 3 mLSTM and 1 sLSTM layers of its 12, for
    the smoke's time), bf16, random weights from ``torch.Generator``
    seed 0, serve-full's
    engine settings and prompts (4 slots, max_seq 1024, 8 prompts of
    100-600 tokens, 64 new tokens; ``paged=True`` runs dense: no KV to
    page), then a profiled decode window (device ms and kernels a tick)
    and the host syncs a tick; then one 600-token prefill through an
    mLSTM and an sLSTM layer alone (ms and kernels a layer)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    cfg = dataclasses.replace(REGISTRY[XLSTM], num_layers=SERVE_XLSTM_LAYERS)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = serve_prompts(cfg, 0, repeat_segment=False)
    eng, r = serve_run("serve-xlstm", model, params, prompts, {})
    check(not eng.paged and eng.prefill_bucket == 1,
          "serve-xlstm: the engine must run dense at exact lengths")
    r["profile"] = p = profile_decode(eng, prompts[4:], Request)
    unwatch(eng)
    r["syncs"] = syncs_per_tick("serve-xlstm", eng, prompts[4:], Request)
    print(f"[serve] serve-xlstm: tok/s {r['tok_s']:.2f}; TTFT p50 "
          f"{r['ttft_s'][len(r['ttft_s']) // 2]:.4f} s, max "
          f"{r['ttft_s'][-1]:.4f} s; prefill phase "
          f"{r['phase_time_s']['prefill']:.4f} s; host tick "
          f"{r['tick_s'] * 1e3:.2f} ms; device {p['busy_ms_per_tick']:.4f} "
          f"ms a tick (busy share {p['busy_share']:.3f}), "
          f"{p['kernels_per_tick']:.0f} kernels a tick; host syncs a tick "
          f"{r['syncs']['per_tick']:.2f}; peak memory "
          f"{r['peak_memory_gb']:.3f} GB ({card})")
    del eng
    gc.collect()
    r["mixers"] = {cfg.block_pattern[j].mixer: mixer_prefill(
        model, params, cfg, j, 600, card) for j in (0, 3)}
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return r


def vlm_run_phase(dev, kernels, card):
    """Phase 5, run-vlm: qwen2-vl-72b at published width, 32 of its 80
    layers (~61 GB in bf16), random weights from ``torch.Generator`` seed
    0; B=2, the 512-position prompt (``vlm_prompt``), ``prefill`` (ms:
    CUDA events, median of 3) into a 1024-row dense cache, then 32
    lock-step greedy ``decode_step``s at (3, 2, 1) positions (ms a step,
    host clock to the device's completion), beside the weight-read bound
    of a step (every weight but the embedding table once, at 3.35 TB/s);
    tok/s, peak memory, finite logits, flash's launches sorted by
    (Sq, Skv, D) for the kernel rows."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    flash = kernels["flash_attention"]
    cfg = dataclasses.replace(REGISTRY[VLM], num_layers=VLM_RUN_LAYERS)
    model = build_model(cfg, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    table = params["embed"]["table"]
    step_bytes = (nparam - table.numel()) * 2
    print(f"[run] {VLM} bf16, {cfg.num_layers} layers: {nparam / 1e9:.3f} B "
          f"params, {nparam * 2 / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    b = 2
    emb, pos = vlm_prompt(table, cfg.d_model, b, 1)
    batch = {"embeds": emb.to(torch.bfloat16), "positions": pos}
    s = emb.shape[1]
    nxt = int(pos.max()) + 1
    with tally_calls("dispatch_flash_attention", flash_key) as tally:
        flash.launches = 0
        pre_ms = event_ms(lambda: model.prefill(params, batch, VLM_CTX),
                          iters=3, warmup=1)
        logits, cache = model.prefill(params, batch, VLM_CTX)
        toks = [logits[:, -1].argmax(-1)]
        finite = [torch.isfinite(logits).all()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(VLM_STEPS):
            logits, cache = model.decode_step(
                params, cache, toks[-1][:, None], s + i,
                positions=torch.full((3, b, 1), nxt + i, device=dev))
            toks.append(logits[:, -1].argmax(-1))
            finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        launches = flash.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    # where a decode step's time goes: the last step again, profiled
    prof = profile_forward(lambda: model.decode_step(
        params, cache, toks[-1][:, None], s + VLM_STEPS - 1,
        positions=torch.full((3, b, 1), nxt + VLM_STEPS - 1, device=dev)),
        reps=3)
    ok = bool(torch.stack(finite).all())
    step_ms = dec_s * 1e3 / VLM_STEPS
    bound = step_bytes / PEAK_BYTES * 1e3
    pre_bound = 2 * b * s * (nparam - table.numel()) / PEAK_OPS[
        torch.bfloat16] * 1e3
    out = dict(prefill_ms=pre_ms, prefill_flop_bound_ms=pre_bound,
               step_ms=step_ms, step_bound_ms=bound,
               tok_s=b * VLM_STEPS / dec_s, peak_memory_gb=peak, finite=ok,
               params=nparam, launches_total=launches, step_profile=prof,
               tally={f"{k[0]}x{k[1]}xD{k[2]}": n
                      for k, n in tally.items()})
    out["launches"] = {row[0]: tally.get((row[4], row[5], row[6]), 0)
                       for row in VLM_FLASH}
    print(f"[run] run-vlm: {VLM} bf16, {cfg.num_layers} layers, B={b}, "
          f"{s}-position prompt: prefill {pre_ms:.3f} ms (weight FLOP bound "
          f"{pre_bound:.3f} ms), {step_ms:.3f} ms a decode step (weight-read "
          f"bound {bound:.3f} ms: {step_bytes / 1e9:.2f} GB at 3.35 TB/s; "
          f"{step_ms / bound:.2f}x; a profiled step: device "
          f"{prof['device_ms']:.3f} ms, busy share {prof['busy_share']:.3f}, "
          f"{prof['kernels']:.0f} kernels), {out['tok_s']:.2f} tok/s "
          f"decoding, "
          f"peak memory {peak:.3f} GB, finite logits {ok}; flash launches "
          f"{json.dumps(out['tally'])} ({card})")
    check(ok, f"{VLM}: non-finite logits")
    check(all(out["launches"][row[0]] > 0 for row in VLM_FLASH)
          and sum(tally.values()) == launches,
          f"{VLM}: flash launches {out['tally']} (wrapper {launches})")
    del model, params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def jamba_moe_parity_phase(dev, kernels):
    """Phase 4, jamba's published MoE period in f32: one period (8
    layers: 7 mamba, 1 attention; MoE on 1, 3, 5, 7, top-2) with 2
    experts (~45.6 GB), random weights from ``torch.Generator`` seed 1.
    A staggered schedule through the paged engine must give the one-shot
    gold's streams (the paged prefill, the unfused decode, the linear
    scan and the selective scan all launched), at the exact prompt
    length, without compute reuse or speculation."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    base = REGISTRY[JAMBA_MOE]
    cfg = dataclasses.replace(base, num_layers=8, dtype="float32",
                              param_dtype="float32",
                              moe=dataclasses.replace(base.moe,
                                                      num_experts=2))
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    nparam = model.param_count(params)
    print(f"[parity] {JAMBA_MOE} f32, 8 layers, 2 experts top-2: "
          f"{nparam / 1e9:.3f} B params, {nparam * 4 / 1e9:.1f} GB")
    rng = np.random.default_rng(2)
    v = cfg.vocab_size

    def toks(n):
        return rng.integers(1, v, n).astype(np.int32)
    sched = [(toks(50), 10, 0), (toks(120), 8, 0), (toks(33), 12, 1),
             (toks(70), 9, 5)]
    max_seq = 256
    golds, gaps = {}, {}
    for uid, (prompt, max_new, _) in enumerate(sched):
        golds[uid], lgs = gold_decode(model, params, prompt, max_new,
                                      max_seq)
        gaps[uid] = [top2_gap(x) for x in lgs]
    path = {k: kernels[k] for k in ("mamba_scan_fused", "linear_scan",
                                    "paged_attention", "paged_prefill")}
    eng, got, launches = run_engine(
        f"{JAMBA_MOE} paged fp", model, params, sched, path, max_seq, 4,
        paged=True, page_size=16, speculate=4)
    compare_streams(f"{JAMBA_MOE} f32 paged vs one-shot gold", got, golds,
                    gaps)
    check(eng.prefill_bucket == 1 and not eng._suffix_reuse
          and eng._spec_k == 0, f"{JAMBA_MOE}: the MoE hybrid must prefill "
          f"at the exact length, without compute reuse or speculation")
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches)


def serve_jamba_moe_phase(dev, kernels, card):
    """Phase 5, serve-jamba-moe: ``jamba-1.5-large-398b-8e`` (the
    published MoE period with 8 of 16 experts) at full width and one
    period (8 layers, ~51.8 GB in bf16), random weights from
    ``torch.Generator`` seed 0, serve-hybrid's engine and prompts (paged,
    4 slots, max_seq 1024, 8 prompts of 100-600 tokens, 64 new tokens),
    then a profiled decode window (the expert products' device time from
    the profile's bmm ops: ``expert_device_s``) and the host syncs a
    tick.  The weights are freed before it returns."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import build_model
    from repro_torch.serving import Request
    cfg = dataclasses.replace(REGISTRY[JAMBA_MOE], num_layers=8)
    model = build_model(cfg, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nparam = model.param_count(params)
    print(f"[serve] serve-jamba-moe: {JAMBA_MOE} bf16, 8 layers, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.experts_per_token}: "
          f"{nparam / 1e9:.3f} B params, {nparam * 2 / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    path = {k: kernels[k] for k in ("paged_attention", "linear_scan",
                                    "mamba_scan_fused", "paged_prefill")}
    prompts = serve_prompts(cfg, 0, repeat_segment=False)
    eng, r = serve_run("serve-jamba-moe", model, params, prompts, path)
    r["params"] = nparam
    check(eng.prefill_bucket == 1 and not eng._suffix_reuse
          and eng._spec_k == 0, "serve-jamba-moe: the MoE hybrid must "
          "prefill at the exact length, without compute reuse or "
          "speculation")
    r["profile"] = p = profile_decode(eng, prompts[4:], Request,
                                      experts=cfg.moe.num_experts)
    unwatch(eng)
    r["syncs"] = syncs_per_tick("serve-jamba-moe", eng, prompts[4:],
                                Request)
    print(f"[serve] serve-jamba-moe: tok/s {r['tok_s']:.2f}; TTFT p50 "
          f"{r['ttft_s'][len(r['ttft_s']) // 2]:.4f} s, max "
          f"{r['ttft_s'][-1]:.4f} s; host tick {r['tick_s'] * 1e3:.2f} ms; "
          f"device {p['busy_ms_per_tick']:.4f} ms a tick (busy share "
          f"{p['busy_share']:.3f}), MoE expert products "
          f"{p['expert_ms_per_tick']:.4f} ms a tick "
          f"({p['expert_share']:.3f} of the device time); peak memory "
          f"{r['peak_memory_gb']:.3f} GB; host syncs a tick "
          f"{r['syncs']['per_tick']:.2f} ({card})")
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return r


def expert_device_s(prof, experts):
    """Device seconds of the MoE expert products in a profile recorded
    with input shapes: the kernels under every batched-matmul op whose
    operands are (E, rows, D) and (E, D, F) for ``experts`` = E (an op
    nested in another such op is counted with its parent)."""
    from torch.autograd import DeviceType

    def hit(e):
        sh = e.input_shapes or []
        return ("bmm" in e.name and len(sh) >= 2 and len(sh[0]) == 3
                and len(sh[1]) == 3 and sh[0][0] == sh[1][0] == experts)
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CPU and hit(e)
               and not (e.cpu_parent is not None and hit(e.cpu_parent))) \
        / 1e6


def profile_decode(eng, prompts, request_cls, experts=None):
    """Where a decode tick's time goes: a short served window (4 requests
    of 16 tokens, after the measured run) under ``torch.profiler``.
    Reports the device's busy share of the window's wall time and device
    time by kernel class; with ``experts`` (an MoE model's E) the profile
    also records input shapes, and the expert products' device time is
    read from it (``expert_device_s``).  Diagnostic only: a profiler that
    records no device time is reported, not failed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(100 + uid, p[:100], 16))
    eng.tick()                          # admissions outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=experts is not None) as prof:
        t0 = time.perf_counter()
        ticks = 0
        while eng.tick():
            ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the CPU op that launched
    # a kernel is credited with the same device time and is skipped
    by_kernel, n_kernels = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_kernel[evt.key] = (by_kernel.get(evt.key, 0.0)
                                  + evt.self_device_time_total / 1e6)
            n_kernels += evt.count
    expert = expert_device_s(prof, experts) if experts else 0.0
    classes = {"fused_paged_decode": 0.0, "paged_verify": 0.0,
               "paged_attention": 0.0, "linear_scan": 0.0,
               "mamba_scan_fused": 0.0, "gemm": 0.0,
               "copy": 0.0, "other": 0.0}
    for key, sec in by_kernel.items():
        low = key.lower()
        if "fused_decode" in key:          # the walk and its combine
            classes["fused_paged_decode"] += sec
        elif "paged_prefill" in key or "split_combine" in key:
            classes["paged_verify"] += sec     # the verify windows
        elif "paged_attention" in key:     # the walk and its combine
            classes["paged_attention"] += sec
        elif "linear_scan" in key:         # the vector or scalar path
            classes["linear_scan"] += sec
        elif "selective_scan" in key:
            classes["mamba_scan_fused"] += sec
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
    per_tick = {k: v * 1e3 / (ticks + 1) for k, v in classes.items()}
    print(f"[profile] device ms per decode tick: busy "
          f"{busy * 1e3 / (ticks + 1):.4f} over "
          f"{n_kernels / (ticks + 1):.1f} kernels, by class "
          f"{json.dumps({k: round(v, 4) for k, v in per_tick.items()})}")
    for key, sec in top:
        print(f"[profile]   {sec:.5f} s  {key[:90]}")
    print(f"[profile] host ops {sum(n for _, n, _ in host)} in the window; "
          f"device waits (s, calls): {json.dumps(waits)}")
    for sec, n, key in host[:10]:
        print(f"[profile]   host {sec:.5f} s  {n:6d} calls  {key[:70]}")
    if expert:
        print(f"[profile] MoE expert products: {expert:.4f} s of device "
              f"time ({expert / busy:.3f} of it), "
              f"{expert * 1e3 / (ticks + 1):.4f} ms a tick")
    return dict(ticks=ticks + 1, wall_s=wall, device_busy_s=busy,
                busy_share=busy / wall if wall else 0.0, classes=classes,
                per_tick_ms=per_tick,
                busy_ms_per_tick=busy * 1e3 / (ticks + 1),
                kernels_per_tick=n_kernels / (ticks + 1),
                expert_ms_per_tick=expert * 1e3 / (ticks + 1),
                expert_share=expert / busy if busy else 0.0,
                top=top, host_top=host[:10], waits=waits)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "yi-6b"
TRAIN_LAYERS = 8           # of 32: 1.91 B params, 22.9 GB with grads and m, v
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_WARMUP = 12, 2
GRAD_LAYERS = 2            # yi-6b's f32 gradient parity (~0.96 B params)
GRAD_TOL = 1e-4            # of a leaf's largest: the CPU tests' tolerance
COSINE_MIN = 0.99          # bf16 gradients against the f32 ones, per leaf
# flash gradient rows: name, B, H, Hkv, S, D, causal, window, softcap
GRAD_FLASH = (
    ("flash_attention_train", 4, 32, 4, 512, 128, True, 0, 0.0),
    # gemma2's D=256 with a window (its 4096 cut to 128, to bite at S=512)
    # and its softcap 50
    ("flash_attention_train_d256", 1, 16, 8, 512, 256, True, 128, 50.0),
    ("flash_attention_train_vit", 6, 3, 3, 197, 64, False, 0, 0.0),
    # a rank's heads of train-yi at model=2 (phase 10)
    ("flash_attention_train_tp2", 4, 16, 2, 512, 128, True, 0, 0.0),
)
GRAD_SCAN = (1, 128, 16384, 16)    # N, S, d_inner, d_state
# the kernels a training forward reaches on CUDA, and how each gets its
# gradient (every other kernel raises when asked for one)
GRAD_ROUTE = {
    "src/repro_torch/csrc/flash_attention.cu":
        "autograd.Function: kernel forward, backward through the plain "
        "version (ref.flash_attention_ref)",
    "src/repro_torch/csrc/selective_scan.cu":
        "autograd.Function: kernel forward, backward through the plain "
        "version (ref.mamba_scan_fused_ref)"}
# the f32-output products: yi-6b's MLP at train-yi's tokens, and an
# expert stack
GRAD_MATMULS = (("matmul_f32", "matmul_f32", (2048, 4096), (4096, 11008)),
                ("bmm_f32", "bmm_f32", (8, 512, 2048), (8, 2048, 1408)),
                # a rank's MLP product at model=2 (phase 10)
                ("matmul_f32_tp2", "matmul_f32", (2048, 4096), (4096, 5504)))


def grad_err(got, ref):
    """Largest |got - ref| over the largest |ref| (0 when both are 0)."""
    scale = float(ref.float().abs().max())
    return max_err(got, ref) / scale if scale else max_err(got, ref)


def _grads_of(fn, ins, g):
    out = fn(*ins)
    return out, torch.autograd.grad(out, ins, g)


def flash_grad_rows(dev, flush, results):
    """Flash's gradient route at the training shapes, f32 and bf16: the
    kernel forward inside ``_FlashAttention`` and its plain backward
    against autograd through the plain version on the same CUDA tensors;
    the forward within ``TOL``, each gradient within ``TOL`` of its
    largest.  Timed forward + backward (CUDA events, L2 flushed) beside
    the plain version's and SDPA's (K/V repeated to H heads beforehand,
    the window as a mask, no softcap; timed only)."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ref as TR
    F = torch.nn.functional
    for name, b, h, hk, s, d, causal, window, cap in GRAD_FLASH:
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(21 + d)
            q, k, v = (torch.randn((b, n, s, d), generator=gen, device=dev)
                       .to(dt).requires_grad_()
                       for n in (h, hk, hk))
            g = torch.randn((b, h, s, d), generator=gen, device=dev).to(dt)
            pos = torch.arange(s, dtype=torch.int32, device=dev)
            ones = torch.ones((s,), dtype=torch.int32, device=dev)
            kw = dict(causal=causal, window=window, softcap=cap)

            def kern():
                return _grads_of(lambda *t: TF.flash_attention_bhsd(
                    *t, pos, pos, ones, **kw), (q, k, v), g)

            def plain():
                return _grads_of(lambda *t: TR.flash_attention_ref(
                    *t, pos, pos, ones, **kw), (q, k, v), g)
            n0 = TF.flash_attention_bhsd.launches
            (out, grads), (pout, pgrads) = kern(), plain()
            torch.cuda.synchronize()
            check(TF.flash_attention_bhsd.launches == n0 + 1,
                  f"{name}: the gradient route must launch the kernel once")
            err = assert_close(name, out, pout, dt)
            gerr = max(grad_err(a, r) for a, r in zip(grads, pgrads))
            check(gerr <= TOL[dt], f"{name} {dt}: gradients {gerr:.3g} of "
                                   f"their largest from the plain version's")
            rel = pos[:, None] - pos[None, :]
            ok = (rel >= 0) if causal else torch.ones_like(rel, dtype=bool)
            if window:
                ok = ok & (rel < window)
            mask = ok if (window or not causal) else None
            g_rep = h // hk

            def lib():
                kr, vr = (t.repeat_interleave(g_rep, 1) for t in (k, v))
                return _grads_of(
                    lambda q_, k_, v_: F.scaled_dot_product_attention(
                        q_, k_, v_, attn_mask=mask,
                        is_causal=causal and mask is None),
                    (q, kr, vr), g)
            ms = bench(kern, flush)
            fwd_ms = bench(lambda: TF.flash_attention_bhsd(
                q.detach(), k.detach(), v.detach(), pos, pos, ones, **kw),
                flush)
            plain_ms = bench(plain, flush, iters=5, warmup=1)
            lib_ms = bench(lib, flush)
            pairs = int(ok.sum()) * b * h
            esz = q.element_size()
            nbytes = esz * (2 * q.numel() + 2 * g.numel()
                            + 2 * (k.numel() + v.numel()))
            bound, by = bound_ms(nbytes, 12 * d * pairs, dt)
            results[(name, dt)] = dict(
                max_abs_err=err, grad_err=gerr, ms=ms, fwd_ms=fwd_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
            print(f"[train] {name} {str(dt)[6:]} (B={b} H={h} Hkv={hk} "
                  f"S={s} D={d} causal={causal} window={window} "
                  f"softcap={cap}): forward + backward {ms:.4f} ms "
                  f"(kernel forward {fwd_ms:.4f}), plain {plain_ms:.4f}, "
                  f"sdpa {lib_ms:.4f}, bound {bound:.4f} ms ({by}); "
                  f"gradients {gerr:.3g} of their largest from the "
                  f"plain version's")
            del q, k, v, g, out, grads, pout, pgrads


def scan_grad_rows(dev, flush, results, shape=GRAD_SCAN,
                   name="mamba_scan_fused_train"):
    """The selective scan's gradient route (mamba's training prefill):
    the kernel forward inside ``_SelectiveScan`` and its plain backward
    against autograd through ``ref.mamba_scan_fused_ref``, f32, at
    ``shape`` (N, S, d_inner, d_state), as row ``name``."""
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels import selective_scan as TS
    n_, s, di, n = shape
    gen = torch.Generator(device=dev).manual_seed(5)

    def t(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)
    ins = [(0.05 * t(n_, s, di)).abs(), t(n_, s, di), t(n_, s, n),
           t(n_, s, n), -t(di, n).abs()]
    ins = [x.requires_grad_() for x in ins]
    gy, gh = t(n_, s, di), t(n_, di, n)

    def run(fn):
        y, hl = fn(*ins)
        return (y, hl), torch.autograd.grad((y, hl), ins, (gy, gh))
    n0 = TS.mamba_scan_fused.launches
    (outs, grads), (pouts, pgrads) = run(TS.mamba_scan_fused), \
        run(TR.mamba_scan_fused_ref)
    torch.cuda.synchronize()
    check(TS.mamba_scan_fused.launches == n0 + 1,
          "the scan's gradient route must launch the kernel once")
    err = max(max_err(a, r) for a, r in zip(outs, pouts))
    gerr = max(grad_err(a, r) for a, r in zip(grads, pgrads))
    check(err <= 1e-5 and gerr <= 1e-5,
          f"selective scan gradient route: outputs {err:.3g}, gradients "
          f"{gerr:.3g} of their largest")
    ms = bench(lambda: run(TS.mamba_scan_fused), flush, iters=5, warmup=1)
    fwd_ms = bench(lambda: TS.mamba_scan_fused(
        *[x.detach() for x in ins]), flush)
    plain_ms = bench(lambda: run(TR.mamba_scan_fused_ref), flush, iters=5,
                     warmup=1)
    nbytes = 4 * (6 * n_ * s * di + 6 * n_ * s * n + 2 * di * n
                  + 2 * n_ * di * n)
    bound, by = bound_ms(nbytes, 21 * n_ * s * di * n, torch.float32)
    results[(name, torch.float32)] = dict(
        max_abs_err=err, grad_err=gerr, ms=ms, fwd_ms=fwd_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    print(f"[train] {name} f32 (N={n_} S={s} "
          f"d_inner={di} d_state={n}): forward + backward {ms:.4f} ms "
          f"(kernel forward {fwd_ms:.4f}), plain {plain_ms:.4f}, bound "
          f"{bound:.4f} ms ({by}); outputs {err:.3g}, gradients {gerr:.3g} "
          f"of their largest from the plain version's")


def matmul_grad_rows(dev, flush):
    """``matmul_f32``/``bmm_f32`` on bf16 operands (the ``_MatmulF32``
    Function around cuBLAS's f32-output products; its backward keeps the
    f32 cotangent as three bf16 terms) against autograd through the f32
    plain products on the widened operands: the output within 1e-5 of its
    largest; each gradient equal to the bf16 cast of the plain f32 one
    but for flips of the cast's last bit (at most 1% of the elements, each
    at most one bf16 step of the largest; a cotangent rounded to bf16
    before the products differs on about 40%).  cuBLAS is no kernel of
    the port; timed beside the bf16 ``torch.matmul`` (fwd + bwd, bf16
    output)."""
    from repro_torch.models import layers as TL
    rows = {}
    for name, fn_name, xs, ws in GRAD_MATMULS:
        gen = torch.Generator(device=dev).manual_seed(9)
        x = torch.randn(xs, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        w = (torch.randn(ws, generator=gen, device=dev)
             / ws[-2] ** 0.5).to(torch.bfloat16).requires_grad_()
        g = torch.randn(xs[:-1] + ws[-1:], generator=gen, device=dev)
        fn = getattr(TL, fn_name)
        out, grads = _grads_of(fn, (x, w), g)
        xf, wf = (t.detach().float().requires_grad_() for t in (x, w))
        pout, pgrads = _grads_of(torch.matmul, (xf, wf), g)
        err = grad_err(out, pout)
        gerr = max(grad_err(a.float(), r) for a, r in zip(grads, pgrads))
        cast = [r.to(torch.bfloat16) for r in pgrads]
        flips = max(float((a != c).float().mean())
                    for a, c in zip(grads, cast))
        step = max(grad_err(a.float(), c.float())
                   for a, c in zip(grads, cast))
        check(out.dtype == torch.float32
              and all(a.dtype == torch.bfloat16 for a in grads),
              f"{name}: f32 output, gradients in the operands' bf16")
        check(err <= 1e-5 and flips <= 0.01 and step <= 2.0 ** -7,
              f"{name}: output {err:.3g} of its largest from the f32 "
              f"product's; gradients differ from the bf16 cast of the f32 "
              f"ones on {flips:.3g} of their elements, by up to {step:.3g} "
              f"of their largest")
        ms = bench(lambda: _grads_of(fn, (x, w), g), flush)
        plain_ms = bench(lambda: _grads_of(torch.matmul, (xf, wf), g), flush)
        lib_ms = bench(lambda: _grads_of(torch.matmul, (x, w),
                                         g.to(torch.bfloat16)), flush)
        rows[name] = dict(err=err, grad_err=gerr, cast_flips=flips, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms)
        print(f"[train] {name} x{tuple(xs)} w{tuple(ws)} bf16: forward + "
              f"backward {ms:.4f} ms, f32 plain products {plain_ms:.4f}, "
              f"bf16 torch.matmul {lib_ms:.4f}; output {err:.3g}, gradients "
              f"{gerr:.3g} of their largest from the f32 products', "
              f"{flips:.3g} of their elements off the bf16 cast of those")
    return rows


def model_grad_phase(dev, kernels):
    """Model gradients on the card against the host's plain path on the
    same weights: yi-6b at published width with ``GRAD_LAYERS`` layers in
    f32 (remat on the card, none on the host) and a reduced-width jamba
    hybrid period (one attention and seven mamba layers, head_dim 64) in
    f32, loss within 1e-5 relative and every leaf within ``GRAD_TOL`` of
    its largest; then yi's bf16 gradients against the card's f32 ones,
    cosine similarity >= ``COSINE_MIN`` leaf by leaf."""
    from repro_torch import tree as TT
    from repro_torch.configs import REGISTRY, ShapeConfig, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.training.trainer import value_and_grad
    out = {}
    yi = dataclasses.replace(REGISTRY[TRAIN_ARCH], num_layers=GRAD_LAYERS,
                             dtype="float32", param_dtype="float32")
    hy = dataclasses.replace(
        reduced(REGISTRY["jamba-1.5-large-398b-dense-ffn"], layers=8,
                d_model=256, vocab=1024), head_dim=64)
    for label, cfg, (b, s) in ((TRAIN_ARCH, yi, (2, 128)),
                               ("jamba-hybrid-reduced", hy, (2, 64))):
        gpu = build_model(cfg, dev)
        params = gpu.init(torch.Generator(device=dev).manual_seed(0))
        batch = SyntheticLM(cfg, ShapeConfig("t", s, b, "train")).batch_at(0)
        counts0 = {k: f.launches for k, f in kernels.items()}
        loss, grads = value_and_grad(gpu, params, batch, remat=True)
        torch.cuda.synchronize()
        launched = {k: f.launches - counts0[k] for k, f in kernels.items()
                    if f.launches != counts0[k]}
        host = build_model(cfg, "cpu")
        t0 = time.perf_counter()
        hloss, hgrads = value_and_grad(host, params_to(params, "cpu"),
                                       batch, remat=False)
        host_s = time.perf_counter() - t0
        lerr = abs(float(loss) - float(hloss)) / abs(float(hloss))
        worst = max(grad_err(a.cpu(), r)
                    for a, r in zip(TT.leaves(grads), TT.leaves(hgrads)))
        print(f"[train] {label} f32 ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, B={b} S={s}) gradients on the card (remat) "
              f"vs the host's plain path: loss {float(loss):.6f} vs "
              f"{float(hloss):.6f} (rel {lerr:.3g}), worst leaf "
              f"{worst:.3g} of its largest over "
              f"{len(TT.leaves(grads))} leaves; kernels launched "
              f"{json.dumps(launched)}; host {host_s:.1f} s")
        check(np.isfinite(float(loss)) and lerr <= 1e-5,
              f"{label}: card loss {float(loss)} vs host {float(hloss)}")
        check(worst <= GRAD_TOL, f"{label}: a gradient leaf is {worst:.3g} "
                                 f"of its largest from the host's")
        need = {"flash_attention"} | ({"mamba_scan_fused"}
                                      if cfg.family == "hybrid" else set())
        check(need <= set(launched), f"{label}: the training forward must "
                                     f"launch {sorted(need)}: {launched}")
        out[label] = dict(loss=float(loss), host_loss=float(hloss),
                          loss_rel_err=lerr, worst_leaf=worst,
                          launches=launched, host_s=host_s)
        if label == TRAIN_ARCH:
            bcfg = dataclasses.replace(cfg, dtype="bfloat16",
                                       param_dtype="bfloat16")
            # the bf16 config's layout: matrices in bf16, norms in f32
            bparams = TT.tree_map(lambda t: t.to(torch.bfloat16)
                                  if t.dim() >= 2 else t, params)
            bloss, bgrads = value_and_grad(build_model(bcfg, dev), bparams,
                                           batch, remat=True)
            cos = [float(torch.nn.functional.cosine_similarity(
                       a.float().flatten(), r.flatten(), dim=0))
                   for a, r in zip(TT.leaves(bgrads), TT.leaves(grads))]
            print(f"[train] {label} bf16 gradients vs the card's f32: loss "
                  f"{float(bloss):.6f}, cosine similarity min "
                  f"{min(cos):.5f}, median {float(np.median(cos)):.5f} over "
                  f"{len(cos)} leaves")
            check(min(cos) >= COSINE_MIN,
                  f"bf16 gradients: cosine {min(cos):.4f} < {COSINE_MIN}")
            out["bf16_cosine_min"] = min(cos)
            out["bf16_loss"] = float(bloss)
            del bparams, bgrads
        del gpu, params, grads, hgrads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_yi_flops(cfg, b, s):
    """Model FLOPs a step: 6 x multiplying params x tokens, plus causal
    attention's 6 * S^2 * H * D a layer and sequence (half of the full
    score and value products, forward and backward)."""
    attn = 2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
    mlp = 3 * cfg.d_model * cfg.d_ff
    mult = cfg.num_layers * (attn + mlp) + cfg.d_model * cfg.vocab_size
    return (6 * mult * b * s
            + 6 * s * s * cfg.num_heads * cfg.head_dim * cfg.num_layers * b)


def train_yi_phase(dev, kernels, card):
    """train-yi: yi-6b at published width, ``TRAIN_LAYERS`` layers, bf16,
    remat, B x S tokens of ``SyntheticLM`` (seed 0), AdamW at the CLI's
    settings, ``TRAIN_STEPS`` steps through ``make_train_step``: step ms
    (median after the warm-up), tokens/s, model TFLOP/s and its share of
    989, peak memory, the loss at every step (finite); flash launches a
    step must be layers x 2 (the forward and remat's recompute).  Then a
    profiled step (device time, busy share, kernels), one step split into
    loss + gradients and the AdamW update (CUDA events), the training
    CLI on the card (``--layers 1``), and a ``CheckpointManager`` save and
    restore of the trained params and step, bit-equal."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import REGISTRY, ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.training.trainer import value_and_grad
    flash = kernels["flash_attention"]
    cfg = dataclasses.replace(REGISTRY[TRAIN_ARCH], num_layers=TRAIN_LAYERS)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(warmup_steps=10, total_steps=max(TRAIN_STEPS, 100))
    state = opt.init(params)
    data = SyntheticLM(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"), seed=0)
    step_fn = make_train_step(model, opt, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    launches0 = flash.launches
    for i in range(TRAIN_STEPS):
        n0 = flash.launches
        t0 = time.perf_counter()
        params, state, met = step_fn(params, state, data.batch_at(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(flash.launches - n0)
        losses.append(float(met["loss"]))
    launches = flash.launches - launches0
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = float(np.median(times[TRAIN_WARMUP:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_yi_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound = flops / PEAK_OPS[torch.bfloat16]
    check(all(np.isfinite(losses)), f"train-yi: losses {losses}")
    check(all(n == 2 * TRAIN_LAYERS for n in per_step),
          f"train-yi: flash launches a step {per_step}, expected "
          f"{2 * TRAIN_LAYERS} (forward + remat's recompute)")
    batch = data.batch_at(TRAIN_STEPS)
    prof = profile_forward(lambda: step_fn(params, state, batch), reps=2)
    s, m, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s.record()
    _, grads = value_and_grad(model, params, batch, remat=True)
    m.record()
    opt.update(grads, state, params)
    e.record()
    torch.cuda.synchronize()
    del grads
    res = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
               model_tflops=flops / step_s / 1e12,
               mfu=flops / step_s / PEAK_OPS[torch.bfloat16],
               bound_ms=bound * 1e3, peak_gb=peak, losses=losses,
               step_times_ms=[t * 1e3 for t in times],
               flash_launches_per_step=per_step[0], flash_launches=launches,
               grad_ms=s.elapsed_time(m), update_ms=m.elapsed_time(e),
               **{f"profile_{k}": v for k, v in prof.items()},
               model_tflop_a_step=flops / 1e12, card=card)
    print(f"[train] train-yi ({card}): yi-6b at published width, "
          f"{TRAIN_LAYERS} layers, bf16, remat, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}: step {res['step_ms']:.2f} ms (median of "
          f"{TRAIN_STEPS - TRAIN_WARMUP} after {TRAIN_WARMUP} warm-up), "
          f"{res['tokens_per_s']:.1f} tokens/s, {res['model_tflops']:.2f} "
          f"model TFLOP/s ({100 * res['mfu']:.2f}% of 989; "
          f"{flops / 1e12:.2f} TFLOP a step, bound {bound * 1e3:.2f} ms), "
          f"peak {peak:.3f} GB")
    print(f"[train] train-yi losses: "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    print(f"[train] train-yi step: loss + gradients {res['grad_ms']:.2f} ms, "
          f"AdamW update {res['update_ms']:.2f} ms (events); profiled: "
          f"device {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} "
          f"(busy {prof['busy_share']:.3f}), {prof['kernels']:.0f} kernels "
          f"a step; flash launches {per_step[0]} a step ({launches} in "
          f"{TRAIN_STEPS} steps)")
    # the CLI on the card, published width at one layer
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--arch", TRAIN_ARCH, "--layers", "1", "--steps",
                        "2", "--seq", "128", "--batch", "2", "--device",
                        dev])
    lines = buf.getvalue().splitlines()
    check(lines and lines[-1] == "[train] done",
          f"the training CLI on the card: {lines}")
    print(f"[train] launch.train --layers 1 on the card: "
          f"{' | '.join(lines)} ({time.perf_counter() - t0:.1f} s)")
    # checkpoint the trained params and step
    ckpt = os.path.join(HERE, "build", "train_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(ckpt, keep=1)
    tree = {"params": params, "step": state.step, "data_step": TRAIN_STEPS}
    t0 = time.perf_counter()
    mgr.save(tree, TRAIN_STEPS)
    mgr.wait()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, step = mgr.restore_latest(tree)
    restore_s = time.perf_counter() - t0
    from repro_torch import tree as TT
    same = all(torch.equal(a, b) for a, b in zip(TT.leaves(back["params"]),
                                                 TT.leaves(params)))
    check(step == TRAIN_STEPS and same and torch.equal(back["step"],
                                                       state.step)
          and int(back["data_step"]) == TRAIN_STEPS,
          "train-yi checkpoint: restored state differs")
    gb = sum(t.numel() * t.element_size() for t in TT.leaves(params)) / 1e9
    print(f"[train] checkpoint of train-yi's params ({gb:.2f} GB) and step: "
          f"save {save_s:.1f} s, restore {restore_s:.1f} s, bit-equal")
    shutil.rmtree(ckpt, ignore_errors=True)
    res.update(ckpt_gb=gb, ckpt_save_s=save_s, ckpt_restore_s=restore_s)
    del model, params, state, back, tree
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_phase(dev, kernels, card):
    """Phase 8: the kernels' gradient routes, model gradients, train-yi."""
    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    results = {}
    flash_grad_rows(dev, flush, results)
    scan_grad_rows(dev, flush, results)
    matmuls = matmul_grad_rows(dev, flush)
    del flush
    torch.cuda.empty_cache()
    print(f"[train] kernel gradients {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    grads = model_grad_phase(dev, kernels)
    print(f"[train] model gradients {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    run = train_yi_phase(dev, kernels, card)
    print(f"[train] train-yi {time.perf_counter() - t1:.1f} s")
    print(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return dict(kernels=results, matmuls=matmuls, model_grads=grads,
                train_yi=run)


# ---------------------------------------------------------------------------
# phase 9: placement -- the SSR pipeline executor over a device mesh
# ---------------------------------------------------------------------------

PLACE_ARCH = "yi-6b"
PLACE_TOL = 1e-4               # of Model.forward's largest |logit|, f32
PLACE_PARITY_LAYERS = 4
PLACE_PARITY_SHAPE = (8, 128)  # B, S
PLACE_RUN_SHAPE = (8, 512)
PLACE_ULPS = 4                 # a position's top-2 gap that decides argmax


def place_tokens(cfg, shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(1, cfg.vocab_size, shape, generator=gen,
                         device=dev)


def placement_parity(dev, flash):
    """Phase 9, f32 at published width: yi-6b, 4 layers (4 groups),
    weights from ``torch.Generator`` seed 0, B=8, S=128, through
    ``plan_forward`` on ``make_plan_mesh(plan, devices=[cuda:0] * 2)``:
    the uneven 3 | 1 cut (``ssr_dse`` + ``lower(mesh_devices=2,
    n_microbatches=4)``), the same assignment at 2 microbatches x 2
    rounds, and ``pipeline_forward(n_stages=2, n_microbatches=4)``.  Each
    plan's logits within ``PLACE_TOL`` of ``Model.forward``'s, relative to
    its largest |logit|; flash launched exactly once an attention layer
    and microbatch (the padded group launches nothing)."""
    from repro_torch.configs import REGISTRY, ShapeConfig
    from repro_torch.core import build_graph, ssr_dse
    from repro_torch.core.hw import H100
    from repro_torch.launch.mesh import make_pipeline_mesh, make_plan_mesh
    from repro_torch.models import build_model
    from repro_torch.pipeline import pipeline_forward, plan_forward
    from repro_torch.plan import lower
    cfg = dataclasses.replace(REGISTRY[PLACE_ARCH],
                              num_layers=PLACE_PARITY_LAYERS,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    b, s = PLACE_PARITY_SHAPE
    batch = {"tokens": place_tokens(cfg, (b, s), dev, 1)}
    ref, _ = model.forward(params, batch)
    scale = float(ref.abs().max())
    graph = build_graph(cfg, ShapeConfig("placement", s, b, "prefill"))
    # the embed and the first three layers on acc 0, the last layer and
    # the head on acc 1: groups 3 | 1
    acc_of = (0,) * cfg.num_layers + (1, 1)
    _, _, assign = ssr_dse(graph, acc_of, 2, n_batches=2, hw=H100)
    slots = [torch.device(dev)] * 2
    runs = {"uneven": lower(assign, graph, mesh_devices=2,
                            n_microbatches=4),
            "rounds": lower(assign, graph, mesh_devices=2,
                            n_microbatches=2, n_rounds=2)}
    attn = sum(b.mixer.startswith("attn") for b in cfg.block_pattern) \
        * cfg.num_groups
    out = {}
    for name, plan in list(runs.items()) + [("pipeline", None)]:
        flash.launches = 0
        if plan is None:
            mesh = make_pipeline_mesh(2, model=1, total=2, devices=slots)
            got = pipeline_forward(model, params, batch, mesh, n_stages=2,
                                   n_microbatches=4)
            groups, total = [2, 2], 4
        else:
            check(not plan.is_uniform and plan.n_stages == 2,
                  f"placement {name}: not an uneven 2-stage plan")
            mesh = make_plan_mesh(plan, devices=slots)
            got = plan_forward(model, params, batch, mesh, plan)
            groups = [st.n_groups for st in plan.stages]
            total = plan.total_microbatches
        torch.cuda.synchronize()
        n = flash.launches
        rel = max_err(got, ref) / scale
        out[name] = dict(groups=groups, microbatches=total, rel_err=rel,
                         launches=n)
        print(f"[place] {PLACE_ARCH} f32 {cfg.num_layers} layers B={b} "
              f"S={s} {name}: groups {groups}, {total} microbatches on "
              f"{mesh}: max |logits - Model.forward| / max |logit| = "
              f"{rel:.3g} (tol {PLACE_TOL}); flash launches {n} "
              f"(= {attn} attention layers x {total})")
        check(rel <= PLACE_TOL, f"placement {name}: logits off by {rel:.3g}")
        check(n == attn * total, f"placement {name}: flash launched {n} "
                                 f"times, not {attn * total}")
    del model, params, ref, got
    torch.cuda.empty_cache()
    return out


def placement_run(dev, flash, card):
    """Phase 9, bf16 at full depth: yi-6b at published size (32 layers,
    12.1 GB), weights from ``torch.Generator`` seed 0, B=8, S=512, through
    the uneven 2-stage plan the search gives for this shape (``ssr_dse``
    on the contiguous 2-accelerator cut, ``hw=H100``; ``lower(
    mesh_devices=2, n_microbatches=4, n_rounds=2)``) with both slots on
    the card: flash launched 32 x 8 times, every logit finite, the argmax
    equal to ``Model.forward``'s wherever its top-2 gap exceeds
    ``PLACE_ULPS`` bf16 ulps of the top logit, and the runner on
    device-resident inputs free of host syncs (sync debug mode "error").
    Printed with the card: ``plan_forward`` and ``Model.forward`` ms
    (CUDA events, median of 5 after a warm-up), each one's device ms,
    busy share and kernels a call (a profiled window of 2), ``measure_plan``'s
    composed makespan and ``predict_plan(hw=H100)`` for the plan, peak
    memory.  One card runs the two slots in turn, so the composed
    makespan, which assumes concurrent stages, is a prediction it cannot
    meet: the gap is printed, not checked.  Then ``place_params`` on a
    uniform 2-stage plan over the same two slots passes the params
    through (one distinct device)."""
    from repro_torch.configs import REGISTRY, ShapeConfig
    from repro_torch.core import build_graph, ssr_dse
    from repro_torch.core.assignment import contiguous_assignment
    from repro_torch.core.hw import H100
    from repro_torch.launch.mesh import make_plan_mesh
    from repro_torch.models import build_model
    from repro_torch.pipeline import (make_plan_runner, plan_forward,
                                      plan_stage_params)
    from repro_torch.plan import lower, uniform_plan
    from repro_torch.plan.serving import place_params
    from repro_torch.plan.validate import _embed, measure_plan, predict_plan
    cfg = REGISTRY[PLACE_ARCH]
    model = build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    b, s = PLACE_RUN_SHAPE
    batch = {"tokens": place_tokens(cfg, (b, s), dev, 2)}
    graph = build_graph(cfg, ShapeConfig("placement", s, b, "prefill"))
    _, _, assign = ssr_dse(graph, contiguous_assignment(graph, 2, 2).acc_of,
                           2, n_batches=2, hw=H100)
    plan = lower(assign, graph, mesh_devices=2, n_microbatches=4,
                 n_rounds=2)
    print(f"[place] {PLACE_ARCH} bf16 plan for B={b} S={s}: "
          f"{plan.describe()}")
    check(plan.n_stages == 2 and not plan.is_uniform,
          "placement: the search's plan is not an uneven 2-stage plan")
    mesh = make_plan_mesh(plan, devices=[torch.device(dev)] * 2)
    ref, _ = model.forward(params, batch)
    flash.launches = 0
    got = plan_forward(model, params, batch, mesh, plan)
    torch.cuda.synchronize()
    n = flash.launches
    total = plan.total_microbatches
    attn = cfg.num_layers
    finite = bool(torch.isfinite(got).all())
    top = torch.topk(ref, 2, dim=-1).values
    decided = (top[..., 0] - top[..., 1]) > PLACE_ULPS * bf16_ulp(
        top[..., 0])
    same = got.argmax(-1) == ref.argmax(-1)
    wrong = int((decided & ~same).sum())
    dmax = max_err(got, ref)
    print(f"[place] {PLACE_ARCH} bf16 32 layers B={b} S={s} plan_forward: "
          f"flash launches {n} (= {attn} x {total}); finite {finite}; "
          f"argmax equal to Model.forward's at {int((decided & same).sum())}"
          f" of {int(decided.sum())} decided positions ({b * s} in all; "
          f"{int(same.sum())} equal overall), max |dlogit| {dmax:.4g}")
    check(n == attn * total, f"placement bf16: flash launched {n} times")
    check(finite, "placement bf16: non-finite logits")
    check(wrong == 0, f"placement bf16: {wrong} decided positions differ")
    del got, ref, top, decided, same

    x_mb = _embed(model, params, batch).reshape(total, b // total, s, -1)
    staged = plan_stage_params(params["stack"], plan)
    mask = plan.group_mask_matrix()
    runner = make_plan_runner(cfg, mesh, plan)
    runner(staged, mask, x_mb)
    torch.cuda.synchronize()
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = runner(staged, mask, x_mb)
    except RuntimeError as e:
        err = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[syncs] placement: make_plan_runner's {plan.n_stages} stages x "
          f"{total} microbatches under sync debug mode 'error': "
          f"{'no host sync' if err is None else err}")
    check(err is None, "placement: the plan runner synced the host")
    del y, x_mb

    plan_ms = event_ms(lambda: plan_forward(model, params, batch, mesh,
                                            plan), iters=5, warmup=1)
    fwd_ms = event_ms(lambda: model.forward(params, batch)[0], iters=5,
                      warmup=1)
    prof = {name: profile_forward(fn, reps=2) for name, fn in (
        ("plan_forward", lambda: plan_forward(model, params, batch, mesh,
                                              plan)),
        ("forward", lambda: model.forward(params, batch)[0]))}
    meas = measure_plan(model, params, batch, plan, check=False)
    pred = predict_plan(plan, graph, hw=H100)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[place] {PLACE_ARCH} bf16 32 layers B={b} S={s}: plan_forward "
          f"{plan_ms:.3f} ms, Model.forward {fwd_ms:.3f} ms "
          f"({plan_ms / fwd_ms:.3f}x); measure_plan composed makespan "
          f"{meas['makespan_s'] * 1e3:.3f} ms (stages "
          f"{[round(t * 1e3, 3) for t in meas['per_stage_s']]} ms a "
          f"microbatch, concurrent stages assumed: plan_forward takes "
          f"{plan_ms / (meas['makespan_s'] * 1e3):.3f}x it on one card); "
          f"predict_plan(hw=H100) makespan {pred['makespan_s'] * 1e3:.3f} "
          f"ms; peak memory {peak:.3f} GB ({card})")
    for name, p in prof.items():
        print(f"[place] {name} profiled (2 calls): device {p['device_ms']:.3f}"
              f" ms a call (busy share {p['busy_share']:.3f}), "
              f"{p['kernels']:.0f} kernels a call, wall {p['wall_ms']:.3f} "
              f"ms a call ({card})")
    check(np.isfinite(meas["makespan_s"]) and meas["makespan_s"] > 0,
          "placement: measure_plan gave no makespan")

    uni = uniform_plan(cfg.num_groups, 2, n_microbatches=2)
    placed, pmesh = place_params(params, uni,
                                 devices=[torch.device(dev)] * 2)
    through = placed is params and pmesh is None
    print(f"[place] place_params(uniform 2-stage plan, [{dev}] * 2): "
          f"{'passed through' if through else pmesh}")
    check(through, "placement: place_params moved params on one card")
    res = dict(plan=plan.describe(), launches=n, finite=finite,
               wrong_argmax=wrong, max_dlogit=dmax, plan_ms=plan_ms,
               forward_ms=fwd_ms, measured_makespan_ms=meas["makespan_s"]
               * 1e3, measured_stage_ms=[t * 1e3
                                         for t in meas["per_stage_s"]],
               predicted_makespan_ms=pred["makespan_s"] * 1e3,
               peak_memory_gb=peak, profile=prof)
    del model, params, placed
    gc.collect()
    torch.cuda.empty_cache()
    return res


def placement_phase(dev, kernels, card):
    """Phase 9: the SSR pipeline executor over a device mesh."""
    t0 = time.perf_counter()
    flash = kernels["flash_attention"]
    parity = placement_parity(dev, flash)
    run = placement_run(dev, flash, card)
    print(f"[place] phase {time.perf_counter() - t0:.1f} s")
    return dict(parity=parity, run=run)


# ---------------------------------------------------------------------------
# phase 10: sharded training -- two ranks on the one card over gloo
# ---------------------------------------------------------------------------

SHARD_ARCH = "yi-6b"
SHARD_RANKS = 2
SHARD_TOL = 1e-4              # loss (absolute), grad_norm (relative), params
SHARD_PARITY_LAYERS = 1       # f32, ~0.70 B params (one layer: time)
SHARD_PARITY_SHAPE = (4, 128)  # B, S
SHARD_PARITY_MESHES = ((1, 2), (2, 1))
# AdamW for the params' parity: at the default eps (1e-8) the first steps
# normalize every gradient element to about lr whatever its size, so the
# f32 summation-order noise of a near-zero element moves its update by up
# to 2 lr (on one H100, after two steps: 0.003-0.012 of a leaf's largest
# sharded, 4e-4 for the unsharded step on its batch rows reversed, with
# loss and grad_norm equal to 2e-6); at eps 1e-4, above most clipped
# gradient elements (~3e-5), the update follows the gradient and the
# params agree to 2e-5 of a leaf's largest
SHARD_OPT = dict(lr=1e-2, eps=1e-4, warmup_steps=1, total_steps=10)
# AdamW's default lr and eps, one (1, 2) reading beside the unsharded
# step's own spread under another f32 summation order (its batch rows
# reversed), the witness for the diagnosis above
SHARD_OPT_DEFAULT = dict(warmup_steps=1, total_steps=10)
SHARD_RUN_LAYERS = 4          # bf16, remat, mesh (1, 2)
SHARD_RUN_SHAPE = (4, 512)
SHARD_STEPS, SHARD_WARMUP = 6, 2
SHARD_TIMEOUT = 300           # s, both ranks together
SHARD_PROBE = ("all_reduce", "all_reduce_max", "broadcast",
               "all_gather_into_tensor", "all_gather", "reduce_scatter_tensor",
               "all_to_all_single", "barrier")
# point to point: each rank and its partner (rank ^ 1) swap a tensor
P2P_PROBE = ("send_recv", "isend_irecv", "batch_isend_irecv")


def gloo_probe(dev, names=SHARD_PROBE):
    """Which of ``names`` the live gloo group takes on CUDA tensors, each
    tried once on every rank with its result checked: "ok", or the error
    (this is a probe: the collectives module picks its transport from
    the backend's name and never by catching an error).  The point to
    point ops (``P2P_PROBE``) need an even world: rank r swaps with
    rank r ^ 1, the even rank sending first."""
    import torch.distributed as dist
    world = dist.get_world_size()
    rank = dist.get_rank()
    peer = rank ^ 1
    out = {}
    for name in names:
        x = torch.full((8,), float(rank + 1), device=dev)
        want = None
        try:
            if name in P2P_PROBE:
                y = torch.empty_like(x)
                want = torch.full_like(x, float(peer + 1))
                if name == "send_recv":
                    for op in ((dist.send, x), (dist.recv, y))[::(
                            1 if rank % 2 == 0 else -1)]:
                        op[0](op[1], peer)
                elif name == "isend_irecv":
                    works = [dist.isend(x, peer), dist.irecv(y, peer)]
                    for w in works:
                        w.wait()
                else:
                    for w in dist.batch_isend_irecv(
                            [dist.P2POp(dist.isend, x, peer),
                             dist.P2POp(dist.irecv, y, peer)]):
                        w.wait()
            elif name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                want = torch.full_like(x, world * (world + 1) / 2)
            elif name == "all_reduce_max":
                y = x.clone()
                dist.all_reduce(y, op=dist.ReduceOp.MAX)
                want = torch.full_like(x, float(world))
            elif name == "broadcast":
                y = x.clone()
                dist.broadcast(y, 0)
                want = torch.ones_like(x)
            elif name == "all_gather_into_tensor":
                y = torch.empty(8 * world, device=dev)
                dist.all_gather_into_tensor(y, x)
                want = torch.arange(1, world + 1, device=dev,
                                    dtype=x.dtype).repeat_interleave(8)
            elif name == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                y, want = torch.cat(parts), torch.arange(
                    1, world + 1, device=dev,
                    dtype=x.dtype).repeat_interleave(8)
            elif name == "reduce_scatter_tensor":
                y = torch.empty(8 // world, device=dev)
                dist.reduce_scatter_tensor(y, x)
                want = torch.full_like(y, world * (world + 1) / 2)
            elif name == "all_to_all_single":
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                want = torch.arange(1, world + 1, device=dev,
                                    dtype=x.dtype).repeat_interleave(
                                        8 // world)
            else:
                dist.barrier()
                y = want = x
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(y, want) else "wrong result"
        except Exception as e:   # the probe's question is whether it raises
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _shard_cfg(layers, dtype):
    from repro_torch.configs import REGISTRY
    return dataclasses.replace(REGISTRY[SHARD_ARCH], num_layers=layers,
                               dtype=dtype, param_dtype=dtype)


def _shard_errs(sharded, full, dm, relative=True):
    """Largest |shard - its block of the full leaf| over the full leaf's
    largest |value| (``relative``; else as it is), the max over this
    rank's leaves (``full`` in the port's layout; its blocks cut as the
    DTensors are placed, on this rank, no communication)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import sharding as S
    from repro_torch.sharding.execute import flat
    errs = []
    want = flat(S.stacked(full))
    for k, t in flat(sharded).items():
        ref = want[k]
        block = distribute_tensor(ref, dm, t.placements,
                                  src_data_rank=None).to_local()
        errs.append(max_err(t.to_local(), block)
                    / (max(float(ref.float().abs().max()), 1e-30)
                       if relative else 1.0))
    return max(errs)


def _worst_element(sharded, full, grads, dm):
    """Where this rank's shards of ``sharded`` stray furthest from their
    blocks of ``full`` (the port's layout), relative to the leaf's largest
    |value|: (that share, the leaf, |the difference|, |the sharded last
    gradient ``grads``| there, that leaf's largest |gradient| on this
    rank)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import sharding as S
    from repro_torch.sharding.execute import flat
    want, g_got = flat(S.stacked(full)), flat(grads)
    best = (0.0, "", 0.0, 0.0, 0.0)
    for k, t in flat(sharded).items():
        ref = distribute_tensor(want[k], dm, t.placements,
                                src_data_rank=None).to_local()
        d = (t.to_local() - ref).abs().reshape(-1)
        j = int(d.argmax())
        rel = float(d[j]) / max(float(want[k].abs().max()), 1e-30)
        if rel > best[0]:
            g = g_got[k].to_local().reshape(-1)
            best = (rel, "/".join(k), float(d[j]), float(g[j].abs()),
                    float(g.abs().max()))
    return best


def _tree_err(got, want):
    """Largest |got - want| over the leaf's largest |want|, the max over
    two full trees' leaves."""
    from repro_torch import tree as TR
    return max(max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(TR.leaves(got), TR.leaves(want)))


def _two_steps(step, opt, params, batches):
    """``step`` from ``params`` and fresh AdamW state over ``batches``:
    (params, [(loss, grad_norm)])."""
    p, st, mets = params, opt.init(params), []
    for bt in batches:
        p, st, met = step(p, st, bt)
        mets.append((float(met["loss"]), float(met["grad_norm"])))
    return p, mets


def shard_parity(dev, rank, dmeshes, out):
    """f32 yi-6b (``SHARD_PARITY_LAYERS`` layers, published width), the
    same weights (``torch.Generator`` seed 0) and ``SyntheticLM`` batches
    everywhere: the unsharded ``make_train_step`` (on each rank, so that
    each holds its shards to their blocks of it without a gather), and
    ``sharded_train_step`` on each mesh of ``SHARD_PARITY_MESHES`` with
    FSDP and ZeRO-1: the first batch's gradients (``value_and_grad``,
    which the first update then takes), and two steps (loss, grad_norm,
    params) at ``SHARD_OPT``; the (1, 2) step again at AdamW's default
    eps beside the unsharded step's (and, on rank 0, the unsharded step
    on the batches with their rows reversed); then the elastic restore
    of the (1, 2) ``SHARD_OPT`` run's params onto (2, 1) and onto no
    mesh."""
    from repro_torch import sharding as S
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.sharding.collectives import barrier
    from repro_torch.training import (AdamW, init_sharded, make_train_step,
                                      sharded_train_step, zero1_specs)
    from repro_torch.training.trainer import value_and_grad
    cfg = _shard_cfg(SHARD_PARITY_LAYERS, "float32")
    b, s = SHARD_PARITY_SHAPE
    model = build_model(cfg, dev)
    opt = AdamW(**SHARD_OPT)
    step = make_train_step(model, opt, remat=False)
    shape = ShapeConfig("train", s, b, "train")
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    batches = [SyntheticLM(cfg, shape, seed=0).global_batch_at(i)
               for i in range(2)]
    t0 = time.perf_counter()
    ref_g = value_and_grad(model, full, batches[0], remat=False)[1]
    ref_p, ref = _two_steps(step, opt, full, batches)
    out["parity_ref"] = dict(metrics=ref, s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    opt_d = AdamW(**SHARD_OPT_DEFAULT)
    step_d = make_train_step(model, opt_d, remat=False)
    ref_dp, ref_d = _two_steps(step_d, opt_d, full, batches)
    out["default_eps"] = dict(ref_metrics=ref_d)
    if rank == 0:
        rows = [{k: np.ascontiguousarray(v[::-1]) for k, v in bt.items()}
                for bt in batches]
        rev_g = value_and_grad(model, full, rows[0], remat=False)[1]
        grad_err = _tree_err(rev_g, ref_g)
        del rev_g
        rev_p, rev = _two_steps(step_d, opt_d, full, rows)
        out["default_eps"].update(reversed_metrics=rev,
                                  reversed_grad_err=grad_err,
                                  reversed_err=_tree_err(rev_p, ref_dp))
        del rev_p
    out["default_eps"]["ref_s"] = time.perf_counter() - t0
    for shp in SHARD_PARITY_MESHES:
        dm = dmeshes[shp]
        view = S.axes_view(dm)
        pspecs = S.param_specs(full, view, fsdp=True)
        ospecs = zero1_specs(pspecs, full, view)
        fn = sharded_train_step(step, dm, pspecs, ospecs,
                                S.input_specs_tree(batches[0], view))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp = S.shard_tree(full, pspecs, dm)
        so = init_sharded(opt, sp, ospecs, dm)
        mets, stats = [], []
        for i, bt in enumerate(batches):
            S.reset_stats()
            loss, grads = fn.value_and_grad(sp, S.shard_batch(bt, dm))
            if i == 0:
                grad_err = _shard_errs(grads, ref_g, dm)
            sp, so, met = fn.apply(sp, so, loss, grads)
            del grads
            mets.append((float(met["loss"]), float(met["grad_norm"])))
            stats.append(S.stats())
        torch.cuda.synchronize()
        out[f"parity_{shp[0]}x{shp[1]}"] = dict(
            metrics=mets, grad_err=grad_err,
            param_err=_shard_errs(sp, ref_p, dm),
            s=time.perf_counter() - t0, collectives=stats)
        del so
        if shp == (1, 2):
            # the elastic restore: saved on (1, 2), restored onto (2, 1)
            # and onto no mesh
            ckpt = os.path.join(HERE, "build", "shard_ckpt")
            t0 = time.perf_counter()
            save(sp, ckpt, 2)
            save_s = time.perf_counter() - t0
            saved, dm12 = sp, dm
            # the default-eps reading
            t0 = time.perf_counter()
            fn_d = sharded_train_step(step_d, dm, pspecs, ospecs,
                                      S.input_specs_tree(batches[0], view))
            sp = S.shard_tree(full, pspecs, dm)
            so = init_sharded(opt_d, sp, ospecs, dm)
            mets = []
            for bt in batches:
                loss, grads = fn_d.value_and_grad(sp, S.shard_batch(bt, dm))
                sp, so, met = fn_d.apply(sp, so, loss, grads)
                mets.append((float(met["loss"]), float(met["grad_norm"])))
            out["default_eps"].update(
                metrics=mets, param_err=_shard_errs(sp, ref_dp, dm),
                worst=_worst_element(sp, ref_dp, grads, dm),
                lr=float(met["lr"]), s=time.perf_counter() - t0)
            del so, grads
        del sp
    del ref_g, ref_p, ref_dp
    dm = dmeshes[(2, 1)]
    pspecs = S.param_specs(full, S.axes_view(dm), fsdp=True)
    # the checks below hold each restore bit for bit, so the restores
    # skip the checksum
    t0 = time.perf_counter()
    onto, _ = restore(saved, ckpt, shardings=(pspecs, dm), validate=False)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain, _ = restore(saved, ckpt, validate=False)
    plain_s = time.perf_counter() - t0
    plain = S.unstacked(plain)
    out["elastic"] = dict(
        onto_2x1=_shard_errs(onto, plain, dm) == 0.0,
        onto_none=_shard_errs(saved, plain, dm12) == 0.0,
        save_s=save_s, restore_s=restore_s, plain_s=plain_s,
        gb=sum(t.numel() * t.element_size()
               for t in S.execute.flat(saved).values()) / 1e9)
    barrier()           # both ranks have read the checkpoint
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    del full, onto, plain, saved
    gc.collect()
    torch.cuda.empty_cache()


def shard_run(dev, rank, dmeshes, flash, out):
    """bf16 yi-6b (``SHARD_RUN_LAYERS`` layers, published width), remat,
    ``SHARD_RUN_SHAPE``, ``SyntheticLM`` seed 0, AdamW at the CLI's
    settings: ``SHARD_STEPS`` sharded steps on (1, 2) (step ms, peak
    memory a rank, collectives and bytes a step, staged ones, flash
    launches a step), then the unsharded step on rank 0 alone."""
    import torch.distributed as dist
    from repro_torch import sharding as S
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.training import (AdamW, init_sharded, make_train_step,
                                      sharded_train_step)
    cfg = _shard_cfg(SHARD_RUN_LAYERS, "bfloat16")
    b, s = SHARD_RUN_SHAPE
    shape = ShapeConfig("train", s, b, "train")
    model = build_model(cfg, dev)
    opt = AdamW(warmup_steps=10, total_steps=100)
    step = make_train_step(model, opt, remat=True)
    full = model.init(torch.Generator(device=dev).manual_seed(0))

    def timed(fn, params, state, data):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses, stats, launches = [], [], [], []
        for i in range(SHARD_STEPS):
            S.reset_stats()
            n0 = flash.launches
            t0 = time.perf_counter()
            params, state, met = fn(params, state, data.batch_at(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(flash.launches - n0)
            losses.append(float(met["loss"]))
            stats.append(S.stats())
        step_s = float(np.median(times[SHARD_WARMUP:]))
        return dict(step_ms=step_s * 1e3, tokens_per_s=b * s / step_s,
                    step_times_ms=[t * 1e3 for t in times], losses=losses,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    flash_launches=launches, collectives=stats[-1])

    dm = dmeshes[(1, 2)]
    view = S.axes_view(dm)
    pspecs = S.param_specs(full, view)
    data = SyntheticLM(cfg, shape, seed=0, mesh=dm)
    fn = sharded_train_step(step, dm, pspecs, pspecs,
                            S.input_specs_tree(data.global_batch_at(0), view))
    sp = S.shard_tree(full, pspecs, dm)
    if rank:
        del full
    so = init_sharded(opt, sp, pspecs, dm)
    gc.collect()
    torch.cuda.empty_cache()
    out["run_sharded"] = timed(fn, sp, so, data)
    del sp, so
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        # the same global batches on one rank (a live group would split a
        # mesh-less SyntheticLM over the processes)
        whole = SimpleNamespace(batch_at=data.global_batch_at)
        out["run_unsharded"] = timed(step, full, opt.init(full), whole)
        del full
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()


def shard_rank(rank, world, store, out_dir, kind="cuda"):
    """One rank of phase 10 (its own process, on device 0 of ``kind``
    over gloo): writes ``rank<r>.json`` into ``out_dir``.  Returns the
    exit code."""
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.launch.mesh import Mesh, device_mesh, init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if kind == "cuda":
        _build.load_library()
    dev0 = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    meshes = {shp: Mesh(np.asarray([dev0] * world, dtype=object)
                        .reshape(shp), ("data", "model"))
              for shp in SHARD_PARITY_MESHES}
    dev = init_distributed(meshes[(1, 2)], rank, world,
                           init_method=f"file://{store}")
    dmeshes = {shp: device_mesh(m) for shp, m in meshes.items()}
    out = dict(rank=rank, backend=dist.get_backend(),
               setup_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["probe"] = gloo_probe(dev)
    out["probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard_parity(dev, rank, dmeshes, out)
    out["parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard_run(dev, rank, dmeshes, flash_attention_bhsd, out)
    out["run_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    dist.destroy_process_group()
    return 0


def _fmt_coll(st):
    by = ", ".join(f"{k} {v['ops']} ({v['bytes'] / 1e6:.1f} MB)"
                   for k, v in sorted(st["by_op"].items()))
    return f"{st['ops']} collectives, {st['bytes'] / 1e6:.1f} MB [{by}]"


def sharded_phase(dev, kernels, card):
    """Phase 10: ``SHARD_RANKS`` rank processes on the one card over gloo
    (``shard_rank``); their results checked and printed here."""
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "shard_phase")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    spawn_ranks("shard", "shard_rank(", SHARD_RANKS, out_dir, dev,
                SHARD_TIMEOUT)
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
           for r in range(SHARD_RANKS)]
    out = report_sharded(res, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[shard] phase {out['phase_s']:.1f} s")
    return out


def report_sharded(res, card):
    """Phase 10's checks and lines, from the ranks' results."""
    r0 = res[0]
    print(f"[shard] {SHARD_RANKS} ranks on one device over {r0['backend']}: "
          f"setup {r0['setup_s']:.1f} s, parity {r0['parity_s']:.1f} s, "
          f"run {r0['run_s']:.1f} s")
    print(f"[shard] gloo probe, CUDA tensors: {json.dumps(r0['probe'])}")
    used = ("all_reduce", "all_reduce_max", "all_gather_into_tensor",
            "reduce_scatter_tensor", "barrier")
    bad = [op for op in used if r0["probe"][op] != "ok"]
    check(not bad, f"the collectives module sends {bad} to gloo on CUDA "
                   f"tensors, which the probe refused")
    ref = r0["parity_ref"]["metrics"]
    for shp in SHARD_PARITY_MESHES:
        key = f"parity_{shp[0]}x{shp[1]}"
        row = dict(r0[key], **{e: max(r[key][e] for r in res)
                               for e in ("grad_err", "param_err")})
        dl = max(abs(a[0] - b[0]) for a, b in zip(row["metrics"], ref))
        dg = max(abs(a[1] - b[1]) / abs(b[1])
                 for a, b in zip(row["metrics"], ref))
        print(f"[shard] f32 yi-6b {SHARD_PARITY_LAYERS} layers B, S = "
              f"{SHARD_PARITY_SHAPE}, mesh {shp} fsdp + zero1, 2 steps: "
              f"losses {[m[0] for m in row['metrics']]} vs unsharded "
              f"{[m[0] for m in ref]} (|d| {dl:.3g}), grad_norm "
              f"{[m[1] for m in row['metrics']]} vs {[m[1] for m in ref]} "
              f"(rel {dg:.3g}), params {row['param_err']:.3g} of a leaf's "
              f"largest (AdamW {SHARD_OPT}); first gradients "
              f"{row['grad_err']:.3g} of a leaf's largest (both ranks' "
              f"shards); {row['s']:.1f} s; a step: "
              f"{_fmt_coll(row['collectives'][-1])}")
        check(dl <= SHARD_TOL and dg <= SHARD_TOL
              and row["param_err"] <= SHARD_TOL
              and row["grad_err"] <= SHARD_TOL,
              f"phase 10 parity on {shp}: loss {dl:.3g}, grad_norm "
              f"{dg:.3g}, params {row['param_err']:.3g}, gradients "
              f"{row['grad_err']:.3g} (tolerance {SHARD_TOL})")
    de = r0["default_eps"]
    d_err = max(r["default_eps"]["param_err"] for r in res)

    def spread(got, want):
        return (max(abs(a[0] - b[0]) for a, b in zip(got, want)),
                max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got, want)))
    dl, dg = spread(de["metrics"], de["ref_metrics"])
    rl, rg = spread(de["reversed_metrics"], de["ref_metrics"])
    d_grad = max(r["parity_1x2"]["grad_err"] for r in res)
    print(f"[shard] AdamW default eps ({SHARD_OPT_DEFAULT}), f32 mesh (1, 2) "
          f"fsdp + zero1, 2 steps: first gradients {d_grad:.3g} of a "
          f"leaf's largest from the unsharded step's, params {d_err:.3g} "
          f"(x{d_err / max(d_grad, 1e-30):.0f}; loss |d| {dl:.3g}, "
          f"grad_norm rel {dg:.3g}); the unsharded step on the same "
          f"batches with their rows reversed (f32 summation order alone): "
          f"first gradients {de['reversed_grad_err']:.3g}, params "
          f"{de['reversed_err']:.3g} (x"
          f"{de['reversed_err'] / max(de['reversed_grad_err'], 1e-30):.0f};"
          f" loss |d| {rl:.3g}, grad_norm rel {rg:.3g}); "
          f"{de['ref_s']:.1f} s + {de['s']:.1f} s")
    worst = max((r["default_eps"]["worst"] for r in res), key=lambda w: w[0])
    print(f"[shard] default eps, the sharded params' worst element "
          f"({worst[0]:.3g} of its leaf's largest, {worst[1]}): off by "
          f"{worst[2]:.3g} = {worst[2] / de['lr']:.3g} x the second step's "
          f"lr {de['lr']:.3g} (AdamW's normalized update moves an element "
          f"by about lr whatever its gradient's size); its second-step "
          f"gradient {worst[3]:.3g}, the leaf's largest {worst[4]:.3g} "
          f"(before the clip by grad_norm {de['metrics'][1][1]:.4g})")
    check(dl <= SHARD_TOL and dg <= SHARD_TOL,
          f"phase 10 at default eps: loss {dl:.3g}, grad_norm {dg:.3g} "
          f"(tolerance {SHARD_TOL})")
    el = r0["elastic"]
    same = all(r["elastic"][k] for r in res for k in ("onto_2x1",
                                                      "onto_none"))
    print(f"[shard] elastic: {el['gb']:.2f} GB of f32 params "
          f"saved on (1, 2) ({el['save_s']:.1f} s), restored onto (2, 1) "
          f"({el['restore_s']:.1f} s) and onto no mesh "
          f"({el['plain_s']:.1f} s): bit-equal on both ranks {same}")
    check(same, "phase 10: elastic restore differs")
    sh, un = r0["run_sharded"], r0["run_unsharded"]
    peaks = [r["run_sharded"]["peak_gb"] for r in res]
    for label, row, peak in (
            ("sharded (1, 2), rank 0", sh,
             "peak by rank " + ", ".join(f"{p:.3f}" for p in peaks)
             + " GB (rank 0 also holds the full params for the next run)"),
            ("unsharded, one rank", un, f"peak {un['peak_gb']:.3f} GB")):
        print(f"[shard] bf16 yi-6b {SHARD_RUN_LAYERS} layers remat B, S = "
              f"{SHARD_RUN_SHAPE} {label} ({card}): step "
              f"{row['step_ms']:.2f} ms (median of "
              f"{SHARD_STEPS - SHARD_WARMUP} after {SHARD_WARMUP}), "
              f"{row['tokens_per_s']:.1f} tokens/s, {peak}, flash "
              f"launches a step "
              f"{row['flash_launches']}, losses "
              f"{', '.join(f'{x:.4f}' for x in row['losses'])}; a step: "
              f"{_fmt_coll(row['collectives'])}")
        check(all(np.isfinite(row["losses"])), f"phase 10 {label}: losses")
        check(all(n == 2 * SHARD_RUN_LAYERS for n in row["flash_launches"]),
              f"phase 10 {label}: flash launches a step "
              f"{row['flash_launches']}, expected {2 * SHARD_RUN_LAYERS}")
    return dict(ranks=res, flash_launches=sum(sh["flash_launches"]))


# ---------------------------------------------------------------------------
# phase 11: the plan runner's data and model axes -- one process a rank of
# a ("stage", "data", "model") mesh, the ranks on the one card over gloo
# ---------------------------------------------------------------------------

PM_ARCH = "yi-6b"
PM_PARITY_LAYERS = 3           # f32: the uneven 2 | 1 plan of JAX's test
PM_PARITY_SHAPE = (8, 128)     # B, S
PM_PORT_TOL = 1e-5             # of the one-process plan_forward's |logit|
PM_RUN_LAYERS = 8              # bf16: the search's plan on 2 stages
PM_RUN_SHAPE = (8, 512)
PM_RUN_MICRO = 4
PM_REPEATS = 3                 # timed calls after one warm-up
PM_TIMEOUT = 300               # s, a spawn's ranks together
# (case, ranks): the f32 uneven plan on (2, 2, 2); its 2 x 2 rounds on
# (2, 1, 2), then the bf16 run there
PM_SPAWNS = (("f32_222", 8), ("f32_212_bf16", 4))


def _pm_cfg(layers, dtype):
    from repro_torch.configs import REGISTRY
    return dataclasses.replace(REGISTRY[PM_ARCH], num_layers=layers,
                               dtype=dtype, param_dtype=dtype)


def _pm_rank_setup(dev, mesh, plan, cfg, params):
    """This rank's ``Parallel``, model and tree on the plan mesh; the
    full params are dropped afterwards by the caller."""
    from repro_torch import sharding as SH
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.plan.serving import place_params
    from repro_torch.models import build_model
    par = SH.Parallel(device_mesh(mesh))
    tree, _ = place_params(params, plan, par=par)
    return par, dataclasses.replace(build_model(cfg, dev), par=par), tree


def _pm_resident(tree):
    from repro_torch import tree as TR
    seen = {id(t): t for t in TR.leaves(tree)}
    return sum(t.numel() * t.element_size() for t in seen.values())


def _pm_call(label, par, model, tree, batch, mesh, plan, flash, out):
    """One checked ``plan_forward`` of this rank: its flash launches,
    collectives and sends (``stats()``), wall s; returns its logits."""
    import torch.distributed as dist
    from repro_torch import sharding as SH
    from repro_torch.pipeline import plan_forward
    s = par.rank("stage")
    attn = sum(b.mixer.startswith("attn") for b in model.cfg.block_pattern)
    torch.cuda.synchronize()
    dist.barrier()
    SH.reset_stats()
    flash.launches = 0
    t0 = time.perf_counter()
    got = plan_forward(model, tree, batch, mesh, plan)
    torch.cuda.synchronize()
    out[label] = dict(
        coords=[par.rank(a) for a in ("stage", "data", "model")],
        launches=flash.launches,
        expected=plan.stages[s].n_groups * attn * plan.total_microbatches,
        stats=SH.stats(), s=time.perf_counter() - t0,
        param_bytes=_pm_resident(tree), keys=sorted(tree),
        groups=len({id(g) for g in tree["stack"]}))
    return got


def pm_parity(dev, rank, mesh, plan, label, flash, out):
    """f32 yi-6b at published width, ``PM_PARITY_LAYERS`` layers, B=8,
    S=128, weights from ``torch.Generator`` seed 0 on every rank: rank 0
    takes ``Model.forward`` and the one-process ``plan_forward`` (the
    runner the engine's plans use) on the full params; then every rank
    keeps its tree, drops the full params and runs ``plan`` one process
    a rank; rank 0 gets the logits through ``gather_logits`` and their
    errors."""
    from repro_torch.models import build_model
    from repro_torch.pipeline import gather_logits, plan_forward
    cfg = _pm_cfg(PM_PARITY_LAYERS, "float32")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    b, s = PM_PARITY_SHAPE
    batch = {"tokens": place_tokens(cfg, (b, s), dev, 1)}
    refs = None
    if rank == 0:
        refs = (model.forward(params, batch)[0],
                plan_forward(model, params, batch, mesh, plan))
    par, rmodel, tree = _pm_rank_setup(dev, mesh, plan, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    got = _pm_call(label, par, rmodel, tree, batch, mesh, plan, flash, out)
    full = gather_logits(got, par, b, plan.total_microbatches, s,
                         cfg.vocab_size)
    if rank == 0:
        ref, one = refs
        out[label].update(
            rel_forward=max_err(full, ref) / float(ref.abs().max()),
            rel_one_process=max_err(full, one) / float(one.abs().max()),
            mesh=list(mesh.devices.shape), plan=plan.describe())
    del got, full, refs, tree
    gc.collect()
    torch.cuda.empty_cache()


def pm_run(dev, rank, mesh_of, flash, out):
    """bf16 yi-6b at published width, ``PM_RUN_LAYERS`` layers, B=8,
    S=512, M=4 through the uneven plan ``ssr_dse`` gives for 8 groups on 2
    stages (``hw=H100``, ``lower(mesh_devices=4)``), each stage's tp set
    to 2 when the plan's factors give model = 1, on (2, 1, 2) (``mesh_of
    (plan)``).  Rank 0: ``Model.forward`` and the one-process
    ``plan_forward`` on the same plan (ms, and the reference argmax);
    then every rank: one checked call (flash launches, stats), the logits
    to rank 0 (finite, argmax), and each rank's ms of the runner alone
    and of ``plan_forward`` (CUDA events after a barrier, median of
    ``PM_REPEATS`` after a warm-up), its resident param bytes and peak
    memory."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import build_graph, ssr_dse
    from repro_torch.core.assignment import contiguous_assignment
    from repro_torch.core.hw import H100
    from repro_torch.models import build_model
    from repro_torch.pipeline import (gather_logits, make_plan_runner,
                                      plan_forward)
    from repro_torch.sharding import shard_batch
    from repro_torch.plan import lower
    from repro_torch.plan.validate import _embed
    cfg = _pm_cfg(PM_RUN_LAYERS, "bfloat16")
    b, s = PM_RUN_SHAPE
    graph = build_graph(cfg, ShapeConfig("plan-mesh", s, b, "prefill"))
    _, _, assign = ssr_dse(graph, contiguous_assignment(graph, 2, 2).acc_of,
                           4, n_batches=2, hw=H100)
    plan = lower(assign, graph, mesh_devices=4, n_microbatches=PM_RUN_MICRO)
    searched = plan.describe()
    forced = plan.mesh_factors(2)[1] == 1
    if forced:
        plan = dataclasses.replace(plan, stages=tuple(
            dataclasses.replace(st, dp=1, tp=2) for st in plan.stages))
    mesh = mesh_of(plan)
    model = build_model(cfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": place_tokens(cfg, (b, s), dev, 2)}
    ref_top = None
    if rank == 0:
        ref = model.forward(params, batch)[0]
        top = torch.topk(ref, 2, dim=-1).values
        ref_top = (ref.argmax(-1), (top[..., 0] - top[..., 1])
                   > PLACE_ULPS * bf16_ulp(top[..., 0]))
        del ref, top
        out["forward_ms"] = event_ms(
            lambda: model.forward(params, batch)[0], iters=PM_REPEATS,
            warmup=1)
        out["one_process_ms"] = event_ms(
            lambda: plan_forward(model, params, batch, mesh, plan),
            iters=PM_REPEATS, warmup=1)
    out["build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    par, rmodel, tree = _pm_rank_setup(dev, mesh, plan, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["resident_gb"] = torch.cuda.memory_allocated() / 1e9
    got = _pm_call("bf16", par, rmodel, tree, batch, mesh, plan, flash, out)
    full = gather_logits(got, par, b, plan.total_microbatches, s,
                         cfg.vocab_size)
    del got
    if rank == 0:
        arg, decided = ref_top
        same = full.argmax(-1) == arg
        out["bf16"].update(
            finite=bool(torch.isfinite(full).all()),
            decided=int(decided.sum()), positions=b * s,
            equal_decided=int((decided & same).sum()),
            wrong=int((decided & ~same).sum()), equal=int(same.sum()),
            plan=plan.describe(), searched=searched, forced_tp2=forced,
            mesh=list(mesh.devices.shape))
    del full
    gc.collect()
    torch.cuda.empty_cache()

    M = plan.total_microbatches
    if par.rank("stage") == 0:
        x = _embed(rmodel, tree, shard_batch(batch, par.dmesh, M))
    else:
        x = torch.empty((b // par.dp, s, cfg.d_model), dtype=torch.bfloat16,
                        device="meta")
    x_mb = x.reshape(M, b // par.dp // M, s, cfg.d_model)
    runner = make_plan_runner(cfg, mesh, plan, par=par)
    mask = plan.group_mask_matrix()

    def timed(fn):
        ts = []
        for _ in range(1 + PM_REPEATS):
            torch.cuda.synchronize()
            dist.barrier()
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return float(np.median(ts[1:]))
    out["runner_ms"] = timed(lambda: runner(tree["stack"], mask, x_mb))
    out["plan_forward_ms"] = timed(lambda: plan_forward(
        rmodel, tree, batch, mesh, plan))
    out["run_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del tree, x, x_mb
    gc.collect()
    torch.cuda.empty_cache()


def plan_mesh_rank(case, rank, world, store, out_dir, kind="cuda"):
    """One rank of phase 11 (its own process, on device 0 of ``kind``
    over gloo): writes ``<case>_rank<r>.json`` into ``out_dir``.
    Returns the exit code."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import build_graph, ssr_dse
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.launch.mesh import Mesh, init_distributed, make_plan_mesh
    from repro_torch.plan import lower
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if kind == "cuda":
        _build.load_library()
    dev0 = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    devs = [dev0] * world
    # the uneven plan of JAX's test (tests/test_distributed.py): the embed
    # and two layers on acc 0, the last layer and the head on acc 1
    cfg = _pm_cfg(PM_PARITY_LAYERS, "float32")
    b, s = PM_PARITY_SHAPE
    graph = build_graph(cfg, ShapeConfig("plan-mesh", s, b, "prefill"))
    _, _, assign = ssr_dse(graph, (0,) * cfg.num_layers + (1, 1), 8,
                           n_batches=2)
    if case == "f32_222":
        plan = lower(assign, graph, mesh_devices=8, n_microbatches=4)
        mesh = make_plan_mesh(plan, devices=devs)
    else:
        plan = lower(assign, graph, mesh_devices=8, n_microbatches=2,
                     n_rounds=2)
        mesh = Mesh(np.asarray(devs, dtype=object).reshape(2, 1, 2),
                    ("stage", "data", "model"))
    dev = init_distributed(mesh, rank, world, init_method=f"file://{store}")
    out = dict(rank=rank, case=case, backend=dist.get_backend(),
               setup_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    pm_parity(dev, rank, mesh, plan, "f32", flash_attention_bhsd, out)
    out["parity_s"] = time.perf_counter() - t0
    if case.endswith("_bf16"):
        t0 = time.perf_counter()
        pm_run(dev, rank, lambda p: make_plan_mesh(p, devices=devs),
               flash_attention_bhsd, out)
        out["run_s"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, f"{case}_rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    dist.destroy_process_group()
    return 0


def spawn_ranks(tag, entry, world, out_dir, dev, timeout):
    """Run ``chip_smoke.<entry>(rank, world, store, out_dir, dev)`` (a
    string of the leading arguments is spliced in: ``entry`` may carry
    its own, as ``"plan_mesh_rank('f32_222', "``) in ``world`` processes
    of ``python -c``; wait for all, killing the rest when one fails or
    the ``timeout`` passes; print a failed rank's log and fail the run.
    Returns the exit codes (all 0)."""
    store = os.path.join(out_dir, f"store_{tag}")
    procs = []
    for r in range(world):
        log = open(os.path.join(out_dir, f"{tag}_rank{r}.log"), "w")
        code = (f"import sys; sys.path.insert(0, {HERE!r}); "
                f"import chip_smoke; sys.exit(chip_smoke.{entry}"
                f"{r}, {world}, {store!r}, {out_dir!r}, {dev!r}))")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       cwd=HERE, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    deadline = time.perf_counter() + timeout
    while any(p.poll() is None for p, _ in procs):
        failed = any(p.poll() not in (None, 0) for p, _ in procs)
        if failed or time.perf_counter() > deadline:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.5)
    rcs = [p.wait() for p, _ in procs]
    for _, log in procs:
        log.close()
    if any(rcs):
        for r in range(world):
            with open(os.path.join(out_dir, f"{tag}_rank{r}.log")) as f:
                tail = f.read()[-3000:]
            print(f"[{tag}] rank {r} exit {rcs[r]}:\n{tail}")
    check(not any(rcs), f"{tag}'s ranks exited {rcs}")
    return rcs


def plan_mesh_phase(dev, kernels, card):
    """Phase 11: ``PM_SPAWNS``' rank processes on the one card over gloo
    (``plan_mesh_rank``), one spawn after the other; their results
    checked and printed here."""
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "plan_mesh_phase")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    for case, world in PM_SPAWNS:
        t1 = time.perf_counter()
        spawn_ranks(case, f"plan_mesh_rank({case!r}, ", world, out_dir, dev,
                    PM_TIMEOUT)
        res[case] = [json.load(open(os.path.join(
            out_dir, f"{case}_rank{r}.json"))) for r in range(world)]
        print(f"[plan-mesh] {case}: {world} ranks, "
              f"{time.perf_counter() - t1:.1f} s")
    out = report_plan_mesh(res, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[plan-mesh] phase {out['phase_s']:.1f} s")
    return out


def report_plan_mesh(res, card):
    """Phase 11's checks and lines, from the ranks' results."""
    out = dict(ranks=res)
    for case, _ in PM_SPAWNS:
        ranks = res[case]
        r0 = ranks[0]["f32"]
        for r in ranks:
            row = r["f32"]
            st = row["stats"]["by_op"]
            print(f"[plan-mesh] {case} rank {r['rank']} (s, d, m) = "
                  f"{tuple(row['coords'])}: {row['groups']} groups, "
                  f"{row['keys']}, {row['param_bytes'] / 1e9:.3f} GB of "
                  f"params; flash {row['launches']} (= {row['expected']}); "
                  f"{_fmt_coll(row['stats'])}; sends "
                  f"{st.get('send', {'ops': 0})['ops']}; {row['s']:.2f} s")
            check(row["launches"] == row["expected"],
                  f"phase 11 {case} rank {r['rank']}: flash launched "
                  f"{row['launches']} times, not {row['expected']}")
        print(f"[plan-mesh] f32 {PM_ARCH} {PM_PARITY_LAYERS} layers B, S = "
              f"{PM_PARITY_SHAPE} on {tuple(r0['mesh'])}, "
              f"{len(ranks)} ranks over {ranks[0]['backend']}: max |logits "
              f"- Model.forward| / max |logit| = {r0['rel_forward']:.3g} "
              f"(tol {PLACE_TOL}); vs the one-process plan_forward "
              f"{r0['rel_one_process']:.3g} (tol {PM_PORT_TOL})\n"
              f"{r0['plan']}")
        check(r0["rel_forward"] <= PLACE_TOL
              and r0["rel_one_process"] <= PM_PORT_TOL,
              f"phase 11 {case}: logits off by {r0['rel_forward']:.3g} "
              f"(forward), {r0['rel_one_process']:.3g} (one process)")
        out[case] = dict(rel_forward=r0["rel_forward"],
                         rel_one_process=r0["rel_one_process"])
    ranks = res["f32_212_bf16"]
    r0 = ranks[0]
    row = r0["bf16"]
    print(f"[plan-mesh] bf16 {PM_ARCH} {PM_RUN_LAYERS} layers B, S = "
          f"{PM_RUN_SHAPE}, M={PM_RUN_MICRO}: the search's plan"
          f"{' (tp set to 2: its factors gave model = 1)' if row['forced_tp2'] else ''}"
          f":\n{row['searched']}\nrun as\n{row['plan']}\non "
          f"{tuple(row['mesh'])}")
    print(f"[plan-mesh] bf16 logits: finite {row['finite']}; argmax equal "
          f"to Model.forward's at {row['equal_decided']} of "
          f"{row['decided']} decided positions ({row['positions']} in all; "
          f"{row['equal']} equal overall)")
    check(row["finite"], "phase 11 bf16: non-finite logits")
    check(row["wrong"] == 0,
          f"phase 11 bf16: {row['wrong']} decided positions differ")
    for r in ranks:
        b = r["bf16"]
        st = b["stats"]["by_op"]
        print(f"[plan-mesh] bf16 rank {r['rank']} (s, d, m) = "
              f"{tuple(b['coords'])} ({card}): runner {r['runner_ms']:.3f} "
              f"ms, plan_forward {r['plan_forward_ms']:.3f} ms (median of "
              f"{PM_REPEATS}); flash {b['launches']} (= {b['expected']}); a "
              f"call: {_fmt_coll(b['stats'])}, sends "
              f"{st.get('send', {'ops': 0, 'bytes': 0})['ops']} "
              f"({st.get('send', {'bytes': 0})['bytes'] / 1e6:.1f} MB); "
              f"params {b['param_bytes'] / 1e9:.3f} GB resident (allocated "
              f"{r['resident_gb']:.3f} GB before the run), peak "
              f"{r['run_peak_gb']:.3f} GB in the runs, "
              f"{r['build_peak_gb']:.3f} GB while the full params were "
              f"built")
        check(b["launches"] == b["expected"],
              f"phase 11 bf16 rank {r['rank']}: flash launched "
              f"{b['launches']} times, not {b['expected']}")
    runner = max(r["runner_ms"] for r in ranks)
    fwd = max(r["plan_forward_ms"] for r in ranks)
    print(f"[plan-mesh] bf16 ({card}): make_plan_runner {runner:.3f} ms and "
          f"plan_forward {fwd:.3f} ms (the slowest rank), Model.forward on "
          f"one rank {r0['forward_ms']:.3f} ms, the one-process "
          f"plan_forward {r0['one_process_ms']:.3f} ms; "
          f"sharded plan_forward {fwd / r0['forward_ms']:.2f}x "
          f"Model.forward")
    out["bf16"] = dict(runner_ms=runner, plan_forward_ms=fwd,
                       forward_ms=r0["forward_ms"],
                       one_process_ms=r0["one_process_ms"],
                       wrong_argmax=row["wrong"])
    out["flash_launches"] = sum(r["bf16"]["launches"] for r in ranks)
    return out


# ---------------------------------------------------------------------------
# phase 12: tensor parallelism for every block -- mamba, mLSTM, sLSTM,
# cross-attention, a cut query head, the ViT class head and qwen2-vl's
# M-RoPE embeds over model = 2; two ranks on the one card over gloo
# ---------------------------------------------------------------------------

TPB_RANKS = 2
TPB_ARCHS = ("jamba-1.5-large-398b", "xlstm-125m", "whisper-base", "deit-t",
             "qwen2-vl-72b")
# xlstm-125m at one pattern period: at two its f32 gradients are
# ill-conditioned (tests/test_torch_loss.py); the hybrid at one period
# (mamba, attention, MoE), for time
TPB_LAYERS = {"xlstm-125m": 4, "jamba-1.5-large-398b": 8}
# loss and the params after one AdamW step (absolute: JAX's own tolerance;
# of a leaf's largest, a zero-initialized leaf such as mamba's conv_b is
# ~lr, and AdamW's first update turns f32 noise in a gradient element
# near eps into 1.4e-4 of it on the CPU), gradients (of a leaf's
# largest); grad_norm relative
TPB_TOL = 1e-4
TPB_NORM_RTOL = 1e-5
TPB_PARITY_SHAPE = (4, 32)     # B, S (whisper: S decoder tokens, 2 S frames)
TPB_PLAN_LAYERS = 16           # the hybrid reduced: 2 periods, 14 mamba
TPB_PLAN_SHAPE = (4, 64)
TPB_PLAN_TOL = 1e-4            # of Model.forward's largest |logit|
TPB_XLSTM = (12, 4, 512)       # layers, B, S: bf16 at published width
TPB_WHISPER = (4, 1500, 448)   # B, frames, decoder tokens
TPB_DEIT = (6, 196)            # B, patches
TPB_JAMBA = (8, 1, 512)        # layers (one period), B, S
TPB_VLM = (1, 2, 512)          # layers, B, S
TPB_COSINE = 0.99
# xlstm-125m's gradients are ill-conditioned (its exponential gates): in
# f32 its parity gates follow its own noise floor, the unsharded step on
# weights times 1 + 1e-7 N(0, 1) (``TPB_FLOOR``: the sharded step's
# gradient error and grad_norm within twice the floor's, or the gates);
# in bf16 its cosine is read at ``TPB_XLSTM_COS_SEQ`` tokens beside the
# unsharded bf16 step's against the unsharded f32 one's (the witness: at
# 12 layers bf16 rounding alone moves the gradients' direction), and not
# gated; the gated cosine there is the f32 sharded step's against the
# f32 unsharded one's, at the same width, depth and batch
TPB_FLOOR = ("xlstm-125m",)
TPB_FLOOR_NOISE = 1e-7
TPB_XLSTM_COS_SEQ = 32
TPB_TIMEOUT = 420              # s, both ranks together
# the kernel rows at a rank's shapes: the selective scan on half of
# jamba's channels (N, S, d_inner, d_state), forward and forward +
# backward; flash at whisper's cross-attention on half its heads (B, H,
# Sq, Skv, D), non-causal, forward + backward
TPB_SCAN = (1, 512, 8192, 16)
TPB_SCAN_TRAIN = (1, 128, 8192, 16)
TPB_CROSS = (4, 4, 448, 1500, 64)


def tpb_reduced(arch, layers=0):
    """``reduced(arch)`` at head_dim 64 (flash takes 40, 60, 64, 128 and
    256; ``reduced`` gives 16), M-RoPE's sections (8, 12, 12) to match."""
    from repro_torch.configs import REGISTRY, reduced
    cfg = reduced(REGISTRY[arch], layers=layers)
    return dataclasses.replace(
        cfg, head_dim=64,
        mrope_sections=(8, 12, 12) if cfg.mrope_sections else ())


def tpb_batch(cfg, b, s, seed, frames=None):
    """A batch of ``cfg``'s family drawn with numpy: tokens; ViT patch
    embeddings and class labels; whisper's frames (``frames``, default
    2 S) and decoder tokens; qwen2-vl's merged embeddings on three
    distinct M-RoPE streams (t the token index, h and w a 2 x 3 grid's
    rows and columns)."""
    r = np.random.default_rng(seed)
    v, d = cfg.vocab_size, cfg.d_model

    def ids(*shape):
        return r.integers(0, v, shape).astype(np.int32)

    def emb(*shape):
        return r.standard_normal(shape).astype(np.float32)
    if cfg.family == "vision":
        return {"embeds": emb(b, s, d), "labels": ids(b)}
    if cfg.family == "audio":
        return {"enc_embeds": emb(b, frames or 2 * s, d),
                "dec_tokens": ids(b, s), "labels": ids(b, s)}
    if cfg.family == "vlm":
        t = np.arange(s)
        pos = np.stack([t, t // 6 + (t % 6) // 3, t % 3])
        return {"embeds": emb(b, s, d), "labels": ids(b, s),
                "positions": np.broadcast_to(
                    pos[:, None], (3, b, s)).astype(np.int32).copy()}
    return {"tokens": ids(b, s), "labels": ids(b, s)}


def _tpb_counts():
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.selective_scan import mamba_scan_fused
    return {"flash": flash_attention_bhsd.launches,
            "scan": mamba_scan_fused.launches}


def _tpb_since(n0):
    return {k: v - n0[k] for k, v in _tpb_counts().items()}


def tpb_parity(dev, rank, dm, out):
    """f32, each of ``TPB_ARCHS`` reduced (``tpb_reduced``, ``TPB_LAYERS``),
    its own seed
    and ``tpb_batch``: the unsharded step on each rank (so that each
    holds its shards to their blocks without a gather), then
    ``sharded_train_step`` on (1, 2): the first gradients
    (``value_and_grad``), loss, grad_norm and the params after one AdamW
    step at ``SHARD_OPT``; flash and scan launches and the collectives of
    the sharded step."""
    from repro_torch import sharding as S
    from repro_torch.models import build_model
    from repro_torch.training import (AdamW, init_sharded, make_train_step,
                                      sharded_train_step)
    from repro_torch.training.trainer import value_and_grad
    view = S.axes_view(dm)
    b, s = TPB_PARITY_SHAPE
    rows = {}
    for i, arch in enumerate(TPB_ARCHS):
        t0 = time.perf_counter()
        cfg = tpb_reduced(arch, TPB_LAYERS.get(arch, 0))
        model = build_model(cfg, dev)
        opt = AdamW(**SHARD_OPT)
        full = model.init(torch.Generator(device=dev).manual_seed(i))
        bt = tpb_batch(cfg, b, s, 10 + i)
        step = make_train_step(model, opt, remat=True)
        ref_g = value_and_grad(model, full, bt, remat=False)[1]
        ref_p, _, ref_met = step(full, opt.init(full), bt)
        pspecs = S.param_specs(full, view)
        fn = sharded_train_step(step, dm, pspecs, pspecs,
                                S.input_specs_tree(bt, view))
        sp = S.shard_tree(full, pspecs, dm)
        so = init_sharded(opt, sp, pspecs, dm)
        n0 = _tpb_counts()
        S.reset_stats()
        loss, grads = fn.value_and_grad(sp, S.shard_batch(bt, dm))
        g_err = _shard_errs(grads, ref_g, dm)
        sp, so, met = fn.apply(sp, so, loss, grads)
        floor = None
        if arch in TPB_FLOOR:
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            noisy = [t * (1 + TPB_FLOOR_NOISE * torch.randn(
                t.shape, generator=gen, device=dev)) for t in _leaves(full)]
            from repro_torch import tree as TR
            w_g = value_and_grad(model, TR.unflatten_like(
                full, iter(noisy)), bt, remat=False)[1]
            w_norm = sum(float(g.double().square().sum())
                         for g in _leaves(w_g)) ** 0.5
            floor = dict(grad_err=_tree_err(w_g, ref_g),
                         norm_rel=abs(w_norm - float(ref_met["grad_norm"]))
                         / float(ref_met["grad_norm"]))
            del noisy, w_g
        rows[arch] = dict(
            floor=floor, worst=_worst_element(sp, ref_p, grads, dm),
            loss=float(met["loss"]), ref_loss=float(ref_met["loss"]),
            grad_norm=float(met["grad_norm"]),
            ref_norm=float(ref_met["grad_norm"]), grad_err=g_err,
            param_err=_shard_errs(sp, ref_p, dm),
            param_abs=_shard_errs(sp, ref_p, dm, relative=False),
            launches=_tpb_since(n0),
            stats=S.stats(), layers=cfg.num_layers,
            s=time.perf_counter() - t0)
        del full, ref_g, ref_p, sp, so, grads
    out["parity"] = rows


def tpb_plan(dev, rank, pdm, pmesh, out):
    """f32 rank-mode ``plan_forward`` of the hybrid (jamba dense-FFN)
    reduced to ``TPB_PLAN_LAYERS`` layers: the plan's one stage of both
    groups (14 mamba, 2 attention layers) on the (1, 1, 2) plan mesh, M=2,
    against ``Model.forward`` on rank 0."""
    from repro_torch import sharding as S
    from repro_torch.models import build_model
    from repro_torch.pipeline import gather_logits, plan_forward
    from repro_torch.plan import uniform_plan
    from repro_torch.plan.serving import place_params
    cfg = tpb_reduced(HYBRID, TPB_PLAN_LAYERS)
    model = build_model(cfg, dev)
    full = model.init(torch.Generator(device=dev).manual_seed(7))
    b, s = TPB_PLAN_SHAPE
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    par = S.Parallel(pdm)
    plan = uniform_plan(cfg.num_groups, 1, 2)
    tree, _ = place_params(full, plan, par=par)
    n0 = _tpb_counts()
    S.reset_stats()
    got = plan_forward(dataclasses.replace(model, par=par), tree,
                       {"tokens": tokens}, pmesh, plan)
    row = dict(launches=_tpb_since(n0), stats=S.stats(),
               in_proj=list(tree["stack"][0]["b0"]["mixer"]["in_proj"].shape))
    logits = gather_logits(got, par, b, plan.total_microbatches, s,
                           cfg.vocab_size)
    if rank == 0:
        ref = model.forward(full, {"tokens": tokens})[0]
        row.update(err=max_err(logits, ref)
                   / float(ref.abs().max()),
                   finite=bool(torch.isfinite(logits).all()))
    out["plan"] = row


def _tpb_cosines(got, want):
    """(the whole gradient's cosine, the smallest leaf's and its path):
    two trees in the port's layout, compared leaf by leaf by path."""
    from repro_torch import sharding as S
    from repro_torch.sharding.execute import flat
    a, b = flat(S.stacked(got)), flat(S.stacked(want))
    dot = na = nb = 0.0
    worst = (2.0, "")
    for k in a:
        x, y = a[k].double().reshape(-1), b[k].double().reshape(-1)
        d, u, v = float(x @ y), float(x @ x), float(y @ y)
        dot, na, nb = dot + d, na + u, nb + v
        if u and v:
            worst = min(worst, (d / (u * v) ** 0.5, "/".join(k)))
    return dot / (na * nb) ** 0.5, worst[0], worst[1]


def tpb_step(dev, rank, dm, cfg, batch, units, label, out, cos_batch=None):
    """bf16 ``cfg``: one timed sharded step on (1, 2) (remat;
    ``value_and_grad`` then ``apply``): ms, ``units`` (count, name) a
    second, loss, grad_norm, peak memory a rank, flash and scan launches,
    collectives and bytes.  Its gradients, gathered, are held on rank 0
    to the unsharded step's (cosine).  With ``cos_batch`` the cosine is
    read on that batch instead (a sharded ``value_and_grad`` more), beside
    the witness: the unsharded bf16 gradients' cosine with the unsharded
    f32 ones there; and the same width in f32 (a sharded f32
    ``value_and_grad`` on that batch) gives the cosine that is gated."""
    import torch.distributed as dist
    from repro_torch import sharding as S
    from repro_torch.models import build_model
    from repro_torch.training import (AdamW, init_sharded, make_train_step,
                                      sharded_train_step)
    from repro_torch.training.trainer import value_and_grad
    view = S.axes_view(dm)
    model = build_model(cfg, dev)
    opt = AdamW(warmup_steps=10, total_steps=100)
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, opt, remat=True)
    pspecs = S.param_specs(full, view)
    fn = sharded_train_step(step, dm, pspecs, pspecs,
                            S.input_specs_tree(batch, view))
    sp = S.shard_tree(full, pspecs, dm)
    so = init_sharded(opt, sp, pspecs, dm)
    rows = S.shard_batch(batch, dm)
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    n0 = _tpb_counts()
    S.reset_stats()
    t0 = time.perf_counter()
    loss, grads = fn.value_and_grad(sp, rows)
    sp, so, met = fn.apply(sp, so, loss, grads)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    row = dict(step_ms=step_s * 1e3, per_s=units[0] / step_s, unit=units[1],
               loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=_tpb_since(n0), stats=S.stats(),
               params=sum(t.numel() for t in S.execute.flat(sp).values()))
    del sp, so
    ref_in = batch
    f32_grads = None
    if cos_batch is not None:
        ref_in = cos_batch
        sp = S.shard_tree(full, pspecs, dm)
        loss, grads = fn.value_and_grad(sp, S.shard_batch(cos_batch, dm))
        row["cos_loss"] = float(loss)
        del sp
        # the same step in f32 at the same width, for the gated cosine
        f32 = build_model(dataclasses.replace(
            cfg, dtype="float32", param_dtype="float32"), dev)
        f32_fn = sharded_train_step(make_train_step(f32, opt, remat=True),
                                    dm, pspecs, pspecs,
                                    S.input_specs_tree(cos_batch, view))
        sp = S.shard_tree(_tree_map(lambda t: t.float(), full), pspecs, dm)
        f32_grads = S.gather_tree(f32_fn.value_and_grad(
            sp, S.shard_batch(cos_batch, dm))[1])
        del sp
    grads = S.gather_tree(grads)
    if rank:
        del grads, full, f32_grads
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        t0 = time.perf_counter()
        ref_loss, ref_g = value_and_grad(model, full, ref_in, remat=True)
        torch.cuda.synchronize()
        cos, worst, leaf = _tpb_cosines(grads, ref_g)
        row.update(ref_ms=(time.perf_counter() - t0) * 1e3,
                   ref_loss=float(ref_loss), cosine=cos, worst_cosine=worst,
                   worst_leaf=leaf)
        if cos_batch is not None:
            f32 = dataclasses.replace(cfg, dtype="float32",
                                      param_dtype="float32")
            wide = _tree_map(lambda t: t.float(), full)
            del full
            gc.collect()
            torch.cuda.empty_cache()
            w_loss, w_g = value_and_grad(build_model(f32, dev), wide,
                                         cos_batch, remat=True)
            wcos, wworst, wleaf = _tpb_cosines(ref_g, w_g)
            fcos, fworst, fleaf = _tpb_cosines(f32_grads, w_g)
            row.update(witness=wcos, witness_worst=wworst,
                       witness_leaf=wleaf, witness_loss=float(w_loss),
                       sharded_vs_f32=_tpb_cosines(grads, w_g)[0],
                       f32_cosine=fcos, f32_worst_cosine=fworst,
                       f32_worst_leaf=fleaf)
            del wide, w_g
        else:
            del full
        del ref_g, grads, f32_grads
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    out[label] = row


def _tree_map(fn, tree):
    from repro_torch import tree as TR
    return TR.tree_map(fn, tree)


def _card_used_gb():
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 1e9


def tpb_forward(dev, rank, world, dm, cfg, batch, label, out):
    """bf16 ``cfg``'s forward on (1, 2) against the unsharded forward on
    rank 0: the ranks build the full params one at a time (each keeps its
    ``model`` shards, ``plan_rank_tree`` of a one-stage plan; rank 0 also
    the full params for its reference), the card's used memory read at
    each build; the sharded forward's ms, launches and collectives; the
    logits' cosine and the decided argmaxes that differ."""
    import torch.distributed as dist
    from repro_torch import sharding as S
    from repro_torch.models import build_model
    from repro_torch.plan import uniform_plan
    par = S.Parallel(dm)
    model = build_model(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    full, tree, card = None, None, []
    for r in range(world):
        if r == rank:
            full = model.init(torch.Generator(device=dev).manual_seed(0))
            tree = S.plan_rank_tree(full, uniform_plan(cfg.num_groups, 1, 1),
                                    par)
            card.append(_card_used_gb())
            if rank:
                full = None
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        card.append(_card_used_gb())
    rows = S.shard_batch(batch, dm)
    rank_model = dataclasses.replace(model, par=par)
    with torch.no_grad():
        rank_model.forward(tree, rows)          # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        n0 = _tpb_counts()
        S.reset_stats()
        t0 = time.perf_counter()
        logits = rank_model.forward(tree, rows)[0]
        torch.cuda.synchronize()
        row = dict(ms=(time.perf_counter() - t0) * 1e3,
                   launches=_tpb_since(n0), stats=S.stats(),
                   resident_gb=sum(t.numel() * t.element_size()
                                   for t in _leaves(tree)) / 1e9,
                   card_gb=max(card), build_peak_gb=(
                       torch.cuda.max_memory_allocated() / 1e9))
        if rank == 0:
            t0 = time.perf_counter()
            ref = model.forward(full, batch)[0]
            torch.cuda.synchronize()
            row["ref_ms"] = (time.perf_counter() - t0) * 1e3
            card.append(_card_used_gb())
            row["card_gb"] = max(card)
            x, y = logits.double().reshape(-1), ref.double().reshape(-1)
            top = torch.topk(ref, 2, dim=-1).values
            decided = (top[..., 0] - top[..., 1]) \
                > PLACE_ULPS * bf16_ulp(top[..., 0])
            row.update(
                cosine=float(x @ y / (x.norm() * y.norm())),
                finite=bool(torch.isfinite(logits).all()),
                decided=int(decided.sum()),
                argmax_differ=int(((logits.argmax(-1) != ref.argmax(-1))
                                   & decided).sum()),
                shape=list(logits.shape))
            del ref, full
    del tree, logits
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out[label] = row


def _leaves(tree):
    from repro_torch import tree as TR
    return TR.leaves(tree)


def tpb_runs(dev, rank, world, dm, out):
    """bf16 at published width on (1, 2): train steps of xlstm-125m (all
    12 layers), whisper-base whole and deit-t whole; forwards of one
    period of the hybrid (jamba-398b dense-FFN) and of qwen2-vl-72b's
    first layer and head (``TPB_*``)."""
    from repro_torch.configs import REGISTRY

    def cfg_of(arch, layers=0):
        cfg = REGISTRY[arch]
        return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                                   dtype="bfloat16", param_dtype="bfloat16")
    layers, b, s = TPB_XLSTM
    cfg = cfg_of("xlstm-125m", layers)
    t0 = time.perf_counter()
    tpb_step(dev, rank, dm, cfg, tpb_batch(cfg, b, s, 21), (b * s, "tokens"),
             "xlstm", out, cos_batch=tpb_batch(cfg, b, TPB_XLSTM_COS_SEQ, 26))
    out["xlstm"]["s"] = time.perf_counter() - t0
    b, frames, dec = TPB_WHISPER
    cfg = cfg_of("whisper-base")
    t0 = time.perf_counter()
    tpb_step(dev, rank, dm, cfg, tpb_batch(cfg, b, dec, 22, frames),
             (b * dec, "decoder tokens"), "whisper", out)
    out["whisper"]["s"] = time.perf_counter() - t0
    b, s = TPB_DEIT
    cfg = cfg_of("deit-t")
    t0 = time.perf_counter()
    tpb_step(dev, rank, dm, cfg, tpb_batch(cfg, b, s, 23), (b, "images"),
             "deit", out)
    out["deit"]["s"] = time.perf_counter() - t0
    layers, b, s = TPB_JAMBA
    cfg = cfg_of(HYBRID, layers)
    t0 = time.perf_counter()
    tpb_forward(dev, rank, world, dm, cfg, tpb_batch(cfg, b, s, 24),
                "jamba", out)
    out["jamba"]["s"] = time.perf_counter() - t0
    layers, b, s = TPB_VLM
    cfg = cfg_of("qwen2-vl-72b", layers)
    t0 = time.perf_counter()
    tpb_forward(dev, rank, world, dm, cfg, tpb_batch(cfg, b, s, 25), "vlm",
                out)
    out["vlm"]["s"] = time.perf_counter() - t0


def tp_blocks_rank(rank, world, store, out_dir, kind="cuda"):
    """One rank of phase 12 (its own process, on device 0 of ``kind``
    over gloo): writes ``rank<r>.json`` into ``out_dir``.  Returns the
    exit code."""
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh, device_mesh, init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if kind == "cuda":
        _build.load_library()
    dev0 = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    devs = np.asarray([dev0] * world, dtype=object)
    mesh = Mesh(devs.reshape(1, world), ("data", "model"))
    dev = init_distributed(mesh, rank, world, init_method=f"file://{store}")
    dm = device_mesh(mesh)
    pmesh = Mesh(devs.reshape(1, 1, world), ("stage", "data", "model"))
    pdm = device_mesh(pmesh)
    out = dict(rank=rank, backend=dist.get_backend(),
               setup_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tpb_parity(dev, rank, dm, out)
    out["parity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpb_plan(dev, rank, pdm, pmesh, out)
    out["plan_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tpb_runs(dev, rank, world, dm, out)
    out["run_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    dist.destroy_process_group()
    return 0


def tpb_kernel_rows(dev, flush, results):
    """Phase 12's kernel rows at a rank's shapes, against their plain
    versions on the same CUDA tensors: the selective scan on half of
    jamba's channels (``TPB_SCAN``, f32, forward; ``TPB_SCAN_TRAIN``
    forward + backward through ``scan_grad_rows``), and flash at
    whisper's cross-attention on half its heads (``TPB_CROSS``,
    non-causal, forward + backward, f32 and bf16, beside SDPA)."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ref as TR
    from repro_torch.kernels import selective_scan as SS
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(41)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)
    n_, s_, di, ds = TPB_SCAN
    a_mat = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device=dev).repeat(di, 1)
    args = (F.softplus(rnd((n_, s_, di)) * 0.1 - 4.6), rnd((n_, s_, di)),
            rnd((n_, s_, ds)), rnd((n_, s_, ds)), a_mat, None)
    y, hl = SS.mamba_scan_fused(*args)
    ry, rh = TR.mamba_scan_fused_ref(*args)
    torch.cuda.synchronize()
    err = max(max_err(y, ry), max_err(hl, rh))
    check(all(torch.allclose(u, v, atol=1e-5, rtol=1e-5)
              for u, v in ((y, ry), (hl, rh))),
          f"mamba_scan_fused_tp2: the kernel disagrees with its plain "
          f"version ({err:.3g})")
    nbytes = 4 * (3 * n_ * s_ * di + 2 * n_ * s_ * ds + di * ds
                  + n_ * di * ds)
    bnd, by = bound_ms(nbytes, n_ * s_ * di * (7 * ds + 1), torch.float32)
    results[("mamba_scan_fused_tp2", torch.float32)] = dict(
        max_abs_err=err, ms=bench(lambda: SS.mamba_scan_fused(*args), flush),
        plain_ms=bench(lambda: TR.mamba_scan_fused_ref(*args), flush,
                       iters=5, warmup=1),
        library_ms=None, bound_ms=bnd, bound_by=by,
        device_ms=device_ms(lambda: SS.mamba_scan_fused(*args), flush,
                            bound=bnd),
        plan=SS.mamba_scan_fused.last_plan,
        shape=f"N={n_} S={s_} d_inner={di} d_state={ds}")
    r = results[("mamba_scan_fused_tp2", torch.float32)]
    print(f"[tp-blocks] mamba_scan_fused_tp2 f32 ({r['shape']}, plan "
          f"{r['plan']}): {r['ms']:.4f} ms (device "
          f"{fmt_ms(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}); max_abs_err {err:.3g}")
    del y, hl, ry, rh, args
    scan_grad_rows(dev, flush, results, TPB_SCAN_TRAIN,
                   "mamba_scan_fused_train_tp2")
    b, h, sq, skv, d = TPB_CROSS
    qp = torch.arange(sq, dtype=torch.int32, device=dev)
    kp = torch.arange(skv, dtype=torch.int32, device=dev)
    ones = torch.ones((skv,), dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (rnd(shape).to(dt).requires_grad_() for shape in (
            (b, h, sq, d), (b, h, skv, d), (b, h, skv, d)))
        g = rnd((b, h, sq, d)).to(dt)

        def kern():
            return _grads_of(lambda *t: TF.flash_attention_bhsd(
                *t, qp, kp, ones, causal=False), (q, k, v), g)

        def plain():
            return _grads_of(lambda *t: TR.flash_attention_ref(
                *t, qp, kp, ones, causal=False), (q, k, v), g)

        def lib():
            return _grads_of(F.scaled_dot_product_attention, (q, k, v), g)
        n0 = TF.flash_attention_bhsd.launches
        (out, grads), (pout, pgrads) = kern(), plain()
        torch.cuda.synchronize()
        check(TF.flash_attention_bhsd.launches == n0 + 1,
              "flash_attention_train_cross_tp2: the gradient route must "
              "launch the kernel once")
        err = assert_close("flash_attention_train_cross_tp2", out, pout, dt)
        gerr = max(grad_err(a, r) for a, r in zip(grads, pgrads))
        check(gerr <= TOL[dt], f"flash_attention_train_cross_tp2 {dt}: "
                               f"gradients {gerr:.3g} of their largest")
        ms = bench(kern, flush)
        fwd_ms = bench(lambda: TF.flash_attention_bhsd(
            q.detach(), k.detach(), v.detach(), qp, kp, ones, causal=False),
            flush)
        plain_ms = bench(plain, flush, iters=5, warmup=1)
        lib_ms = bench(lib, flush)
        esz = q.element_size()
        nbytes = esz * (2 * q.numel() + 2 * g.numel()
                        + 2 * (k.numel() + v.numel()))
        bound, by = bound_ms(nbytes, 12 * d * b * h * sq * skv, dt)
        results[("flash_attention_train_cross_tp2", dt)] = dict(
            max_abs_err=err, grad_err=gerr, ms=ms, fwd_ms=fwd_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms)
        print(f"[tp-blocks] flash_attention_train_cross_tp2 {str(dt)[6:]} "
              f"(B={b} H={h} Sq={sq} Skv={skv} D={d} non-causal): forward "
              f"+ backward {ms:.4f} ms (kernel forward {fwd_ms:.4f}), plain "
              f"{plain_ms:.4f}, sdpa {lib_ms:.4f}, bound {bound:.4f} ms "
              f"({by}); gradients {gerr:.3g} of their largest from the "
              f"plain version's")
        del q, k, v, g, out, grads, pout, pgrads
    torch.cuda.empty_cache()


def tp_blocks_phase(dev, kernels, card):
    """Phase 12: the kernel rows at a rank's shapes (this process), then
    ``TPB_RANKS`` rank processes on the one card over gloo
    (``tp_blocks_rank``); their results checked and printed here.
    Returns the phase's readings and its kernel rows."""
    t0 = time.perf_counter()
    results = {}
    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    tpb_kernel_rows(dev, flush, results)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    rows_s = time.perf_counter() - t0
    out_dir = os.path.join(HERE, "build", "tp_blocks_phase")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spawn_ranks("tp_blocks", "tp_blocks_rank(", TPB_RANKS, out_dir, dev,
                TPB_TIMEOUT)
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
           for r in range(TPB_RANKS)]
    out = report_tp_blocks(res, card)
    out["kernel_rows_s"] = rows_s
    out["phase_s"] = time.perf_counter() - t0
    out["kernels"] = results
    print(f"[tp-blocks] phase {out['phase_s']:.1f} s (kernel rows "
          f"{rows_s:.1f} s)")
    return out


def report_tp_blocks(res, card):
    """Phase 12's checks and lines, from the ranks' results."""
    r0 = res[0]
    print(f"[tp-blocks] {TPB_RANKS} ranks on one device over "
          f"{r0['backend']}, (data, model) = (1, {TPB_RANKS}): setup "
          f"{r0['setup_s']:.1f} s, parity {r0['parity_s']:.1f} s, plan "
          f"{r0['plan_s']:.1f} s, runs {r0['run_s']:.1f} s")
    for arch in TPB_ARCHS:
        row = r0["parity"][arch]
        g_err = max(r["parity"][arch]["grad_err"] for r in res)
        p_err = max(r["parity"][arch]["param_abs"] for r in res)
        p_rel = max((r["parity"][arch]["worst"] for r in res),
                    key=lambda w: w[0])
        dl = abs(row["loss"] - row["ref_loss"])
        dg = abs(row["grad_norm"] - row["ref_norm"]) / row["ref_norm"]
        print(f"[tp-blocks] f32 {arch} reduced ({row['layers']} layers), "
              f"B, S = {TPB_PARITY_SHAPE}, mesh (1, 2), one step: loss "
              f"{row['loss']:.6f} vs unsharded {row['ref_loss']:.6f} (|d| "
              f"{dl:.3g}), grad_norm rel {dg:.3g}, gradients {g_err:.3g} "
              f"of a leaf's largest, params |d| {p_err:.3g} (AdamW "
              f"{SHARD_OPT}; of a leaf's largest at most {p_rel[0]:.3g}, "
              f"{p_rel[1]}: |d| {p_rel[2]:.3g}, its gradient "
              f"{p_rel[3]:.3g}) (both ranks); "
              f"launches {row['launches']}; {row['s']:.1f} s; a step: "
              f"{_fmt_coll(row['stats'])}")
        g_tol, n_tol = TPB_TOL, TPB_NORM_RTOL
        if row["floor"] is not None:
            fl = row["floor"]
            g_tol = max(g_tol, 2 * fl["grad_err"])
            n_tol = max(n_tol, 2 * fl["norm_rel"])
            print(f"[tp-blocks] f32 {arch}'s noise floor: the unsharded step "
                  f"on weights times 1 + {TPB_FLOOR_NOISE} N(0, 1): "
                  f"gradients {fl['grad_err']:.3g} of a leaf's largest, "
                  f"grad_norm rel {fl['norm_rel']:.3g}; gates here "
                  f"{g_tol:.3g}, {n_tol:.3g}")
        check(dl <= TPB_TOL and dg <= n_tol and g_err <= g_tol
              and p_err <= TPB_TOL,
              f"phase 12 parity, {arch}: loss {dl:.3g}, grad_norm {dg:.3g} "
              f"(gate {n_tol:.3g}), gradients {g_err:.3g} (gate "
              f"{g_tol:.3g}), params {p_err:.3g}")
        check(row["launches"]["flash"] > 0 or arch == "xlstm-125m",
              f"phase 12 parity, {arch}: flash never launched")
    check(r0["parity"]["jamba-1.5-large-398b"]["launches"]["scan"] > 0,
          "phase 12 parity: the selective scan never launched")
    pl = r0["plan"]
    print(f"[tp-blocks] f32 {HYBRID} reduced ({TPB_PLAN_LAYERS} layers), "
          f"B, S = {TPB_PLAN_SHAPE}: rank-mode plan_forward, its one stage "
          f"of both groups on the (1, 1, 2) plan mesh, M=2: "
          f"{pl['err']:.3g} of Model.forward's largest |logit|; a rank's "
          f"in_proj {pl['in_proj']}, launches {pl['launches']}; a call: "
          f"{_fmt_coll(pl['stats'])}")
    check(pl["finite"] and pl["err"] <= TPB_PLAN_TOL
          and all(r["plan"]["launches"]["scan"] > 0 for r in res),
          f"phase 12 plan: {pl['err']:.3g} of the largest |logit| "
          f"(tolerance {TPB_PLAN_TOL}), launches {pl['launches']}")
    for label, what in (("xlstm", f"xlstm-125m {TPB_XLSTM[0]} layers, B, "
                                  f"S = {TPB_XLSTM[1:]}"),
                        ("whisper", f"whisper-base, B={TPB_WHISPER[0]}, "
                                    f"{TPB_WHISPER[1]} frames, "
                                    f"{TPB_WHISPER[2]} decoder tokens"),
                        ("deit", f"deit-t, B={TPB_DEIT[0]}, "
                                 f"{TPB_DEIT[1]} patches")):
        row = r0[label]
        peaks = ", ".join(f"{r[label]['peak_gb']:.3f}" for r in res)
        cos = (f"gradients' cosine with the unsharded step's "
               f"{row['cosine']:.6f} (smallest leaf {row['worst_cosine']:.6f}"
               f", {row['worst_leaf']})")
        if "witness" in row:
            cos = (f"at S={TPB_XLSTM_COS_SEQ}: loss {row['cos_loss']:.4f} "
                   f"(unsharded {row['ref_loss']:.4f}, f32 "
                   f"{row['witness_loss']:.4f}), {cos}; the witness, "
                   f"the unsharded bf16 gradients' cosine with the f32 "
                   f"ones: {row['witness']:.6f} (smallest leaf "
                   f"{row['witness_worst']:.6f}, {row['witness_leaf']}), "
                   f"the sharded bf16 ones' {row['sharded_vs_f32']:.6f}: "
                   f"not gated; in f32 the sharded gradients' cosine with "
                   f"the unsharded ones {row['f32_cosine']:.6f} (smallest "
                   f"leaf {row['f32_worst_cosine']:.6f}, "
                   f"{row['f32_worst_leaf']}): gated")
        else:
            cos = f"unsharded loss {row['ref_loss']:.4f}; {cos}"
        print(f"[tp-blocks] bf16 {what}, remat, mesh (1, 2) ({card}): a "
              f"step {row['step_ms']:.2f} ms ({row['per_s']:.1f} "
              f"{row['unit']}/s), loss {row['loss']:.4f}, grad_norm "
              f"{row['grad_norm']:.4g}; {cos}; the unsharded "
              f"value_and_grad {row['ref_ms']:.2f} ms; peak by rank "
              f"{peaks} GB; launches {row['launches']}; a step: "
              f"{_fmt_coll(row['stats'])}; {row['s']:.1f} s")
        check(np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
              and row.get("f32_cosine", row["cosine"]) >= TPB_COSINE,
              f"phase 12 {label}: loss {row['loss']}, gradients' cosine "
              f"{row.get('f32_cosine', row['cosine']):.4f} (at least "
              f"{TPB_COSINE})")
        check(row["launches"]["flash"] > 0 or label == "xlstm",
              f"phase 12 {label}: flash never launched")
    for label, what in (("jamba", f"{HYBRID}, one period ({TPB_JAMBA[0]} "
                                  f"layers), B, S = {TPB_JAMBA[1:]}"),
                        ("vlm", f"qwen2-vl-72b, {TPB_VLM[0]} layer and the "
                                f"head, B, S = {TPB_VLM[1:]}, distinct "
                                f"M-RoPE streams")):
        row = r0[label]
        res_gb = ", ".join(f"{r[label]['resident_gb']:.3f}" for r in res)
        card_gb = max(r[label]["card_gb"] for r in res)
        print(f"[tp-blocks] bf16 {what}, forward on (1, 2) ({card}): "
              f"{row['ms']:.2f} ms against the unsharded "
              f"{row['ref_ms']:.2f} ms; logits {row['shape']} cosine "
              f"{row['cosine']:.6f}, {row['argmax_differ']} of "
              f"{row['decided']} decided argmaxes differ; resident params "
              f"by rank {res_gb} GB, the card's used memory at most "
              f"{card_gb:.2f} GB (builds one rank at a time); launches "
              f"{row['launches']}; a forward: {_fmt_coll(row['stats'])}; "
              f"{row['s']:.1f} s")
        check(row["finite"] and row["cosine"] >= TPB_COSINE
              and row["argmax_differ"] == 0 and card_gb < 70,
              f"phase 12 {label}: cosine {row['cosine']:.4f}, "
              f"{row['argmax_differ']} decided argmaxes differ, card "
              f"{card_gb:.1f} GB")
    check(r0["jamba"]["launches"]["scan"] > 0
          and r0["vlm"]["launches"]["flash"] > 0,
          f"phase 12 forwards: launches {r0['jamba']['launches']}, "
          f"{r0['vlm']['launches']}")
    return dict(ranks=res,
                scan_launches=r0["jamba"]["launches"]["scan"],
                scan_train_launches=r0["parity"][
                    "jamba-1.5-large-398b"]["launches"]["scan"],
                cross_launches=r0["whisper"]["launches"]["flash"])


def tp_blocks_only():
    """``python3 chip_smoke.py --tp-blocks``: the card's line, the
    kernels' build and phase 12 alone; the ranks' results go to
    ``chiprun_out/phase12/``.  It prints no kernels line and no ok
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    _build.load_library()
    print(f"[build] {time.perf_counter() - t_start:.1f} s")
    rc = 0
    try:
        tp_blocks_phase("cuda", {"flash_attention": flash_attention_bhsd},
                        card)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    out_dir = os.path.join(HERE, "chiprun_out", "phase12")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(HERE, "build", "tp_blocks_phase")
    if os.path.isdir(src):
        for name in os.listdir(src):
            if not name.startswith("store"):
                shutil.copy(os.path.join(src, name), out_dir)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    return rc


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off for matmuls and cuDNN (f32 is f32)")
    dev = "cuda"

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.fused_matmul import matmul_fused
    from repro_torch.kernels.layernorm import norm_onepass
    from repro_torch.kernels.linear_scan import linear_scan
    from repro_torch.kernels.paged_attention import (
        fused_paged_decode_grouped, paged_attention_grouped,
        paged_prefill_attention_grouped, paged_verify_attention_grouped)
    from repro_torch.kernels.selective_scan import mamba_scan_fused
    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({_build.last_build})")

    def front_door_counts():
        return {"matmul_fused": matmul_fused.launches,
                "norm_onepass": norm_onepass.launches}

    flush = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)
    try:
        t0 = time.perf_counter()
        results = kernel_phase(dev, flush)
        int8_kernel_phase(dev, flush, results)
        hybrid_kernel_phase(dev, flush, results)
        replica_kernel_phase(dev, flush, results)
        group_kernel_phase(dev, flush, results)
        gemma2_kernel_phase(dev, flush, results)
        t1 = time.perf_counter()
        encoder_kernel_phase(dev, flush, results)
        print(f"[kernels] encoders {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        vlm_kernel_phase(dev, flush, results)
        flash_shape_rows(dev, flush, results, PLAN_MESH_FLASH, 37)
        print(f"[kernels] qwen2-vl, plan mesh "
              f"{time.perf_counter() - t1:.1f} s")
        front_door_phase(dev, flush, results)
        repair = repair_phase(dev, flush)
        del flush
        torch.cuda.empty_cache()
        print(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
        kernels = {"fused_paged_decode": fused_paged_decode_grouped,
                   "paged_attention": paged_attention_grouped,
                   "paged_prefill": paged_prefill_attention_grouped,
                   "paged_verify": paged_verify_attention_grouped,
                   "flash_attention": flash_attention_bhsd,
                   "linear_scan": linear_scan,
                   "mamba_scan_fused": mamba_scan_fused,
                   "matmul_fused": matmul_fused,
                   "norm_onepass": norm_onepass}
        t0 = time.perf_counter()
        parity = parity_phase(dev)
        parity["plan"] = plan_parity_phase(dev, kernels)
        parity["hybrid"] = hybrid_parity_phase(dev, kernels)
        parity["overlap"] = overlap_parity_phase(dev, kernels)
        t1 = time.perf_counter()
        parity["families"] = family_parity_phase(dev, kernels)
        print(f"[parity] families {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        parity["gemma2"] = gemma2_parity_phase(dev, kernels)
        print(f"[parity] gemma2 {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        parity["encoders"] = encoder_parity_phase(dev, kernels)
        print(f"[parity] encoders {time.perf_counter() - t1:.1f} s")
        for label, fn in (("xlstm", xlstm_parity_phase),
                          ("vlm", vlm_parity_phase),
                          ("jamba_moe", jamba_moe_parity_phase)):
            t1 = time.perf_counter()
            parity[label] = fn(dev, kernels)
            print(f"[parity] {label} {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        parity["replan"] = replan_parity_phase(dev, kernels)
        print(f"[replan] phase {time.perf_counter() - t1:.1f} s")
        print(f"[parity] phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served = serve_phase(dev, kernels)
        served["front_door_launches"] = front_door_counts()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        served["hybrid"] = serve_hybrid_phase(dev, kernels)
        print(f"[serve] serve-hybrid {time.perf_counter() - t1:.1f} s")
        served["hybrid"]["front_door_launches"] = front_door_counts()
        for arch, label in (("qwen2-moe-a2.7b", "serve-moe"),
                            ("nemotron-4-15b", "serve-nemotron")):
            t1 = time.perf_counter()
            served[label] = serve_family_phase(dev, kernels, arch, label)
            print(f"[serve] {label} {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        served["serve-gemma2"] = serve_gemma2_phase(dev, kernels)
        print(f"[serve] serve-gemma2 {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        served["encoders"] = encoder_run_phase(dev, kernels, card)
        print(f"[run] encoders {time.perf_counter() - t1:.1f} s")
        for label, fn in (("serve-xlstm", serve_xlstm_phase),
                          ("run-vlm", vlm_run_phase),
                          ("serve-jamba-moe", serve_jamba_moe_phase)):
            t1 = time.perf_counter()
            served[label] = fn(dev, kernels, card)
            print(f"[serve] {label} {time.perf_counter() - t1:.1f} s")
        print(f"[serve] front-door kernels launched by the serves (no model "
              f"calls them, as in JAX): yi-6b serves "
              f"{json.dumps(served['front_door_launches'])}, hybrid "
              f"{json.dumps(served['hybrid']['front_door_launches'])}")
        print(f"[serve] phase {time.perf_counter() - t0:.1f} s")
        training = train_phase(dev, kernels, card)
        results.update(training.pop("kernels"))
        placement = placement_phase(dev, kernels, card)
        sharded = sharded_phase(dev, kernels, card)
        plan_mesh = plan_mesh_phase(dev, kernels, card)
        tp_blocks = tp_blocks_phase(dev, kernels, card)
        results.update(tp_blocks.pop("kernels"))
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
        "paged_prefill_s600": prefill,
        "paged_prefill_int8": prefill,
        "paged_prefill_int8_s600": prefill,
        # no Pallas kernel: the JAX package runs verify as jnp
        "paged_verify": ("src/repro_torch/csrc/paged_prefill.cu",
                         "src/repro/backend/dispatch.py:232"),
        "paged_verify_fp": ("src/repro_torch/csrc/paged_prefill.cu",
                            "src/repro/backend/dispatch.py:232"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85"),
        "flash_attention_cont": ("src/repro_torch/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:85"),
        "paged_prefill_s48": prefill,
        "fused_paged_decode_g6": decode,
        "fused_paged_decode_g7": decode,
        "fused_paged_decode_int8_g6": decode,
        "fused_paged_decode_int8_g7": decode,
        "fused_paged_decode_g1": decode,
        "fused_paged_decode_int8_g1": decode,
        "fused_paged_decode_g2_d64": decode,
        "fused_paged_decode_int8_g2_d64": decode,
        "paged_attention_g6": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:394"),
        "paged_prefill_g6": prefill,
        "flash_attention_d256": ("src/repro_torch/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:85"),
        "paged_prefill_d256": prefill,
        "paged_prefill_d256_s256": prefill,
        "paged_prefill_int8_d256": prefill,
        "fused_paged_decode_d256": decode,
        "fused_paged_decode_int8_d256": decode,
        # no Pallas kernel: JAX decodes a local ring with jnp per slot
        "paged_attention_ring_d256": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/models/layers.py:512"),
        **{row[0]: ("src/repro_torch/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:85")
           for row in ENCODER_FLASH + VLM_FLASH + PLAN_MESH_FLASH},
        "fused_paged_decode_b2": decode,
        "fused_paged_decode_int8_b2": decode,
        "paged_attention_b2": ("src/repro_torch/csrc/paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:394"),
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:394"),
        "linear_scan": ("src/repro_torch/csrc/linear_scan.cu",
                        "src/repro/kernels/linear_scan.py:46"),
        "linear_scan_prefill": ("src/repro_torch/csrc/linear_scan.cu",
                                "src/repro/kernels/linear_scan.py:46"),
        "linear_scan_odd_f": ("src/repro_torch/csrc/linear_scan.cu",
                              "src/repro/kernels/linear_scan.py:46"),
        # no Pallas kernel: the JAX package's default mamba prefill is jnp
        "mamba_scan_fused": ("src/repro_torch/csrc/selective_scan.cu",
                             "src/repro/models/ssm.py:31"),
        "mamba_scan_fused_b4": ("src/repro_torch/csrc/selective_scan.cu",
                                "src/repro/models/ssm.py:31"),
        # phase 8: the gradient routes at training shapes
        **{row[0]: ("src/repro_torch/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:85")
           for row in GRAD_FLASH},
        "mamba_scan_fused_train": ("src/repro_torch/csrc/selective_scan.cu",
                                   "src/repro/models/ssm.py:31"),
        # phase 12: a rank's shapes at model=2
        "mamba_scan_fused_tp2": ("src/repro_torch/csrc/selective_scan.cu",
                                 "src/repro/models/ssm.py:31"),
        "mamba_scan_fused_train_tp2": (
            "src/repro_torch/csrc/selective_scan.cu",
            "src/repro/models/ssm.py:31"),
        "flash_attention_train_cross_tp2": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:85"),
        **{name: ("src/repro_torch/csrc/fused_matmul.cu",
                  "src/repro/kernels/fused_matmul.py:59")
           for name in FRONT_DOOR_MATMULS},
        **{name: ("src/repro_torch/csrc/layernorm.cu",
                  "src/repro/kernels/layernorm.py:34")
           for name in FRONT_DOOR_NORMS},
    }
    # launches: serve-full and serve-int8-spec for yi-6b's kernels,
    # serve-hybrid and serve-jamba-moe for jamba's (the scan rows are one
    # wrapper's count, the selective scan's another), the front-door run
    # for the matmul and norm rows (one count each)
    jm = served["serve-jamba-moe"]["launches"]
    hy = {k: n + jm[k] for k, n in served["hybrid"]["launches"].items()}
    fam = parity["families"]
    g2 = served["serve-gemma2"]["launches"]
    gi8 = parity["gemma2"]["int8_launches"]
    launches = {**served["launches"], "paged_attention": hy["paged_attention"],
                "linear_scan": hy["linear_scan"],
                "linear_scan_prefill": hy["linear_scan"],
                "linear_scan_odd_f": hy["linear_scan"],
                "mamba_scan_fused": hy["mamba_scan_fused"],
                "mamba_scan_fused_b4": hy["mamba_scan_fused"],
                "paged_prefill_s600": served["launches"]["paged_prefill"],
                "paged_prefill_int8_s600":
                    served["launches"]["paged_prefill_int8"],
                # one wrapper and kernel for both pool kinds; only
                # serve-int8-spec speculates (on int8 pools)
                "paged_verify_fp": served["launches"]["paged_verify"],
                # the plan paths: the dense plan parity run's continuation
                # chunks (its chunk-0 passes left out); serve-plan's
                # paged-prefill chunks at offsets > 0 (S=128 and the
                # remainders: the S=48 row stands for the CLI's
                # --chunk 48, which no phase serves) and its replicas'
                # fused decodes; the int8 plan's and the hybrid plan's
                # replica decodes (f32 parity runs)
                "flash_attention_cont":
                    parity["plan"]["flash_continuations"],
                "paged_prefill_s48": served["plan"]["prefill_continuations"],
                "fused_paged_decode_b2":
                    served["plan"]["launches"]["fused_paged_decode"],
                "fused_paged_decode_int8_b2":
                    parity["plan"]["launches"]["int8_spec"][
                        "fused_paged_decode"],
                "paged_attention_b2":
                    parity["hybrid"]["plan_launches"]["paged_attention"],
                # the G rows: serve-nemotron (G=6), serve-moe (G=1) and the
                # f32 parity runs of yi-34b (G=7), granite-moe (G=2, D=64)
                # and of all four on int8 pools; no config of the registry
                # has rope-free attention at G=6, so no path launches the
                # unfused decode there
                "fused_paged_decode_g6":
                    served["serve-nemotron"]["launches"]["fused_paged_decode"],
                "fused_paged_decode_g7":
                    fam["yi-34b"]["launches"]["fused_paged_decode"],
                "fused_paged_decode_g1":
                    served["serve-moe"]["launches"]["fused_paged_decode"],
                "fused_paged_decode_g2_d64":
                    fam[GRANITE]["launches"]["fused_paged_decode"],
                **{f"fused_paged_decode_int8_{tag}":
                   fam[arch]["int8_launches"]["fused_paged_decode"]
                   for tag, arch in (("g6", "nemotron-4-15b"),
                                     ("g7", "yi-34b"),
                                     ("g1", "qwen2-moe-a2.7b"),
                                     ("g2_d64", GRANITE))},
                "paged_attention_g6": 0,
                "paged_prefill_g6":
                    served["serve-nemotron"]["launches"]["paged_prefill"],
                # head_dim 256: serve-gemma2 and the f32 gemma2 int8
                # parity run; serve-gemma2's paged prefills all start at
                # offset 0 (gemma2 reuses no prefix compute), so none is
                # at the S=256-from-4096 row's shape
                **{f"{k}_d256": g2[k] for k in ("flash_attention",
                                                "paged_prefill",
                                                "fused_paged_decode")},
                "paged_prefill_d256_s256": 0,
                "paged_attention_ring_d256": g2["paged_attention"],
                **{f"{k}_int8_d256": gi8[k]
                   for k in ("paged_prefill", "fused_paged_decode")},
                # the encoders' rows: the bf16 ViT and whisper runs;
                # qwen2-vl's: run-vlm
                **served["encoders"]["launches"],
                **served["run-vlm"]["launches"],
                # phase 8: train-yi's steps (forward + remat's recompute);
                # the hybrid's gradient check for the scan; no training
                # path runs the D=256 or ViT shapes
                "flash_attention_train":
                    training["train_yi"]["flash_launches"],
                "flash_attention_train_d256": 0,
                "flash_attention_train_vit": 0,
                # phase 10: rank 0's launches in the sharded bf16 run
                "flash_attention_train_tp2": sharded["flash_launches"],
                # phase 11: every rank's in the checked bf16 plan_forward
                "flash_attention_tp2_fwd": plan_mesh["flash_launches"],
                "mamba_scan_fused_train":
                    training["model_grads"]["jamba-hybrid-reduced"][
                        "launches"]["mamba_scan_fused"],
                # phase 12, rank 0: the bf16 hybrid period's forward (the
                # row's shape), the f32 jamba step's scans (reduced), the
                # bf16 whisper step's flash (encoder, self and cross)
                "mamba_scan_fused_tp2": tp_blocks["scan_launches"],
                "mamba_scan_fused_train_tp2": tp_blocks["scan_train_launches"],
                "flash_attention_train_cross_tp2":
                    tp_blocks["cross_launches"]}
    low = [f"{n} {str(dt)[6:]}: {r['device_ms']:.4f} < {r['bound_ms']:.4f}"
           for (n, dt), r in results.items()
           if r.get("device_ms") is not None
           and r["device_ms"] < r["bound_ms"]]
    check(not low, f"device times below their bound (missed kernels): "
                   f"{low}")
    line = []
    for name, (src, tpu) in meta.items():
        r = results.get((name, torch.bfloat16),
                        results.get((name, torch.float32)))
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu,
                     "launches": r.get("launches", launches.get(name)),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "splits": r.get("splits", 1),
                     **({"library": r["library"]} if "library" in r else {}),
                     **({"path": r["path"]} if "path" in r else {}),
                     **({"was_ms": r["was_ms"]} if "was_ms" in r else {}),
                     **{k: r[k] for k in ("fwd_ms", "grad_err") if k in r},
                     "grad": GRAD_ROUTE.get(src, "none: raises when asked "
                                                 "for a gradient")})
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernels": {f"{n} {str(dt)[6:]}": r
                               for (n, dt), r in results.items()},
                   "parity": parity, "repair": repair, "serve": served,
                   "training": training, "placement": placement,
                   "sharded": sharded, "plan_mesh": plan_mesh,
                   "tp_blocks": tp_blocks,
                   "device_unread": device_ms.unread,
                   "build": _build.last_build,
                   "seconds": time.perf_counter() - t_start}, f, indent=1,
                  default=str)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def sharded_only():
    """``python3 chip_smoke.py --sharded``: the card's line, the kernels'
    build and phase 10 alone, to time that phase apart from the smoke;
    the ranks' results go to ``chiprun_out/phase10/``.  It prints no
    kernels line and no ok line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    _build.load_library()
    print(f"[build] {time.perf_counter() - t_start:.1f} s")
    rc = 0
    try:
        sharded_phase("cuda", {"flash_attention": flash_attention_bhsd},
                      card)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    out_dir = os.path.join(HERE, "chiprun_out", "phase10")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(HERE, "build", "shard_phase")
    for name in os.listdir(src):
        if not name.startswith("store"):
            shutil.copy(os.path.join(src, name), out_dir)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    return rc


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


def plan_mesh_only():
    """``python3 chip_smoke.py --plan-mesh``: the card's line, the
    kernels' build and phase 11 alone; the ranks' results go to
    ``chiprun_out/phase11/``.  It prints no kernels line and no ok
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    _build.load_library()
    print(f"[build] {time.perf_counter() - t_start:.1f} s")
    rc = 0
    try:
        plan_mesh_phase("cuda", {"flash_attention": flash_attention_bhsd},
                        card)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    out_dir = os.path.join(HERE, "chiprun_out", "phase11")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(HERE, "build", "plan_mesh_phase")
    for name in os.listdir(src):
        if not name.startswith("store"):
            shutil.copy(os.path.join(src, name), out_dir)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    return rc


P2P_CHILD = """
import datetime, json, sys
sys.path.insert(0, {here!r})
import torch
import torch.distributed as dist
import chip_smoke
rank, op, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
json.dump(chip_smoke.gloo_probe("cuda:0", (op,)), open(out, "w"))
dist.destroy_process_group()
"""


def probe_p2p_only():
    """``python3 chip_smoke.py --probe-p2p``: whether gloo takes each of
    ``P2P_PROBE`` on CUDA tensors, each op in its own pair of rank
    processes on cuda:0 (a rank that gloo aborts takes only its pair
    down); prints each rank's answer or exit code and log tail, then the
    card's line.  It prints no ok line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(HERE, "chiprun_out", "p2p_probe")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = []
    for op in P2P_PROBE:
        store = os.path.join(out_dir, f"store_{op}")
        for r in range(2):
            log = open(os.path.join(out_dir, f"{op}_rank{r}.log"), "w")
            procs.append((op, r, subprocess.Popen(
                [sys.executable, "-c", P2P_CHILD.format(here=HERE), str(r),
                 op, store, os.path.join(out_dir, f"{op}_rank{r}.json")],
                stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.perf_counter() + 150
    while any(p.poll() is None for _, _, p, _ in procs) \
            and time.perf_counter() < deadline:
        time.sleep(0.5)
    for op, r, p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
        path = os.path.join(out_dir, f"{op}_rank{r}.json")
        got = json.load(open(path))[op] if os.path.exists(path) else None
        with open(os.path.join(out_dir, f"{op}_rank{r}.log")) as f:
            tail = [ln for ln in f.read().splitlines() if ln.strip()][-2:]
        print(f"[p2p] {op} rank {r}: exit {p.returncode}, "
              f"{got if got is not None else ' / '.join(tail)}")
    print(card_line())
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}")
    return 0


if __name__ == "__main__":
    sys.exit({"--sharded": sharded_only, "--plan-mesh": plan_mesh_only,
              "--tp-blocks": tp_blocks_only,
              "--probe-p2p": probe_p2p_only}.get(
                  " ".join(sys.argv[1:]), main)())
