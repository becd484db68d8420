"""Serving launcher of the port: batched greedy inference through the
continuous-batching engine, monolithic or plan-driven, on the GPU by
default.

    PYTHONPATH=src python -m repro_torch.launch.serve --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --paged \\
        --kv-dtype int8 --speculate 4
    PYTHONPATH=src python -m repro_torch.launch.serve --layers 2 --paged \\
        --requests 4 --new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b-dense-ffn --layers 16 --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch gemma2-9b --paged --max-seq 8192
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b-8e --layers 8 --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --paged \\
        --strategy hybrid:2 --replicas 2 --chunk 128 --max-seq 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --layers 4 --paged --strategy pipeline:2 --replicas 2 --chunk 4
    PYTHONPATH=src python -m repro_torch.launch.serve --paged --overlap \\
        --trace serve.json --metrics-out serve.prom
    PYTHONPATH=src python -m repro_torch.launch.serve --paged --adapt \\
        --slo-ttft 0.5 --max-seq 1024 --chunk 128

The model is the registry config at its published width (yi-6b: d_model
4096, 32 heads, 4 KV heads, head_dim 128; yi-34b; nemotron-4-15b with
LayerNorm and a squared-ReLU MLP; the MoE decoders qwen2-moe-a2.7b and
granite-moe-1b-a400m; gemma2-9b with its alternating local (window 4096)
and global layers, attention and final logit softcaps, post-block norms
and GeGLU at head_dim 256; the jamba hybrid with dense FFNs: d_model
8192, 64 heads, 8 KV heads, mamba d_inner 16384, or with its MoE
layers, published or cut to 8 experts; xlstm-125m's mLSTM and sLSTM
stack, which has no KV to page: ``--paged`` falls back to the dense
layout), with
random weights from a seeded ``torch.Generator``; ``--layers N`` cuts
the depth to N layers (a multiple of the block pattern's period: 8 for
jamba).
``--paged [--page-size N --num-blocks M]`` serves from the block pool
(the fused decode and paged prefill kernels); without it the dense slot
cache (flash attention at admission).  ``--prefix-cache`` /
``--no-prefix-cache`` (paged only; default on) toggles prefix compute
reuse.  ``--kv-dtype int8`` (paged only) stores the pools as int8 rows
with per-row scales; ``--speculate K`` drafts up to K tokens per slot by
prompt lookup and verifies them in one batched step (``--no-speculate``
forces it off).  ``--overlap`` dispatches decode step N+1 before step N's
tokens are read back (the streams stay the same; an effective
``--speculate`` runs sync, and the line says ``overlap=sync(spec)``).
``--trace OUT.json`` records the engine's spans and writes them as
Perfetto trace_event JSON; ``--metrics-out OUT.prom`` writes the
Prometheus text metrics (TTFT/TPOT histograms, utilization gauges) after
the run.  ``--device cpu`` runs the plain PyTorch versions instead of the
CUDA kernels.

Plan-driven serving, as the JAX launcher's: ``--strategy pipeline:S``
serves a uniform S-stage cut, ``--strategy hybrid:N`` the SSR search's
N-accelerator plan (``_build_serving_plan``: the evolutionary search over
8 chips of the cost model's default chip, with the same arguments and
seed as the JAX launcher, so both lower the same plan for the same
config).  The plan's stages then run the chunked prefill (``--chunk``
tokens a chunk, one stage-step a tick) and ``--replicas`` slot-partitioned
decode replicas walk them; on one card every stage and replica shares the
device.  ``--adapt`` re-plans the engine live between the monolithic
point, the requested plan (a 2-stage cut when serving starts monolithic)
and its re-replicated variants (``_adaptive_ladder``) as the traffic
shifts; ``--slo-ttft S`` / ``--slo-tpot S`` give the controller its SLO
targets.  The candidates are measured and exercised before the clock
(``warm_replans``), and the run prints the controller's decisions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY, ShapeConfig
from repro_torch.models import build_model
from repro_torch.obs import write_metrics
from repro_torch.serving import AdaptiveConfig, Request, ServingEngine


def _parse_strategy(strategy: str):
    """'pipeline:S' / 'hybrid:N' -> (kind, n); a usage error otherwise."""
    kind, _, n = strategy.partition(":")
    if kind in ("pipeline", "hybrid") and n.isdigit() and int(n) >= 1:
        return kind, int(n)
    raise SystemExit(f"bad --strategy {strategy!r} "
                     f"(mono | pipeline:S | hybrid:N)")


def _build_serving_plan(cfg, strategy: str, slots: int, replicas: int,
                        chunk: int, max_seq: int):
    """Lower the requested strategy to a ServingPlan (None = monolithic),
    exactly as the JAX launcher does."""
    from repro_torch.plan import lower, lower_serving, uniform_plan

    if strategy in ("mono", "sequential"):
        return None
    reps = replicas or min(2, slots)
    kind, n = _parse_strategy(strategy)
    if kind == "pipeline":
        plan = uniform_plan(cfg.num_groups, n, n_microbatches=reps)
    else:
        from repro_torch.core import build_graph, evolutionary_search, \
            ssr_dse
        from repro_torch.core.assignment import contiguous_assignment
        n_acc = n
        g = build_graph(cfg, ShapeConfig("serve", max_seq, 8, "prefill"))
        res = evolutionary_search(g, 8, n_acc=n_acc, n_batches=2, n_pop=6,
                                  n_child=6, n_iter=3, seed=0)
        plan = lower(res.assignment, g, mesh_devices=8, n_microbatches=reps)
        if plan.n_stages < n_acc:
            # the EA legitimately collapses uniform stacks onto sequential;
            # serve the N-stage cut through the same customization pass
            _, _, assign = ssr_dse(
                g, contiguous_assignment(g, n_acc, 8).acc_of, 8,
                n_batches=n_acc)
            plan = lower(assign, g, mesh_devices=8, n_microbatches=reps)
    return lower_serving(plan, slots=slots, chunk=chunk)


def _adaptive_ladder(cfg, splan, slots: int, chunk: int):
    """Candidate design points for the re-plan controller, as the JAX
    launcher's: mono, the requested plan (or a 2-stage cut when serving
    started monolithic) and its re-replicated spatial-width variants --
    one searched stage cut, several Pareto points."""
    from repro_torch.plan import (lower_serving, rereplicate_serving,
                                  uniform_plan)
    if splan is None:
        n_stages = 2 if cfg.num_groups % 2 == 0 else 1
        base = lower_serving(
            uniform_plan(cfg.num_groups, n_stages,
                         n_microbatches=min(2, slots)),
            slots=slots, chunk=chunk)
    else:
        base = splan
    cands = [None, base]
    for r in sorted({1, min(2, slots), slots}):
        cand = rereplicate_serving(base, r)
        if all(cand != c for c in cands):
            cands.append(cand)
    return cands


def ffn_kind(cfg) -> str:
    """The FFN kinds of the block pattern: ``dense``, ``moe E×top-k``,
    ``none`` (xLSTM's blocks), or several joined by ``+`` (jamba)."""
    kinds = []
    for b in cfg.block_pattern:
        kind = (b.ffn if b.ffn != "moe" else
                f"moe {cfg.moe.num_experts}×top-{cfg.moe.experts_per_token}")
        if kind not in kinds:
            kinds.append(kind)
    return "+".join(kinds)


def attn_kind(cfg) -> str:
    """What the attention adds to plain global GQA, as ``, key=value``
    parts: the local mixers' sliding window and the attention and final
    logit softcaps (empty for the llama-style decoders)."""
    parts = []
    if any(b.mixer == "attn_local" for b in cfg.block_pattern):
        parts.append(f"window={cfg.window_size}")
    if cfg.attn_logit_softcap:
        parts.append(f"attn_softcap={cfg.attn_logit_softcap:g}")
    if cfg.final_logit_softcap:
        parts.append(f"final_softcap={cfg.final_logit_softcap:g}")
    return "".join(", " + p for p in parts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=sorted(REGISTRY))
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers (0: all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--eos", type=int, default=-1,
                    help="retire a slot on this token id (-1: disabled)")
    ap.add_argument("--strategy", default="mono",
                    help="mono | pipeline:S | hybrid:N (plan-driven)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="spatial decode replicas for plan-driven serving "
                         "(0: min(2, slots))")
    ap.add_argument("--chunk", type=int, default=8,
                    help="prefill chunk length for plan-driven serving")
    ap.add_argument("--adapt", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="online Pareto navigation: re-plan the engine "
                         "between mono / the requested plan / its "
                         "re-replicated variants as traffic shifts "
                         "(zero-copy slot migration on --paged)")
    ap.add_argument("--slo-ttft", type=float, default=0.0, metavar="S",
                    help="with --adapt: target time-to-first-token in "
                         "seconds the controller penalizes against "
                         "(0: no TTFT SLO)")
    ap.add_argument("--slo-tpot", type=float, default=0.0, metavar="S",
                    help="with --adapt: target time-per-output-token in "
                         "seconds the controller penalizes against "
                         "(0: no TPOT SLO)")
    ap.add_argument("--paged", action="store_true",
                    help="pool-backed slot caches with prefix sharing")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV block with --paged")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="block-pool size with --paged "
                         "(0: slots * max_seq / page_size)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="with --paged: prefill only the suffix of a warm "
                         "prefix (default: on)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decode: draft up to K tokens per slot "
                         "(prompt-lookup n-grams) and verify them in one "
                         "batched step; greedy verify keeps streams equal "
                         "to plain decode (0: disabled)")
    ap.add_argument("--no-speculate", action="store_const", const=0,
                    dest="speculate", help="force speculation off")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="overlapped runtime: dispatch decode step N+1 "
                         "before draining step N's tokens (same streams; "
                         "an effective --speculate runs sync)")
    ap.add_argument("--kv-dtype", default="fp", choices=("fp", "int8"),
                    help="with --paged: K/V block-pool storage dtype; int8 "
                         "adds per-row scales for ~1.9x capacity in bf16")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record engine and request lifecycle spans and "
                         "write them here as Chrome/Perfetto trace_event "
                         "JSON")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.prom",
                    help="write Prometheus text-format metrics (TTFT/TPOT "
                         "histograms, utilization gauges) here after the "
                         "run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    if args.kv_dtype != "fp" and not args.paged:
        raise SystemExit("--kv-dtype int8 requires --paged: quantized K/V "
                         "blocks live in the paged block pool")
    if args.prefix_cache and not args.paged:
        raise SystemExit("--prefix-cache requires --paged: prefix blocks "
                         "live in the paged block pool")
    if (args.slo_ttft or args.slo_tpot) and not args.adapt:
        raise SystemExit("--slo-ttft/--slo-tpot set SLO targets for the "
                         "adaptive re-plan controller: pass --adapt (a "
                         "static engine has no controller to penalize)")
    if args.slo_ttft < 0 or args.slo_tpot < 0:
        raise SystemExit("--slo-ttft/--slo-tpot are seconds and must be "
                         ">= 0 (0 disables that SLO term)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain PyTorch versions")
    prefix_cache = True if args.prefix_cache is None else args.prefix_cache

    cfg = REGISTRY[args.arch]
    if args.layers % len(cfg.block_pattern):
        raise SystemExit(f"--layers {args.layers} is not a multiple of "
                         f"{args.arch}'s period of "
                         f"{len(cfg.block_pattern)} layers")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    splan = _build_serving_plan(cfg, args.strategy, args.slots,
                                args.replicas, args.chunk, args.max_seq)
    if splan is not None:
        print(splan.describe())
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen)
    adapt = None
    if args.adapt:
        adapt = AdaptiveConfig(
            plans=_adaptive_ladder(cfg, splan, args.slots, args.chunk),
            slo_ttft_s=args.slo_ttft, slo_tpot_s=args.slo_tpot)
    eng = ServingEngine(model, params, slots=args.slots,
                        max_seq=args.max_seq, plan=splan, paged=args.paged,
                        page_size=args.page_size, num_blocks=args.num_blocks,
                        prefix_cache=prefix_cache, speculate=args.speculate,
                        overlap=args.overlap, kv_dtype=args.kv_dtype,
                        adapt=adapt, trace=bool(args.trace))
    if args.adapt:
        eng.warm_replans()                # candidates exercised off the clock
        eng.reset_stats()
    eos = None if args.eos < 0 else args.eos
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=5).astype(np.int32)
        eng.submit(Request(uid, prompt, args.new_tokens, eos_token=eos))
    done = eng.run()
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    extra = ""
    if "plan_stages" in st:
        extra = (f", {st['plan_stages']} stages x "
                 f"{st['decode_replicas']} replicas (chunk "
                 f"{st['prefill_chunk']})")
    c = st["cache"]
    if c["layout"] == "paged":
        extra += (f", paged p{c['page_size']}: "
                  f"peak {c['peak_blocks_in_use']}/{c['num_blocks']} blocks"
                  f", reuse={c['reuse_hit_rate']:.2f}"
                  f", cow={c['cow_copies']}")
        if c["prefix_cache"]:
            extra += (f", prefix: hit_rate={c['prefill_hit_rate']:.2f}"
                      f" reused_tok={c['reused_prefill_tokens']}")
        if c["kv_dtype"] != "fp":
            extra += (f", kv={c['kv_dtype']}"
                      f" capacity_x={c['kv_capacity_x']:.1f}")
    if args.overlap:
        extra += ", overlap=" + ("on" if eng._overlap else "sync(spec)")
    if st["spec_steps"]:
        extra += (f", spec k={args.speculate}: "
                  f"tok_per_step={st['tokens_per_step']:.2f}"
                  f" accept={st['acceptance_rate']:.2f}")
    elif args.speculate:
        extra += (", spec: no drafts" if eng._spec_k else
                  ", spec: gated off (family not verify-decomposable)")
    if args.adapt:
        extra += (f", adapt: replans={st['replans']}"
                  f" migrations={st['migrations']}"
                  f" (copies={st['migration_copies']})"
                  f" final={st['plan_label']}")
    print(f"[serve] {len(done)} requests, {st['gen_tokens']} tokens, "
          f"{st['gen_tokens'] / wall:.1f} tok/s, "
          f"occupancy={st['slot_occupancy']:.2f}, "
          f"kernels={st['kernel_path']}, ffn={ffn_kind(cfg)}"
          f"{attn_kind(cfg)}{extra}")
    if args.adapt:
        print(f"[serve] adapt decisions (tick, from, to): "
              f"{eng._ctl.decisions}")
    if args.trace:
        eng.write_trace(args.trace)
        print(f"[serve] trace: {args.trace} ({eng._tr.events} events"
              f", {eng._tr.dropped} dropped)")
    if args.metrics_out:
        write_metrics(eng.export_metrics(), args.metrics_out)
        print(f"[serve] metrics: {args.metrics_out}")


if __name__ == "__main__":
    main()
