"""Serving launcher of the port: batched greedy inference through the
monolithic continuous-batching engine, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --paged
    PYTHONPATH=src python -m repro_torch.launch.serve --paged \\
        --kv-dtype int8 --speculate 4
    PYTHONPATH=src python -m repro_torch.launch.serve --layers 2 --paged \\
        --requests 4 --new-tokens 8

The model is the registry config at its published width (yi-6b: d_model
4096, 32 heads, 4 KV heads, head_dim 128), with random weights from a
seeded ``torch.Generator``; ``--layers N`` cuts the depth to N layers.
``--paged [--page-size N --num-blocks M]`` serves from the block pool
(the fused decode and paged prefill kernels); without it the dense slot
cache (flash attention at admission).  ``--prefix-cache`` /
``--no-prefix-cache`` (paged only; default on) toggles prefix compute
reuse.  ``--kv-dtype int8`` (paged only) stores the pools as int8 rows
with per-row scales; ``--speculate K`` drafts up to K tokens per slot by
prompt lookup and verifies them in one batched step (``--no-speculate``
forces it off).  ``--device cpu`` runs the plain PyTorch versions instead
of the CUDA kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


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
    ap.add_argument("--kv-dtype", default="fp", choices=("fp", "int8"),
                    help="with --paged: K/V block-pool storage dtype; int8 "
                         "adds per-row scales for ~1.9x capacity in bf16")
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
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain PyTorch versions")
    prefix_cache = True if args.prefix_cache is None else args.prefix_cache

    cfg = REGISTRY[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model.init(gen)
    eng = ServingEngine(model, params, slots=args.slots,
                        max_seq=args.max_seq, paged=args.paged,
                        page_size=args.page_size, num_blocks=args.num_blocks,
                        prefix_cache=prefix_cache, speculate=args.speculate,
                        kv_dtype=args.kv_dtype)
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
    if st["spec_steps"]:
        extra += (f", spec k={args.speculate}: "
                  f"tok_per_step={st['tokens_per_step']:.2f}"
                  f" accept={st['acceptance_rate']:.2f}")
    elif args.speculate:
        extra += (", spec: no drafts" if eng._spec_k else
                  ", spec: gated off (family not verify-decomposable)")
    print(f"[serve] {len(done)} requests, {st['gen_tokens']} tokens, "
          f"{st['gen_tokens'] / wall:.1f} tok/s, "
          f"occupancy={st['slot_occupancy']:.2f}, "
          f"kernels={st['kernel_path']}{extra}")


if __name__ == "__main__":
    main()
