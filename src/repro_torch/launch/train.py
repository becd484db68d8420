"""Training launcher of the port: the JAX package's ``launch/train.py`` on
one device -- the train loop with AdamW, remat, gradient accumulation,
checkpoint/restart and straggler-aware step timing.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --steps 3 --seq 32 --batch 4 --device cpu     # reduced, plain

By default the config is ``reduced`` (as JAX's launcher always runs it);
``--layers N`` keeps the published width and cuts the depth to N layers
(a multiple of the block pattern's period), as the serve launcher does.
Weights are random, from a ``torch.Generator`` seeded with 0.
``--device cuda`` (the default) runs the hand-written kernels and raises
without a GPU; ``--device cpu`` runs their plain versions.  It prints
``step i: loss=... Nms`` every 5 steps and at the last, ``[straggler]``
lines when a step exceeds the recent median by ``--straggler-warn-ms``,
and ``[train] done``.  With ``--ckpt-dir`` it saves every
``--ckpt-every`` steps and at the end, and resumes from the latest
checkpoint there (``[train] resumed at step N``); there is no mesh to
re-shard onto.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import REGISTRY, ShapeConfig, reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.training import AdamW, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--layers", type=int, default=0,
                    help="published width at N layers (0: reduced)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--straggler-warn-ms", type=float, default=0.0,
                    help="warn when a step exceeds median by this margin")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain PyTorch versions")

    cfg = REGISTRY[args.arch]
    if args.layers:
        if args.layers % len(cfg.block_pattern):
            raise SystemExit(f"--layers {args.layers} is not a multiple of "
                             f"{args.arch}'s period of "
                             f"{len(cfg.block_pattern)} layers")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    elif args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    opt = AdamW(warmup_steps=10, total_steps=max(args.steps, 100))
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    data = SyntheticLM(cfg, shape)
    step_fn = make_train_step(model, opt, remat=True,
                              grad_accum=args.grad_accum)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    cuda = args.device.startswith("cuda")

    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    opt_state = opt.init(params)
    start = 0
    if mgr and latest_step(args.ckpt_dir) is not None:
        restored, start = mgr.restore_latest({"params": params,
                                              "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"[train] resumed at step {start}")

    times = []
    for i in range(start, args.steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             data.batch_at(i))
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        # straggler hook: a step over its budget is reported (on a fleet
        # the controller would rebalance microbatches or promote a spare)
        if args.straggler_warn_ms and len(times) > 3:
            med = float(np.median(times[-10:]))
            if dt > med + args.straggler_warn_ms / 1e3:
                print(f"[straggler] step {i} took {dt*1e3:.0f}ms "
                      f"(median {med*1e3:.0f}ms)")
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.4f} "
                  f"{dt*1e3:.0f}ms")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save({"params": params, "opt": opt_state}, i + 1)
    if mgr:
        mgr.save({"params": params, "opt": opt_state}, args.steps)
        mgr.wait()
    print("[train] done")


if __name__ == "__main__":
    main()
