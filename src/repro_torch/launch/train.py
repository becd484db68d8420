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
checkpoint there (``[train] resumed at step N``).

Sharded (``--mesh DATA,MODEL``): one process a mesh rank, the step of
``training.sharded_train_step`` on params placed by JAX's rules
(``--fsdp``, ``--expert-parallel``) and AdamW moments by ``zero1_specs``
(``--zero1``), each rank drawing its rows of the global batch.  Rank and
world come from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``), or from ``--rank``/``--world-size``
with ``--init-method file://PATH`` (or ``tcp://localhost:PORT``):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2,2 \
        --device cpu --steps 3 --seq 32 --batch 8

Every arch of the registry takes ``model`` > 1: attention (self and
cross), the dense and MoE FFNs, mamba, mLSTM and sLSTM blocks, the ViT
class head and qwen2-vl's ``embeds`` path run tensor parallel on each
rank's shards (``--arch xlstm-125m --mesh 1,2`` prints the one-process
run's losses to their last digits).

Rank r runs on card r over NCCL; with more ranks than cards the ranks
share them, over gloo (NCCL refuses two ranks on one card); with
``--device cpu``, on the CPU over gloo.  Only rank 0 prints.  A
checkpoint is written whole by rank 0 (the format either package
restores), and resuming on a different mesh re-shards it: ``[train]
resumed at step N (elastic reshard onto (d, m))``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import REGISTRY, ShapeConfig, reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.training import AdamW, AdamWState, make_train_step


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
    ap.add_argument("--mesh", default="",
                    help="DATA,MODEL: one process a rank, sharded")
    ap.add_argument("--fsdp", action="store_true",
                    help="also shard the weights over data")
    ap.add_argument("--zero1", action="store_true",
                    help="shard AdamW's moments over data (ZeRO-1)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="MoE experts over model")
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--rank", type=int,
                    default=int(os.environ.get("RANK", 0)))
    ap.add_argument("--world-size", type=int,
                    default=int(os.environ.get("WORLD_SIZE", 1)))
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
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    opt = AdamW(warmup_steps=10, total_steps=max(args.steps, 100))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    cuda = args.device.startswith("cuda")
    say = print
    if args.mesh:
        params, opt_state, step_fn, data, start, say = _sharded(
            args, cfg, shape, opt, mgr)
    else:
        model = build_model(cfg, device=args.device)
        data = SyntheticLM(cfg, shape)
        step_fn = make_train_step(model, opt, remat=True,
                                  grad_accum=args.grad_accum)
        params = model.init(torch.Generator(device=args.device)
                            .manual_seed(0))
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
                say(f"[straggler] step {i} took {dt*1e3:.0f}ms "
                    f"(median {med*1e3:.0f}ms)")
        if i % 5 == 0 or i == args.steps - 1:
            say(f"step {i}: loss={float(metrics['loss']):.4f} "
                f"{dt*1e3:.0f}ms")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save({"params": params, "opt": opt_state}, i + 1)
    if mgr:
        mgr.save({"params": params, "opt": opt_state}, args.steps)
        mgr.wait()
    say("[train] done")
    if args.mesh:
        import torch.distributed as dist
        dist.destroy_process_group()


def _sharded(args, cfg, shape, opt, mgr):
    """The sharded run's params, state, step, data, first step and
    printer (rank 0's ``print``)."""
    from repro_torch import sharding as S
    from repro_torch.launch.mesh import Mesh, device_mesh, init_distributed
    from repro_torch.training import (init_sharded, sharded_train_step,
                                      zero1_specs)
    d, m = (int(x) for x in args.mesh.split(","))
    if args.device.startswith("cuda"):
        # rank r on card r; more ranks than cards share them (over gloo)
        devs = [torch.device("cuda", r % torch.cuda.device_count())
                for r in range(d * m)]
    else:
        devs = [torch.device("cpu")] * (d * m)
    mesh = Mesh(np.asarray(devs, dtype=object).reshape(d, m),
                ("data", "model"))
    dev = init_distributed(mesh, args.rank, args.world_size,
                           init_method=args.init_method)
    dmesh = device_mesh(mesh)
    view = S.axes_view(dmesh)
    model = build_model(cfg, device=str(dev))
    full = model.init(torch.Generator(device=dev).manual_seed(0))
    pspecs = S.param_specs(full, view, expert_parallel=args.expert_parallel,
                           fsdp=args.fsdp)
    ospecs = zero1_specs(pspecs, full, view) if args.zero1 else pspecs
    data = SyntheticLM(cfg, shape, mesh=dmesh, grad_accum=args.grad_accum)
    bspecs = S.input_specs_tree(data.global_batch_at(0), view)
    params = S.shard_tree(full, pspecs, dmesh)
    del full
    opt_state = init_sharded(opt, params, ospecs, dmesh)
    step_fn = sharded_train_step(
        make_train_step(model, opt, remat=True, grad_accum=args.grad_accum),
        dmesh, pspecs, ospecs, bspecs)
    say = print if args.rank == 0 else (lambda *a, **k: None)
    start = 0
    if mgr and latest_step(args.ckpt_dir) is not None:
        restored, start = mgr.restore_latest(
            {"params": params, "opt": opt_state},
            shardings={"params": (pspecs, dmesh),
                       "opt": AdamWState(step=None, m=(ospecs, dmesh),
                                         v=(ospecs, dmesh))})
        params, opt_state = restored["params"], restored["opt"]
        say(f"[train] resumed at step {start} (elastic reshard onto "
            f"({d}, {m}))")
    return params, opt_state, step_fn, data, start, say


if __name__ == "__main__":
    main()
