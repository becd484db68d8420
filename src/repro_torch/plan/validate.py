"""Plan validation of the port, the single-device counterpart of the JAX
package's ``plan/validate.py``:

  * ``stage_forward``   -- one stage's group slice over hidden states;
  * ``check_roundtrip`` -- the stage slices chained against the reference
                           ``Model.forward`` (lowering must be lossless);
  * ``measure_plan``    -- time each stage on a microbatch on the model's
                           device and compose the stage times through the
                           pipeline schedule (M microbatches through S
                           stages take sum(t_s) + (M-1)*max(t_s));
  * ``measure_serving_stage_times`` -- the serving-side units of one
                           ``ServingPlan`` (a chunk's stage-step, each
                           replica's decode step), the adaptive re-plan
                           controller's inputs;
  * ``predict_plan``    -- the analytic prediction for the realized plan,
                           on any ``core.hw.Chip`` (``hw=core.hw.H100`` for
                           the port's card);
  * ``auto_spatial_width`` -- the plan's spatial width from per-stage
                           times, measured or analytic;
  * ``measured_design_points`` -- the measured points as
                           ``core.pareto.DesignPoint``s tagged
                           ``source="measured"``.

Times are host wall seconds (``time.perf_counter``) from the first call to
the device's completion of the last, one warmup call outside the clock, as
the JAX package's are up to ``block_until_ready``.  They are not device
times: the re-plan controller's cost model is host-serial, and on a GPU the
host's dispatch sets the tick.  Stages run one after another on the one
device.  ``_embed``, ``_finish`` and ``_stage_slice`` are shared with
``plan.serving`` so the parity contract has one implementation per term,
as in JAX.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.backend import dispatch
from repro_torch.core.assignment import simulate
from repro_torch.core.costmodel import Features, stage_time
from repro_torch.core.graph import Graph
from repro_torch.core.hw import Chip, TPU_V5E
from repro_torch.core.pareto import DesignPoint
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.plan.ir import ExecutionPlan
from repro_torch.plan.lower import realized_assignment


def _stage_slice(stack_params, plan: ExecutionPlan, s: int):
    """Stage ``s``'s entries of the per-group param list (a list slice:
    the tensors are shared, not copied)."""
    st = plan.stages[s]
    return stack_params[st.first_group:st.first_group + st.n_groups]


def stage_forward(model, params, x, plan: ExecutionPlan, s: int):
    """Apply stage ``s``'s group slice to hidden states ``x``."""
    y, _, _ = T.run_stack(_stage_slice(params["stack"], plan, s), x,
                          model.cfg)
    return y


def _embed(model, params, batch):
    """The stack's input: ``batch["embeds"]`` when given, else the
    embedded ``batch["tokens"]``, in the activation dtype."""
    return model._lm_inputs(params, batch)[0]


def _finish(model, params, y):
    """Final norm and LM head: f32 logits."""
    return model._head(params, L.apply_norm(params["final_norm"], y,
                                            model.cfg))


def check_roundtrip(model, params, batch, plan: ExecutionPlan) -> float:
    """Max abs error between the chained stage slices and the reference
    forward -- the lowering-is-lossless invariant."""
    y = _embed(model, params, batch)
    for s in range(plan.n_stages):
        y = stage_forward(model, params, y, plan, s)
    got = _finish(model, params, y)
    ref, _ = model.forward(params, batch)
    return float(torch.max(torch.abs(got.to(torch.float32)
                                     - ref.to(torch.float32))))


def _device_sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, repeat: int):
    """Mean host wall seconds of ``fn()`` over ``repeat`` calls, and its
    last result: one warmup call outside the clock, the device drained
    before the clock starts and after the last call."""
    out = fn()
    _device_sync(device)
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn()
    _device_sync(device)
    return (time.perf_counter() - t0) / repeat, out


def measure_plan(model, params, batch, plan: ExecutionPlan, *,
                 repeat: int = 3, check: bool = True) -> Dict:
    """Execute and time the plan's per-stage work on the model's device.

    Each stage runs over one microbatch of hidden states; the embed rides
    stage 0 and the final norm + head ride the last stage (as in
    ``realized_assignment``, so measured and analytic price the same
    graph).  The stage times compose through the pipeline schedule:

      latency  (first microbatch) = sum(t_s)
      makespan (M_total batches)  = sum(t_s) + (M_total - 1) * max(t_s)

    Returns per-stage seconds, the composed latency and makespan, and
    (``check``) the round-trip error against the reference forward."""
    dev = model.device
    x = _embed(model, params, batch)
    B, seq, _ = x.shape
    M = plan.total_microbatches
    assert B % M == 0, (B, M)
    mb = B // M

    per_stage = []
    cur = x[:mb]
    for s in range(plan.n_stages):
        t, cur = timed(lambda h=cur, s=s: stage_forward(model, params, h,
                                                        plan, s),
                       dev, repeat)
        per_stage.append(t)
    mb_batch = {k: v[:mb] for k, v in batch.items()}
    t_embed, _ = timed(lambda: _embed(model, params, mb_batch), dev, repeat)
    t_head, _ = timed(lambda: _finish(model, params, cur), dev, repeat)
    per_stage[0] += t_embed
    per_stage[-1] += t_head

    t_max = max(per_stage)
    latency = sum(per_stage)
    makespan = latency + (M - 1) * t_max
    res = {
        "per_stage_s": per_stage,
        "latency_s": latency,
        "makespan_s": makespan,
        "n_stages": plan.n_stages,
        "n_microbatches": M,
        "tokens_per_s": B * seq / makespan if makespan > 0 else 0.0,
        "backend": dispatch.kernel_path(dev),
    }
    if check:
        res["max_abs_err"] = check_roundtrip(model, params, batch, plan)
    return res


def measure_serving_stage_times(model, params, splan, max_seq: int, *,
                                runtime=None, repeat: int = 3) -> Dict:
    """Measured wall seconds of one ServingPlan's serving-side units, the
    inputs to the adaptive re-plan controller's cost model
    (``serving.adaptive``):

      * ``stage_s[s]`` -- one chunk-prefill stage-step of stage ``s``
        (batch 1, ``splan.chunk`` tokens, the chunk-0 pass), the per-tick
        cost the ``PrefillPipeline`` adds while a prompt streams;
      * ``decode_step_s[r]`` -- one batched decode step of replica ``r``
        (its stage walk and the argmax, batch = its slot-partition width).

    Pass the engine's ``PlanRuntime`` as ``runtime`` to reuse it.  The
    probes run on throwaway dense caches (a batch-1 cache for the stages,
    one per distinct replica width for decode), never on live engine
    state."""
    from repro_torch.plan.serving import PlanRuntime, prefill_stage
    rt = runtime if runtime is not None else PlanRuntime(model, splan,
                                                         max_seq)
    dev = model.device
    chunk = min(splan.chunk, max_seq)
    tokens = torch.zeros((1, chunk), dtype=torch.int64, device=dev)
    hidden = _embed(model, params, {"tokens": tokens})
    part = model.init_cache(1, max_seq)
    stage_s = []
    for s in range(splan.n_stages):
        t, hidden = timed(
            lambda h=hidden, s=s: prefill_stage(model, splan.plan, params,
                                                s, False, h, 0, part),
            dev, repeat)
        stage_s.append(t)

    decode_step_s = []
    per_width: Dict[int, float] = {}
    for n in splan.replica_slots:
        if n not in per_width:
            cache = model.init_cache(n, max_seq)
            toks = torch.zeros((n, 1), dtype=torch.int64, device=dev)
            pos = torch.zeros((n,), dtype=torch.int64, device=dev)
            per_width[n], _ = timed(
                lambda c=cache, tk=toks, p=pos: torch.argmax(
                    rt.walk(params, c, tk, p)[:, -1], dim=-1),
                dev, repeat)
        decode_step_s.append(per_width[n])
    return {
        "stage_s": stage_s,
        "decode_step_s": decode_step_s,
        "chunk": splan.chunk,
        "n_stages": splan.n_stages,
        "n_replicas": splan.n_replicas,
        "backend": dispatch.kernel_path(dev),
    }


def predict_plan(plan: ExecutionPlan, graph: Graph, *, hw: Chip = TPU_V5E,
                 feats: Features = Features()) -> Dict:
    """Analytic prediction for the realized plan: the scheduler prices the
    uniform-width stages (replicate-padding charged) over M_total
    pipelined microbatches on ``hw``."""
    assign = realized_assignment(plan, graph)
    M = plan.total_microbatches
    r = simulate(graph, assign, M, hw=hw, feats=feats)
    per_stage = [
        stage_time([graph.nodes[i] for i in assign.nodes_of(s.index)],
                   assign.accs[s.index], graph, hw,
                   batch_frac=1.0 / M, feats=feats)
        for s in plan.stages]
    return {
        "per_stage_s": per_stage,
        "latency_s": r.latency,
        "makespan_s": r.makespan,
        "throughput_tops": r.throughput_tops(),
        "padding_waste": plan.padding_waste,
    }


def auto_spatial_width(build_plan, graph: Graph, *, n_rounds: int = 1,
                       measure_with=None, max_candidates: int = 6,
                       hw: Chip = TPU_V5E,
                       feats: Features = Features()) -> int:
    """Pick the plan's spatial width (``n_microbatches``) from per-stage
    times.

    build_plan: callable M -> ExecutionPlan.  Candidates are the divisors
    of the effective batch (so ``B % (M * n_rounds) == 0`` holds),
    subsampled to ``max_candidates``; each is scored by its
    pipeline-composed makespan: *measured* on the model's device
    (``measure_plan``) when ``measure_with=(model, params, batch)`` is
    given, from ``predict_plan`` otherwise."""
    B = max(graph.shape.global_batch, 1)
    if B % n_rounds:
        raise ValueError(
            f"auto_spatial_width: n_rounds={n_rounds} does not divide the "
            f"global batch {B}, so no spatial width can satisfy the "
            f"executor's B % (M * n_rounds) == 0 contract")
    eff = B // n_rounds
    cands = [d for d in range(1, eff + 1) if eff % d == 0]
    if len(cands) > max_candidates:
        # keep the extremes + an even spread between them
        idx = np.unique(np.linspace(0, len(cands) - 1,
                                    max_candidates).round().astype(int))
        cands = [cands[i] for i in idx]

    best_m, best_t = cands[0], float("inf")
    for M in cands:
        plan = build_plan(M)
        if measure_with is not None:
            model, params, batch = measure_with
            t = measure_plan(model, params, batch, plan,
                             repeat=1, check=False)["makespan_s"]
        else:
            t = predict_plan(plan, graph, hw=hw, feats=feats)["makespan_s"]
        if t < best_t:
            best_m, best_t = M, t
    return best_m


def measured_design_points(model, params, batch, graph: Graph,
                           plans: Sequence[ExecutionPlan], *,
                           repeat: int = 3) -> List[DesignPoint]:
    """One measured ``DesignPoint`` per plan (source="measured"), on the
    axes of the analytic sweep: latency = the composed makespan of the
    batch, throughput = the graph's MM-TFLOP/s over it."""
    pts = []
    for plan in plans:
        m = measure_plan(model, params, batch, plan, repeat=repeat)
        thr = graph.total_mm_flops / m["makespan_s"] / 1e12 \
            if m["makespan_s"] > 0 else 0.0
        pts.append(DesignPoint(
            strategy="hybrid" if plan.n_stages > 1 else "sequential",
            n_acc=plan.n_stages, n_batches=plan.total_microbatches,
            latency=m["makespan_s"], throughput_tops=thr,
            detail=(f"measured on {m['backend']}; "
                    f"err={m.get('max_abs_err', float('nan')):.2e}"),
            source="measured"))
    return pts
