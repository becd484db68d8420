"""Plan validation of the port, the single-device subset of the JAX
package's ``plan/validate.py``:

  * ``stage_forward``   -- one stage's group slice over hidden states;
  * ``check_roundtrip`` -- the stage slices chained against the reference
                           ``Model.forward`` (lowering must be lossless);
  * ``predict_plan``    -- the analytic prediction for the realized plan,
                           on any ``core.hw.Chip`` (``hw=core.hw.H100`` for
                           the port's card);
  * ``auto_spatial_width`` -- the plan's spatial width from the analytic
                           per-stage times.

The measured side (``measure_plan``, ``measure_serving_stage_times``,
``measured_design_points``) is not ported yet: ``auto_spatial_width``'s
``measure_with=`` raises NotImplementedError.  ``_embed``, ``_finish``
and ``_stage_slice`` are shared with ``plan.serving`` so the parity
contract has one implementation per term, as in JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.assignment import simulate
from repro_torch.core.costmodel import Features, stage_time
from repro_torch.core.graph import Graph
from repro_torch.core.hw import Chip, TPU_V5E
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
    y, _ = T.run_stack(_stage_slice(params["stack"], plan, s), x,
                       model.cfg)
    return y


def _embed(model, params, batch):
    return model._embed(params, batch["tokens"])


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
    """Pick the plan's spatial width (``n_microbatches``) from the
    analytic per-stage times.

    build_plan: callable M -> ExecutionPlan.  Candidates are the divisors
    of the effective batch (so ``B % (M * n_rounds) == 0`` holds),
    subsampled to ``max_candidates``; each is scored by its
    pipeline-composed makespan from ``predict_plan``.  ``measure_with``
    (measured per-stage times) needs ``measure_plan``, not ported yet."""
    if measure_with is not None:
        raise NotImplementedError(
            "auto_spatial_width(measure_with=...) times the stages with "
            "plan.validate.measure_plan, which the port does not have "
            "yet; use the analytic branch (measure_with=None)")
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
        t = predict_plan(build_plan(M), graph, hw=hw,
                         feats=feats)["makespan_s"]
        if t < best_t:
            best_m, best_t = M, t
    return best_m
