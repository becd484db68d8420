"""Lowering pass: DSE ``Assignment`` -> runnable ``ExecutionPlan``.

The searched node→acc maps live on the *layer graph* (one node per block,
plus embed/head); the runnable stack executes *groups* (one repetition of
``cfg.block_pattern`` per scan step).  Lowering bridges the two:

  1. snap the node map to group boundaries (FLOPs-weighted majority vote
     per group — EA mutation can scatter single layers, and a stage cut
     inside a pattern period is not executable);
  2. merge consecutive same-acc groups into ordered pipeline stages
     (uneven slices allowed — the executor pads and masks);
  3. realize each acc's requested (chips, dp, tp) on the uniform mesh slot
     width ``devices // n_stages`` (a rectangular mesh cannot give stages
     different widths), recording the replicate-padding waste of stages
     that asked for less than the slot so the cost model can charge it.

Embed and head nodes ride with the first / last stage (the executor runs
them data-parallel outside the stage loop, exactly as the legacy pipeline
did).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.assignment import Assignment
from repro_torch.core.costmodel import AccConfig
from repro_torch.core.graph import Graph
from repro_torch.plan.ir import (ExecutionPlan, ServingPlan, StagePlan,
                                 fit_dp_tp)


def _block_layers(graph: Graph) -> List[int]:
    """Indices of block nodes in layer order; validates the graph is the
    runnable block-granularity LM form (op-granularity and encoder-decoder
    graphs have no 1:1 node↔layer correspondence to the scanned stack)."""
    blocks = [n.idx for n in graph.nodes if n.kind == "block"]
    cfg = graph.cfg
    if len(blocks) != cfg.num_layers or cfg.family == "audio":
        raise ValueError(
            f"plan lowering needs a block-granularity LM graph "
            f"({len(blocks)} block nodes vs {cfg.num_layers} layers, "
            f"family={cfg.family!r}); build_graph(cfg, shape, "
            f"granularity='block')")
    return blocks


def group_acc_map(assign: Assignment, graph: Graph) -> List[int]:
    """Per-group acc id: FLOPs-weighted majority over the group's layers
    (first-seen acc wins ties, keeping the vote deterministic)."""
    cfg = graph.cfg
    period = len(cfg.block_pattern)
    votes: List[Dict[int, float]] = [dict() for _ in range(cfg.num_groups)]
    order: List[Dict[int, int]] = [dict() for _ in range(cfg.num_groups)]
    for li, node_idx in enumerate(_block_layers(graph)):
        g = li // period
        a = assign.acc_of[node_idx]
        node = graph.nodes[node_idx]
        votes[g][a] = votes[g].get(a, 0.0) + max(node.mm_flops, 1.0)
        order[g].setdefault(a, len(order[g]))
    return [max(v, key=lambda a: (v[a], -order[g][a]))
            for g, v in enumerate(votes)]


def _default_microbatches(graph: Graph, n_stages: int, n_rounds: int) -> int:
    """Just fill the pipeline — but the executor splits the batch into
    M * n_rounds microbatches, so M must satisfy B % (M * n_rounds) == 0:
    smallest such divisor >= n_stages (falling back to the largest one
    below it; 1 always qualifies when n_rounds divides B — else no M can
    make the plan executable and we keep M minimal for analytic use)."""
    B = max(graph.shape.global_batch, 1)
    eff = B // n_rounds if B % n_rounds == 0 else B
    divs = [d for d in range(1, eff + 1) if eff % d == 0]
    ge = [d for d in divs if d >= n_stages]
    return min(ge) if ge else max(d for d in divs if d <= n_stages)


def lower(assign: Assignment, graph: Graph,
          mesh_devices: Optional[int] = None, *,
          n_microbatches=None, n_rounds: int = 1,
          measure_with=None) -> ExecutionPlan:
    """Lower a searched ``Assignment`` to a runnable ``ExecutionPlan``.

    mesh_devices: device budget the plan will run on (defaults to the sum
    of requested acc chips — i.e. the DSE's own target platform).  The
    uniform mesh slot width is ``mesh_devices // n_stages``; per-stage
    (dp, tp) are re-fit onto that width, capped by the per-microbatch
    batch.  n_microbatches defaults to n_stages (just fills the pipeline);
    pass the string ``"auto"`` to pick the spatial width from per-stage
    times instead (``plan.validate.auto_spatial_width``: *measured* stage
    times when ``measure_with=(model, params, batch)`` is given, the
    analytic cost model otherwise).
    """
    cfg = graph.cfg
    acc_of_group = group_acc_map(assign, graph)

    # merge consecutive same-acc groups into stages (uneven allowed)
    runs: List[Tuple[int, int, int]] = []     # (acc_id, first_group, count)
    for g, a in enumerate(acc_of_group):
        if runs and runs[-1][0] == a:
            acc_id, first, cnt = runs[-1]
            runs[-1] = (acc_id, first, cnt + 1)
        else:
            runs.append((a, g, 1))
    n_stages = len(runs)
    total_req = sum(a.chips for a in assign.accs) or 1
    devices = mesh_devices or total_req
    width = max(devices // n_stages, 1)

    def build(M: int) -> ExecutionPlan:
        # dp cannot exceed the per-microbatch batch the executor carries
        mb = max(graph.shape.global_batch // max(M * n_rounds, 1), 1)
        stages = []
        for i, (acc_id, first, cnt) in enumerate(runs):
            acc: AccConfig = assign.accs[acc_id]
            dp, tp = fit_dp_tp(width, acc.dp, acc.tp, max_dp=mb)
            # work-proportional ideal share of the device budget vs the
            # uniform slot: the replicate-padding the mesh forces on us
            ideal = devices * acc.chips / total_req
            waste = max(0.0, (width - ideal) / width)
            stages.append(StagePlan(
                index=i, acc_id=acc_id, first_group=first, n_groups=cnt,
                dp=dp, tp=tp, width=width, requested_chips=acc.chips,
                replica_waste=waste))
        return ExecutionPlan(stages=tuple(stages),
                             num_groups=cfg.num_groups,
                             n_microbatches=M, n_rounds=n_rounds)

    if n_microbatches == "auto":
        from repro_torch.plan.validate import auto_spatial_width
        M = auto_spatial_width(build, graph, n_rounds=n_rounds,
                               measure_with=measure_with)
    else:
        M = n_microbatches
        if M is None:
            M = _default_microbatches(graph, n_stages, n_rounds)
    return build(M)


def lower_serving(plan: ExecutionPlan, slots: int,
                  chunk: int = 16) -> ServingPlan:
    """Lower an ``ExecutionPlan`` for the continuous-batching engine.

    The plan's spatial width (``n_microbatches``) becomes the number of
    independent decode replicas; the engine's ``slots`` are partitioned
    over them as evenly as possible.  ``chunk`` is the prefill chunk
    length: admitted prompts stream through the plan's stages in
    ``chunk``-token microbatches, one stage-step per engine tick.
    """
    R = plan.n_microbatches
    if slots < R:
        raise ValueError(
            f"lower_serving: {slots} slots cannot feed {R} decode replicas "
            f"(the plan's spatial width n_microbatches={R}); give the "
            f"engine at least one slot per replica or lower a narrower "
            f"plan")
    if chunk < 1:
        raise ValueError(f"lower_serving: chunk={chunk} must be >= 1")
    base, rem = divmod(slots, R)
    replica_slots = tuple(base + (1 if r < rem else 0) for r in range(R))
    return ServingPlan(plan=plan, slots=slots, chunk=chunk,
                       replica_slots=replica_slots)


def rereplicate_serving(splan: ServingPlan, n_replicas: int, *,
                        chunk: Optional[int] = None) -> ServingPlan:
    """A new design point on the same stage slices with a different
    spatial decode width: re-lower ``splan`` with ``n_replicas`` replicas
    (the underlying ``ExecutionPlan``'s ``n_microbatches``), keeping the
    engine's slot count.  This is how the adaptive controller's candidate
    ladder is built from one searched plan — the stage cut is the searched
    artifact; the spatial width is the traffic-dependent knob."""
    import dataclasses
    if n_replicas < 1:
        raise ValueError(
            f"rereplicate_serving: n_replicas={n_replicas} must be >= 1")
    plan = dataclasses.replace(splan.plan, n_microbatches=n_replicas)
    return lower_serving(plan, splan.slots,
                         chunk=splan.chunk if chunk is None else chunk)


def realized_assignment(plan: ExecutionPlan, graph: Graph) -> Assignment:
    """Map a plan back onto the graph as an ``Assignment`` with the
    *realized* per-stage submeshes (uniform slot width, re-fit dp/tp) —
    this is what the analytic scheduler should price so predictions charge
    the replicate-padding the mesh forced (vs the DSE's requested split)."""
    cfg = graph.cfg
    period = len(cfg.block_pattern)
    blocks = _block_layers(graph)
    stage_of_node = {}
    for li, node_idx in enumerate(blocks):
        stage_of_node[node_idx] = plan.stage_of_group(li // period)
    acc_of = []
    for n in graph.nodes:
        if n.idx in stage_of_node:
            acc_of.append(stage_of_node[n.idx])
        elif n.kind == "embed":
            acc_of.append(0)
        else:                                   # head rides the last stage
            acc_of.append(plan.n_stages - 1)
    accs = tuple(AccConfig(chips=s.width, dp=s.dp, tp=s.tp)
                 for s in plan.stages)
    return Assignment(tuple(acc_of), accs)
