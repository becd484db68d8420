"""Layer→Acc assignment + the greedy pipeline scheduler (paper Fig. 5(c)).

An *assignment* maps every graph node to an accelerator id.  Given the
assignment, per-acc configs, and a number of batches, the scheduler
simulates the pipelined execution honoring graph dependencies and
accelerator occupancy — "assign a layer to the pipeline as soon as its
accelerator is available and its dependencies are resolved" — and returns
(single-batch latency, makespan, throughput).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import (AccConfig, Features, node_time,
                                        transfer_time)
from repro_torch.core.graph import Graph, Node
from repro_torch.core.hw import Chip, TPU_V5E


@dataclass(frozen=True)
class Assignment:
    """node idx -> acc id; acc id -> AccConfig."""
    acc_of: Tuple[int, ...]
    accs: Tuple[AccConfig, ...]

    @property
    def n_acc(self) -> int:
        return len(self.accs)

    def nodes_of(self, acc_id: int) -> List[int]:
        return [i for i, a in enumerate(self.acc_of) if a == acc_id]


@dataclass
class ScheduleResult:
    latency: float          # first-batch end-to-end latency (s)
    makespan: float         # all-batch completion (s)
    throughput_flops: float # model MM FLOP/s sustained over makespan
    per_acc_busy: List[float] = field(default_factory=list)

    def throughput_tops(self) -> float:
        return self.throughput_flops / 1e12


def simulate(graph: Graph, assign: Assignment, n_batches: int = 1, *,
             hw: Chip = TPU_V5E, feats: Features = Features(),
             batch_frac: Optional[float] = None) -> ScheduleResult:
    """Event-driven list scheduling of `n_batches` through the acc pipeline.

    Each batch runs every node in topological order; a node occupies its
    accelerator for node_time(total); inter-acc edges add transfer_time.
    batch_frac: fraction of the graph's global batch each pipelined batch
    carries (default 1/n_batches so the total workload is one global batch —
    matching the paper's "#accs = batch" sweep where the global workload is
    fixed and split into pipelined batches)."""
    nodes = graph.nodes
    frac = batch_frac if batch_frac is not None else 1.0 / n_batches
    n_acc = assign.n_acc

    # per (node) duration on its acc; fixed-config platforms pad every
    # layer to the acc's frozen array config (paper's seq-acc mismatch).
    refs = [None] * n_acc
    if hw.fixed_config:
        from repro_torch.core.costmodel import acc_ref_dims
        for a in range(n_acc):
            refs[a] = acc_ref_dims([nodes[i] for i in assign.nodes_of(a)],
                                   assign.accs[a], frac)
    dur = [node_time(n, assign.accs[assign.acc_of[n.idx]], hw,
                     batch_frac=frac, train=graph.train, feats=feats,
                     ref_dims=refs[assign.acc_of[n.idx]])["total"]
           for n in nodes]
    # inter-acc transfer per edge (u -> v) crossing accs
    def edge_cost(u: int, v: int) -> float:
        au, av = assign.acc_of[u], assign.acc_of[v]
        if au == av:
            return 0.0
        return transfer_time([nodes[u]], assign.accs[au], assign.accs[av],
                             nodes[u].act_out * frac, hw, feats=feats)

    acc_free = [0.0] * n_acc
    busy = [0.0] * n_acc
    finish: Dict[Tuple[int, int], float] = {}   # (batch, node) -> t
    first_batch_end = 0.0
    makespan = 0.0

    # Readiness-driven list scheduling (paper Fig. 5(c)): "assign a layer
    # to the pipeline as soon as its accelerator is available and its
    # dependencies are resolved" — ops from later batches overtake idle
    # accelerators (this is what fills the spatial pipeline).
    n_nodes = len(nodes)
    n_deps = [len(n.deps) for n in nodes]
    children: List[List[int]] = [[] for _ in nodes]
    for n in nodes:
        for d in n.deps:
            children[d].append(n.idx)

    pending = {(b, i): n_deps[i] for b in range(n_batches)
               for i in range(n_nodes)}
    ready: List[Tuple[float, int, int]] = []     # (ready_time, batch, node)
    for b in range(n_batches):
        for i in range(n_nodes):
            if n_deps[i] == 0:
                ready.append((0.0, b, i))

    scheduled = 0
    total = n_batches * n_nodes
    while scheduled < total:
        # pick the op with the earliest feasible start (FIFO tie-break)
        best_j = -1
        best_start = best_key = None
        for j, (rt, b, i) in enumerate(ready):
            a = assign.acc_of[i]
            start = max(rt, acc_free[a])
            key = (start, b, i)
            if best_key is None or key < best_key:
                best_key, best_start, best_j = key, start, j
        rt, b, i = ready.pop(best_j)
        a = assign.acc_of[i]
        end = best_start + dur[i]
        acc_free[a] = end
        busy[a] += dur[i]
        finish[(b, i)] = end
        makespan = max(makespan, end)
        if b == 0:
            first_batch_end = max(first_batch_end, end)
        scheduled += 1
        for ch in children[i]:
            pending[(b, ch)] -= 1
            if pending[(b, ch)] == 0:
                r = max((finish[(b, d)] + edge_cost(d, ch)
                         for d in nodes[ch].deps), default=0.0)
                ready.append((r, b, ch))

    total_flops = graph.total_mm_flops * frac * n_batches
    thr = total_flops / makespan if makespan > 0 else 0.0
    return ScheduleResult(latency=first_batch_end, makespan=makespan,
                          throughput_flops=thr, per_acc_busy=busy)


# ---------------------------------------------------------------------------
# assignment constructors
# ---------------------------------------------------------------------------

def contiguous_assignment(graph: Graph, n_acc: int, total_chips: int,
                          configs: Optional[Sequence[AccConfig]] = None,
                          ) -> Assignment:
    """Split the node list into n_acc contiguous groups balanced by MM FLOPs
    (the natural stage partition for a chain-structured transformer), with
    chips allocated ∝ FLOPs share (paper: "AIE number ∝ #ops")."""
    nodes = graph.nodes
    total = sum(n.mm_flops for n in nodes) or 1.0
    target = total / n_acc
    acc_of = []
    acc = 0
    run = 0.0
    for n in nodes:
        if acc < n_acc - 1 and run >= target * (acc + 1) - 0.5 * n.mm_flops:
            acc += 1
        acc_of.append(acc)
        run += n.mm_flops
    used = max(acc_of) + 1
    if configs is None:
        configs = allocate_chips(graph, acc_of, used, total_chips)
    return Assignment(tuple(acc_of), tuple(configs))


def allocate_chips(graph: Graph, acc_of: Sequence[int], n_acc: int,
                   total_chips: int) -> List[AccConfig]:
    """Chips per acc ∝ FLOPs share, floored to ≥1, sum == total_chips;
    default factorization: as data-parallel as the batch allows, rest TP."""
    flops = [0.0] * n_acc
    for n in graph.nodes:
        flops[acc_of[n.idx]] += n.mm_flops
    total = sum(flops) or 1.0
    raw = [max(1, int(round(f / total * total_chips))) for f in flops]
    # fix rounding to hit the exact chip budget
    while sum(raw) > total_chips:
        raw[raw.index(max(raw))] -= 1
    while sum(raw) < total_chips:
        raw[raw.index(max(raw))] += 1
    out = []
    B = graph.shape.global_batch
    for c in raw:
        dp = _largest_divisor_leq(c, max(1, min(B, c)))
        out.append(AccConfig(chips=c, dp=dp, tp=c // dp))
    return out


def _largest_divisor_leq(c: int, cap: int) -> int:
    for d in range(min(cap, c), 0, -1):
        if c % d == 0:
            return d
    return 1


def sequential_assignment(graph: Graph, total_chips: int,
                          dp: Optional[int] = None) -> Assignment:
    """The paper's 'sequential acc': one monolithic accelerator."""
    c = total_chips
    B = graph.shape.global_batch
    if dp is None:
        dp = _largest_divisor_leq(c, max(1, min(B, c)))
    acc = AccConfig(chips=c, dp=dp, tp=c // dp)
    return Assignment(tuple(0 for _ in graph.nodes), (acc,))


def spatial_assignment(graph: Graph, total_chips: int,
                       max_accs: Optional[int] = None) -> Assignment:
    """The paper's 'fully spatial': one acc per layer (capped by chips).
    On op-granularity graphs this becomes one acc per op ROLE, reused
    across layers — exactly the paper's Fig. 9 DeiT-T spatial design
    (specialized QKV / attention / MLP accelerators)."""
    roles = sorted({n.role for n in graph.nodes if n.role})
    if roles and len(roles) > 2:
        return role_assignment(graph, total_chips, max_accs=max_accs)
    n = len(graph.nodes)
    n_acc = min(n, max_accs or n, total_chips)
    return contiguous_assignment(graph, n_acc, total_chips)


def role_assignment(graph: Graph, total_chips: int,
                    max_accs: Optional[int] = None) -> Assignment:
    """acc per op role (merging smallest-FLOPs roles when chips are few)."""
    role_flops: Dict[str, float] = {}
    for n in graph.nodes:
        role_flops[n.role] = role_flops.get(n.role, 0.0) + n.mm_flops
    cap = min(max_accs or total_chips, total_chips, len(role_flops))
    ranked = sorted(role_flops, key=lambda r: -role_flops[r])
    role_to_acc = {}
    for i, r in enumerate(ranked):
        role_to_acc[r] = min(i, cap - 1)    # tail roles share the last acc
    acc_of = tuple(role_to_acc[n.role] for n in graph.nodes)
    n_acc = max(acc_of) + 1
    configs = allocate_chips(graph, acc_of, n_acc, total_chips)
    return Assignment(acc_of, tuple(configs))
