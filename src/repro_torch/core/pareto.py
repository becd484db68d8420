"""Latency-throughput Pareto exploration (paper Fig. 2 / Table 6).

Generates design points for the three strategies:
  * SSR-sequential — one monolithic acc, sweeping batch pipelining depth;
  * SSR-spatial    — one acc per layer(-group);
  * SSR-hybrid     — EA over layer→acc maps for several acc counts;
and computes the Pareto front (min latency, max throughput).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.assignment import (contiguous_assignment,
                                         sequential_assignment, simulate,
                                         spatial_assignment)
from repro_torch.core.costmodel import Features
from repro_torch.core.ea import evolutionary_search, ssr_dse
from repro_torch.core.graph import Graph
from repro_torch.core.hw import Chip, TPU_V5E


@dataclass(frozen=True)
class DesignPoint:
    strategy: str           # sequential | spatial | hybrid | serving-*
    n_acc: int
    n_batches: int
    latency: float
    throughput_tops: float
    detail: str = ""
    # provenance: "analytic" (cost-model simulate), "measured" (a lowered
    # ExecutionPlan executed + timed synthetically — repro.plan.validate),
    # or "served" (a ServingPlan driven by live Poisson request traffic
    # through the continuous-batching engine — benchmarks/serving.py)
    source: str = "analytic"


def strategy_points(graph: Graph, total_chips: int, *, hw: Chip = TPU_V5E,
                    feats: Features = Features(),
                    batches: Sequence[int] = (1, 2, 3, 4, 6, 8),
                    hybrid_accs: Sequence[int] = (2, 3, 4, 6),
                    ea_iters: int = 6, seed: int = 0) -> List[DesignPoint]:
    pts: List[DesignPoint] = []
    n_nodes = len(graph.nodes)

    for nb in batches:
        # sequential: one monolithic acc, nb pipelined (micro)batches
        seq = sequential_assignment(graph, total_chips)
        r = simulate(graph, seq, nb, hw=hw, feats=feats)
        pts.append(DesignPoint("sequential", 1, nb, r.makespan,
                               r.throughput_tops()))
        # spatial: one acc per layer group
        spa = spatial_assignment(graph, total_chips,
                                 max_accs=min(n_nodes, 16))
        r = simulate(graph, spa, nb, hw=hw, feats=feats)
        pts.append(DesignPoint("spatial", spa.n_acc, nb, r.makespan,
                               r.throughput_tops()))
        # hybrid: EA-optimized layer→acc map per acc count
        for na in hybrid_accs:
            if na >= n_nodes:
                continue
            res = evolutionary_search(
                graph, total_chips, n_acc=na, n_batches=nb,
                n_pop=8, n_child=8, n_iter=ea_iters, seed=seed, hw=hw,
                feats=feats)
            pts.append(DesignPoint("hybrid", na, nb, res.latency,
                                   res.throughput))
    return pts


def pareto_front(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """Non-dominated set: no other point has both lower latency and higher
    throughput."""
    out = []
    for p in points:
        dominated = any(
            (q.latency <= p.latency and q.throughput_tops > p.throughput_tops)
            or (q.latency < p.latency and
                q.throughput_tops >= p.throughput_tops)
            for q in points)
        if not dominated:
            out.append(p)
    return sorted(out, key=lambda p: p.latency)


def best_under_latency(points: Sequence[DesignPoint], lat_cons: float,
                       strategy: Optional[str] = None
                       ) -> Optional[DesignPoint]:
    """Table-6 query: max throughput subject to latency <= lat_cons."""
    cand = [p for p in points if p.latency <= lat_cons and
            (strategy is None or p.strategy == strategy or
             (strategy == "hybrid"))]  # hybrid includes seq+spatial designs
    if strategy == "hybrid":
        cand = [p for p in points if p.latency <= lat_cons]
    if not cand:
        return None
    return max(cand, key=lambda p: p.throughput_tops)
