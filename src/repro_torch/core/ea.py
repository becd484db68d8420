"""SSR evolutionary Layer→Acc search — faithful port of the paper's
Algorithm 1 (population, single-point crossover, mutation, elitist update),
with the SSR_DSE inner pass = greedy schedule + chip allocation +
Algorithm-2 customization.

Also provides the exhaustive-search baseline used for the Fig.-10
search-efficiency comparison.
"""
from __future__ import annotations

import itertools
import math
import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.assignment import (Assignment, ScheduleResult,
                                         allocate_chips, simulate)
from repro_torch.core.costmodel import Features
from repro_torch.core.customize import customize_accs
from repro_torch.core.graph import Graph
from repro_torch.core.hw import Chip, TPU_V5E


@dataclass
class DSEResult:
    assignment: Assignment
    latency: float
    throughput: float           # TOPS-equivalent (1e12 MM FLOP/s)
    evaluations: int = 0
    wall_time_s: float = 0.0
    history: List[Tuple[int, float]] = field(default_factory=list)


def ssr_dse(graph: Graph, acc_of: Sequence[int], total_chips: int,
            n_batches: int, *, hw: Chip = TPU_V5E,
            feats: Features = Features()) -> Tuple[float, float, Assignment]:
    """One SSR_DSE pass (Algorithm 1 lines 27-37): greedy schedule +
    resource pre-allocation + Algorithm-2 customization + evaluation.
    Returns (latency, throughput_tops, assignment)."""
    n_acc = max(acc_of) + 1
    chip_alloc = [a.chips for a in
                  allocate_chips(graph, acc_of, n_acc, total_chips)]
    frac = 1.0 / n_batches
    accs = customize_accs(graph, acc_of, chip_alloc, hw=hw, feats=feats,
                          batch_frac=frac)
    assign = Assignment(tuple(acc_of), tuple(accs))
    res = simulate(graph, assign, n_batches, hw=hw, feats=feats)
    # "latency" here = the paper's metric: completion time of the whole
    # submitted batch workload (Table 5/6/7 report batch latency).
    return res.makespan, res.throughput_tops(), assign


def _random_assignment(rng: random.Random, n_nodes: int, n_acc: int
                       ) -> Tuple[int, ...]:
    """Random *contiguous-ish* partition: sorted cut points — keeps the
    population in the feasible region (chain deps make scattered
    assignments strictly worse; the paper's EA also seeds structured maps)."""
    if n_acc == 1:
        return tuple([0] * n_nodes)
    cuts = sorted(rng.sample(range(1, n_nodes), min(n_acc - 1, n_nodes - 1)))
    out, acc = [], 0
    for i in range(n_nodes):
        while acc < len(cuts) and i >= cuts[acc]:
            acc += 1
        out.append(acc)
    return tuple(out)


def _sp_crossover(rng: random.Random, p1, p2):
    pt = rng.randrange(1, len(p1))
    c1 = _renumber(p1[:pt] + p2[pt:])
    c2 = _renumber(p2[:pt] + p1[pt:])
    return c1, c2


def _mutate(rng: random.Random, g, n_acc: int):
    g = list(g)
    i = rng.randrange(len(g))
    j = rng.randrange(len(g))
    g[i], g[j] = g[j], g[i]
    return _renumber(tuple(g))


def _renumber(g: Tuple[int, ...]) -> Tuple[int, ...]:
    """Canonicalize acc ids to 0..k-1 in first-appearance order."""
    seen = {}
    out = []
    for a in g:
        if a not in seen:
            seen[a] = len(seen)
        out.append(seen[a])
    return tuple(out)


def evolutionary_search(graph: Graph, total_chips: int, *,
                        lat_cons: float = math.inf, n_acc: int = 4,
                        n_batches: int = 4, n_pop: int = 16,
                        n_child: int = 16, n_iter: int = 12,
                        seed: int = 0, hw: Chip = TPU_V5E,
                        feats: Features = Features()) -> DSEResult:
    """Algorithm 1.  Maximizes throughput s.t. latency <= lat_cons."""
    rng = random.Random(seed)
    n_nodes = len(graph.nodes)
    t0 = time.perf_counter()
    evals = 0
    history: List[Tuple[int, float]] = []

    def fitness(g):
        nonlocal evals
        evals += 1
        lat, thr, assign = ssr_dse(graph, g, total_chips, n_batches,
                                   hw=hw, feats=feats)
        ok = lat <= lat_cons
        return (thr if ok else -1.0 / max(thr, 1e-9)), lat, thr, assign

    # seed with the pure-sequential and fully-spatial genomes — the paper's
    # hybrid space explicitly includes both endpoints (Table 6 note).
    pop = [tuple([0] * n_nodes),
           _random_assignment(rng, n_nodes, n_acc)]
    pop += [_random_assignment(rng, n_nodes, rng.randint(1, n_acc))
            for _ in range(max(n_pop - 2, 0))]
    scored = [(fitness(g), g) for g in pop]
    best = None
    for (fit, lat, thr, assign), g in scored:
        if best is None or fit > best[0]:
            best = (fit, lat, thr, assign)
        history.append((evals, best[2] if best[1] <= lat_cons else 0.0))

    for _ in range(n_iter):
        # selection: fitness-proportional over top half
        ranked = sorted(scored, key=lambda x: -x[0][0])
        parents = [g for _, g in ranked[:max(2, n_pop // 2)]]
        children = []
        for _ in range(n_child // 2):
            p1, p2 = rng.sample(parents, 2)
            c1, c2 = _sp_crossover(rng, p1, p2)
            children += [c1, c2]
        children = [_mutate(rng, c, n_acc) if rng.random() < 0.4 else c
                    for c in children]
        child_scored = [(fitness(c), c) for c in children]
        for (fit, lat, thr, assign), g in child_scored:
            if lat <= lat_cons and (best is None or thr > best[2]
                                    or best[1] > lat_cons):
                best = (fit, lat, thr, assign)
            history.append((evals, best[2] if best[1] <= lat_cons else 0.0))
        # elitist population update
        scored = sorted(scored + child_scored, key=lambda x: -x[0][0])[:n_pop]

    fit, lat, thr, assign = best
    return DSEResult(assignment=assign, latency=lat, throughput=thr,
                     evaluations=evals,
                     wall_time_s=time.perf_counter() - t0, history=history)


def exhaustive_search(graph: Graph, total_chips: int, *,
                      lat_cons: float = math.inf, n_acc: int = 4,
                      n_batches: int = 4, max_evals: int = 20000,
                      hw: Chip = TPU_V5E, feats: Features = Features()
                      ) -> DSEResult:
    """Baseline: enumerate contiguous partitions into ≤ n_acc stages
    (the paper's exhaustive baseline post-verifies comm overhead; ours
    evaluates the same space without the inter-acc-aware pruning)."""
    n_nodes = len(graph.nodes)
    t0 = time.perf_counter()
    evals = 0
    best: Optional[Tuple[float, float, Assignment]] = None
    history: List[Tuple[int, float]] = []
    no_prune = Features(onchip_forwarding=feats.onchip_forwarding,
                        fine_grained_pipeline=feats.fine_grained_pipeline,
                        inter_acc_aware=False)

    for k in range(1, n_acc + 1):
        for cuts in itertools.combinations(range(1, n_nodes), k - 1):
            if evals >= max_evals:
                break
            g, acc = [], 0
            cl = list(cuts)
            for i in range(n_nodes):
                while acc < len(cl) and i >= cl[acc]:
                    acc += 1
                g.append(acc)
            lat, thr, assign = ssr_dse(graph, tuple(g), total_chips,
                                       n_batches, hw=hw, feats=no_prune)
            evals += 1
            if lat <= lat_cons and (best is None or thr > best[1]):
                best = (lat, thr, assign)
            history.append((evals, best[1] if best else 0.0))
    if best is None:
        lat, thr, assign = ssr_dse(graph, tuple([0] * n_nodes), total_chips,
                                   n_batches, hw=hw, feats=no_prune)
        best = (lat, thr, assign)
    lat, thr, assign = best
    return DSEResult(assignment=assign, latency=lat, throughput=thr,
                     evaluations=evals,
                     wall_time_s=time.perf_counter() - t0, history=history)
