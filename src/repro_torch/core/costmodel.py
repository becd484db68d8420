"""Analytical TPU cost model — the SSR Eq. 1 / Eq. 2 analogue.

The paper models each accelerator's cycle count from its AIE-array
parallelism (A,B,C) and workload (h1,w1,w2); feasibility comes from AIE,
PLIO, RAM, DSP budgets (Eq. 1); performance from Cycle = MNK/(ABC·MAC/Eff)
(Eq. 2).  On a TPU pod the per-accelerator resources are a *submesh*:

  config_vector := (chips c, data-par dp, tensor-par tp)   with dp·tp = c

and the per-layer time is a three-term roofline:

  t_compute  = local MM FLOPs / (peak · Eff(local matmul dims))
  t_hbm      = local bytes / HBM bw
  t_vpu      = local nonlinear FLOPs / VPU rate
  t_ici      = TP-collective bytes / ICI link bw

`Eff` is the MXU tile-padding efficiency — the exact TPU counterpart of the
paper's shape-mismatch observation.  The fine-grained-pipeline feature
(paper §4.3-②) decides whether t_vpu overlaps t_compute (max) or serializes
(sum); on-chip forwarding (§4.3-③/Fig 8) decides whether inter-acc transfers
ride the ICI or round-trip through host DRAM.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.graph import Graph, MatmulShape, Node
from repro_torch.core.hw import Chip, TPU_V5E, mxu_efficiency

HOST_BW = 16e9          # device<->host PCIe-class bytes/s (forwarding OFF)
COLL_EFF = 0.8          # achievable fraction of ICI peak for collectives


@dataclass(frozen=True)
class AccConfig:
    """One SSR accelerator = a submesh with a parallelism factorization."""
    chips: int
    dp: int
    tp: int

    def __post_init__(self):
        assert self.dp * self.tp == self.chips, (self.dp, self.tp, self.chips)


@dataclass(frozen=True)
class Features:
    """SSR optimization features (paper §5.2.6 step-by-step ablation)."""
    onchip_forwarding: bool = True     # (1) inter-acc via ICI not host
    fine_grained_pipeline: bool = True # (3) nonlinear overlapped with MM
    inter_acc_aware: bool = True       # force-partition co-design


def _shape_local(s: MatmulShape, dp: int, tp: int) -> Tuple[float, float, float, float]:
    """Local (m,k,n,count) after sharding a matmul over (dp, tp)."""
    m, k, n, cnt = s.m, s.k, s.n, s.count
    m = max(m / dp, 1.0)
    if s.tp_dim == "n":
        n = max(n / tp, 1.0)
    elif s.tp_dim == "k":
        k = max(k / tp, 1.0)
    elif s.tp_dim == "count":
        cnt = max(cnt / tp, 1.0)
    return m, k, n, cnt


def acc_ref_dims(nodes: List[Node], acc: AccConfig,
                 batch_frac: float = 1.0):
    """Per-acc frozen array configs (fixed_config platforms): per HMM type
    (type0 = MM, type1 = BMM, paper §4.3), the local (m, k, n) of the
    FLOPs-dominant matmul — the bitstream is sized for the dominant
    workload and every other layer runs padded to it (the paper's
    sequential-acc shape mismatch, §1: 10.9% utilization)."""
    best = {}          # HMM type -> (dims, flops)
    for node in nodes:
        for s in node.mm:
            lm, lk, ln, _ = _shape_local(s, acc.dp, acc.tp)
            if s.dp_dim == "m":
                lm = max(lm * batch_frac, 1.0)
            t = _hmm_type(s, lk, ln)
            if t not in best or s.flops > best[t][1]:
                best[t] = ((lm, lk, ln), s.flops)
    return {t: v[0] for t, v in best.items()}


def _hmm_type(s: MatmulShape, lk: float, ln: float) -> str:
    """HMM array type: MM (type0) vs the two BMM orientations (QK^T and PV
    have transposed aspect ratios; an HMM-type1 acc instantiates both)."""
    if s.count <= 1:
        return "mm"
    return "bmm_qk" if ln >= lk else "bmm_pv"


def node_time(node: Node, acc: AccConfig, hw: Chip = TPU_V5E, *,
              batch_frac: float = 1.0, train: bool = False,
              feats: Features = Features(), ref_dims=None
              ) -> Dict[str, float]:
    """Per-invocation time terms (seconds) for `node` on `acc`, processing
    ``batch_frac`` of the graph's global batch (microbatching).

    ref_dims: on fixed_config platforms every matmul pads to the acc's
    frozen array config instead of its own tile-padded shape."""
    mult = 3.0 if train else 1.0
    vmult = 2.0 if train else 1.0
    dp, tp, c = acc.dp, acc.tp, acc.chips

    t_compute = 0.0
    for s in node.mm:
        lm, lk, ln, lcnt = _shape_local(s, dp, tp)
        # microbatching scales the token dim (m)
        lm = max(lm * batch_frac, 1.0) if s.dp_dim == "m" else lm
        ref = None
        if ref_dims is not None and hw.fixed_config:
            ref = ref_dims.get(_hmm_type(s, lk, ln))
        if ref is not None:
            # paper §4.3: each acc has one HMM-type0 (MM) and one
            # HMM-type1 (BMM) array config — mismatch penalized per type.
            def _pad(d, r):
                return hw.tile * math.ceil(max(d, r) / hw.tile)
            eff = hw.max_eff * (lm / _pad(lm, ref[0])) \
                * (lk / _pad(lk, ref[1])) \
                * (ln / _pad(ln, ref[2]))
        else:
            eff = mxu_efficiency(int(round(lm)), int(round(lk)),
                                 int(round(ln)), tile=hw.tile,
                                 ceiling=hw.max_eff)
        local_flops = mult * s.flops * batch_frac / (dp * tp)
        t_compute += local_flops / (hw.peak_flops * max(eff, 1e-3))

    t_vpu = vmult * node.vpu_flops * batch_frac / c / hw.vpu_flops

    # HBM: weights read once per invocation per chip-shard; activations +
    # state streamed.  (Training re-reads weights in bwd: mult.)
    # weights_resident (paper HMM-type0 pinning): inference weights live in
    # on-chip SRAM -> zero steady-state off-chip weight traffic.
    if hw.weights_resident and not train:
        bytes_w = 0.0
    else:
        bytes_w = node.weight_bytes / c * (2.0 if train else 1.0)
    if hw.weights_resident and feats.onchip_forwarding and not train:
        # fully on-chip dataflow (paper premise: model fits on-chip):
        # activations stream BRAM->BRAM, never touching DDR.
        bytes_a = 0.0
    else:
        bytes_a = 2.0 * (node.act_in + node.act_out) * batch_frac / c
    bytes_s = node.state_bytes * batch_frac / (c if node.state_bytes else 1)
    t_hbm = (bytes_w + bytes_a + bytes_s) / hw.hbm_bw

    # On-chip forwarding OFF (CHARM-like baseline): every layer's
    # activations round-trip through off-chip DRAM, serially.
    t_dram_rt = 0.0
    if not feats.onchip_forwarding:
        t_dram_rt = 2.0 * (node.act_in + node.act_out) * batch_frac \
            / c / hw.hbm_bw

    # ICI: Megatron-style TP ⇒ one all-reduce of the activation after each
    # ROW-parallel (k-sharded) matmul; column-parallel outputs stay sharded.
    t_ici = 0.0
    if tp > 1 and node.kind == "block":
        n_ar = sum(1 for s in node.mm if s.tp_dim == "k")
        ar_bytes = n_ar * 2 * (tp - 1) / tp * node.act_out * batch_frac / dp
        t_ici = ar_bytes / (hw.ici_links_per_axis * hw.ici_bw * COLL_EFF)
        if train:
            t_ici *= 2
    if train and dp > 1 and node.weight_bytes:
        # gradient all-reduce over dp (amortized per microbatch invocation)
        gr = 2 * (dp - 1) / dp * node.weight_bytes / tp * batch_frac
        t_ici += gr / (hw.ici_links_per_axis * hw.ici_bw * COLL_EFF)

    if feats.fine_grained_pipeline:
        # nonlinear (VPU) and HBM streaming overlap the MXU pipeline
        total = max(t_compute, t_vpu, t_hbm) + t_ici + t_dram_rt
    else:
        total = t_compute + t_vpu + t_hbm + t_ici + t_dram_rt
    return {"compute": t_compute, "vpu": t_vpu, "hbm": t_hbm, "ici": t_ici,
            "dram_rt": t_dram_rt, "total": total}


def stage_time(nodes: List[Node], acc: AccConfig, graph: Graph,
               hw: Chip = TPU_V5E, *, batch_frac: float = 1.0,
               feats: Features = Features()) -> float:
    ref = acc_ref_dims(nodes, acc, batch_frac) if hw.fixed_config else None
    return sum(node_time(n, acc, hw, batch_frac=batch_frac,
                         train=graph.train, feats=feats,
                         ref_dims=ref)["total"]
               for n in nodes)


def stage_weight_bytes(nodes: List[Node]) -> float:
    return sum(n.weight_bytes + n.state_bytes for n in nodes)


def fits_hbm(nodes: List[Node], acc: AccConfig, graph: Graph,
             hw: Chip = TPU_V5E, *, batch_frac: float = 1.0) -> bool:
    w = sum(n.weight_bytes for n in nodes) / acc.chips
    st = sum(n.state_bytes for n in nodes) * batch_frac / acc.chips
    act = max((n.act_out for n in nodes), default=0.0) * batch_frac / acc.dp
    opt = 3.0 if graph.train else 0.0   # grads + adam m,v (bf16-ish model)
    return (w * (1 + opt) + st + 8 * act) <= 0.9 * hw.hbm_bytes


def transfer_time(prod_nodes: List[Node], prod: AccConfig, cons: AccConfig,
                  act_bytes: float, hw: Chip = TPU_V5E, *,
                  feats: Features = Features()) -> float:
    """Inter-accelerator activation transfer (the paper's Fig. 8).

    Compatible shardings (divisible dp/tp factors) → a collective-permute
    over ICI whose cost is the per-chip shard.  Incompatible → resharding
    all-to-all (the paper's "bank conflict" overhead, 3× traffic).  With
    on-chip forwarding disabled (CHARM-like baseline), everything round-trips
    through host DRAM."""
    if not feats.onchip_forwarding:
        return 2.0 * act_bytes / HOST_BW
    per_chip = act_bytes / max(min(prod.chips, cons.chips), 1)
    t = per_chip / (hw.ici_links_per_axis * hw.ici_bw * COLL_EFF)
    compatible = (prod.dp % cons.dp == 0 or cons.dp % prod.dp == 0) and \
                 (prod.tp % cons.tp == 0 or cons.tp % prod.tp == 0)
    if not compatible:
        t *= 3.0
    return t


def roofline_terms(graph: Graph, total_chips: int, hw: Chip = TPU_V5E
                   ) -> Dict[str, float]:
    """Whole-graph three-term roofline on a monolithic allocation (the
    §Roofline analytical cross-check)."""
    mm = graph.total_mm_flops
    t_compute = mm / (total_chips * hw.peak_flops)
    bytes_total = graph.total_weight_bytes + sum(
        4.0 * (n.act_in + n.act_out) + n.state_bytes for n in graph.nodes)
    t_hbm = bytes_total / (total_chips * hw.hbm_bw)
    return {"compute": t_compute, "hbm": t_hbm, "model_flops": mm}
