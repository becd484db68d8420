"""Hardware model: TPU v5e constants (the JAX package's target), the
paper's platforms for the analytical-model cross-checks (§6 Q1), and the
port's card, ``H100`` (an H100 SXM 80GB).

The TPU, VCK190, Stratix and A10G constants are the paper's analytical
model data, copied from the JAX package unchanged; none of them is a
measurement of the port's card.

All rates are per chip.  ICI_BW is per-link per-direction; a chip on a 2-D
torus has 4 links (2 per mesh axis)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float          # bf16 (or the platform's serving dtype) FLOP/s
    hbm_bw: float              # bytes/s
    ici_bw: float              # bytes/s per link per direction
    ici_links_per_axis: int    # links per mesh axis (torus: 2)
    hbm_bytes: float
    vmem_bytes: float
    # VPU (vector unit) throughput for nonlinear ops, FLOP/s.
    vpu_flops: float
    # True when inference weights live in on-chip SRAM (the paper's
    # HMM-type0 weight pinning on AIE local memory): steady-state inference
    # pays no off-chip weight traffic.  TPU weights live in HBM -> False.
    weights_resident: bool = False
    # Systolic/matrix-unit tile edge: matmul dims pad to multiples of this.
    # TPU MXU: 128.  AIE cores / FPGA tensor blocks work on ~32-wide tiles,
    # which is why shape mismatch hurts the TPU more (DESIGN.md §2).
    tile: int = 128
    # Achievable fraction of peak for perfectly-shaped matmuls (XLA on MXU
    # sustains ~0.95; CHARM reports ~0.70 for AIE MM kernels).
    max_eff: float = 0.95
    # True for spatial-dataflow platforms whose per-acc array config is
    # frozen at build time (ACAP bitstream): an acc hosting differently-
    # shaped layers runs every layer on a config sized for its largest —
    # the paper's monolithic-acc shape-mismatch penalty (10.9% util).
    # TPUs re-tile per XLA program: False.
    fixed_config: bool = False


TPU_V5E = Chip(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    ici_links_per_axis=2,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=128 * 1024**2,
    vpu_flops=4e12,
)

# Paper platforms, used only by the §6-Q1 cross-platform modeling benchmark.
VCK190 = Chip(
    name="vck190",
    peak_flops=102.4e12,       # INT8 AIE peak
    hbm_bw=25.6e9,             # DDR4
    ici_bw=12.5e9,             # 100Gb/s QSFP28 (multi-board, §6 Q2)
    ici_links_per_axis=1,
    hbm_bytes=8 * 1024**3,
    vmem_bytes=32 * 1024,      # AIE local memory per core (the paper's 32KB)
    vpu_flops=1.8e12,          # PL fabric nonlinear engines (Table 8)
)

STRATIX10_NX = Chip(
    name="stratix10-nx",
    peak_flops=143e12,         # INT8 tensor blocks
    hbm_bw=512e9,
    ici_bw=12.5e9,
    ici_links_per_axis=1,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=16 * 1024**2,   # 16MB on-chip
    vpu_flops=2e12,
)

A10G = Chip(
    name="a10g",
    peak_flops=140e12,         # INT8 tensor cores
    hbm_bw=600e9,
    ici_bw=8e9,                # PCIe-class
    ici_links_per_axis=1,
    hbm_bytes=24 * 1024**3,
    vmem_bytes=6 * 1024**2,
    vpu_flops=35e12 / 2,       # CUDA-core FP32 path
)

# The port's card.  Datasheet figures of the H100 SXM5 80GB, except
# ``max_eff``, which comes from the card itself.
H100 = Chip(
    name="h100-sxm",
    peak_flops=989e12,         # datasheet: dense bf16 tensor-core FLOP/s
    #                            (the figure chip_smoke.py's bounds use)
    hbm_bw=3.35e12,            # datasheet: HBM3 bytes/s (chip_smoke.py's)
    ici_bw=25e9,               # datasheet: NVLink 4, 900 GB/s over 18
    #                            links both ways = 25 GB/s a link and way
    ici_links_per_axis=18,     # every link reaches the NVSwitch, so any
    #                            mesh axis sees all 18
    hbm_bytes=80e9,            # datasheet: 80 GB of HBM3
    vmem_bytes=50 * 1024**2,   # datasheet: 50 MB of L2 (unused by the
    #                            cost model, as on the other chips)
    vpu_flops=67e12,           # datasheet: CUDA-core f32 FLOP/s
    tile=64,                   # wgmma's M granularity: a warpgroup's
    #                            m64nNk16 tile
    max_eff=0.59,              # cuBLAS at M=512, K=4096, N=11008 takes
    #                            0.0790-0.0794 ms of device time, 2*M*N*K/t
    #                            ~ 0.59 of 989 TFLOP/s (PERF.md section 6,
    #                            chip_smoke.py phase 3 on an NVIDIA H100
    #                            80GB HBM3 at a 700 W power limit)
)

CHIPS = {c.name: c for c in (TPU_V5E, VCK190, STRATIX10_NX, A10G, H100)}

# MXU systolic tile edge: matmul dims are padded to multiples of this, which
# is where SSR's "shape mismatch ⇒ low utilization" shows up on TPU.
MXU_TILE = 128
# Empirical ceiling on achievable matmul efficiency (rooflines are not 100%).
MAX_MXU_EFF = 0.95


def mxu_efficiency(m: int, k: int, n: int, tile: int = MXU_TILE,
                   ceiling: float = MAX_MXU_EFF) -> float:
    """Fraction of matrix-unit peak achievable for an (m,k,n) matmul:
    padding waste on each dim (the TPU analogue of the paper's Eq.2 `Eff`)."""
    def frac(d):
        if d <= 0:
            return 1.0
        import math
        return d / (tile * math.ceil(d / tile))
    return ceiling * frac(m) * frac(k) * frac(n)
