"""ExecutionPlan IR — the lowered, runnable form of an SSR design point.

The DSE side of the repo (``core/ea.py`` + ``core/customize.py``) searches
``Assignment``s: node→acc maps with per-acc chip counts and (dp, tp)
factorizations, where layer cuts need not be equal and acc widths need not
match.  The execution side (``pipeline/executor.py``) runs a stage-axis
shard_map over the scanned layer stack.  ``ExecutionPlan`` is the contract
between them:

  * ``stages``          — ordered stage slices over the model's *group*
                          axis (a group = one repetition of the config's
                          block_pattern, the finest runtime partition the
                          scanned stack supports).  Slices are contiguous
                          but need NOT be equal: the executor pads every
                          stage's parameter stack to ``max_groups`` entries
                          and masks the dead ones.
  * per-stage (dp, tp)  — the realized intra-stage sharding intent, scaled
                          from the DSE-requested submesh onto the uniform
                          mesh slot width (a rectangular device mesh cannot
                          give stages different widths, so narrow stages
                          are replicate-padded and the waste is recorded
                          for the cost model to charge).
  * ``n_microbatches``  — spatial dimension: microbatches in flight
                          through the stage pipeline per round.
  * ``n_rounds``        — sequential dimension: rounds of the spatial
                          pipeline (the paper's n_batches); the executor
                          streams ``n_rounds * n_microbatches`` microbatches
                          back-to-back, which is schedule-equivalent for a
                          linear pipeline.

Plans are pure data (hashable, jax-free numerics via numpy) so they can be
built inside DSE loops, logged, and diffed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class StagePlan:
    """One pipeline stage: a contiguous group slice on a mesh slot."""
    index: int              # stage position in the pipeline (0-based)
    acc_id: int             # DSE accelerator this stage realizes
    first_group: int        # first model group owned by this stage
    n_groups: int           # number of groups (>= 1; stages may differ)
    dp: int = 1             # realized data-parallel degree inside the slot
    tp: int = 1             # realized tensor-parallel degree inside the slot
    width: int = 1          # devices in this stage's mesh slot (= dp * tp)
    requested_chips: int = 0   # submesh size the DSE asked for (0 = n/a)
    replica_waste: float = 0.0  # fraction of slot devices beyond the
    #                             work-proportional ideal (replicate-padding)

    def __post_init__(self):
        assert self.n_groups >= 1, self
        assert self.dp * self.tp == self.width, self

    @property
    def groups(self) -> Tuple[int, ...]:
        return tuple(range(self.first_group, self.first_group + self.n_groups))


@dataclass(frozen=True)
class ExecutionPlan:
    """A runnable spatial-sequential pipeline over the scanned layer stack."""
    stages: Tuple[StagePlan, ...]
    num_groups: int         # total model groups (sum of stage n_groups)
    n_microbatches: int     # microbatches in flight per round (spatial)
    n_rounds: int = 1       # rounds of the spatial pipeline (sequential)

    def __post_init__(self):
        assert self.stages, "plan needs >= 1 stage"
        assert self.n_microbatches >= 1 and self.n_rounds >= 1, self
        nxt = 0
        for s in self.stages:
            assert s.first_group == nxt, (
                f"stage {s.index} starts at group {s.first_group}, "
                f"expected {nxt} (stages must tile the group axis)")
            nxt += s.n_groups
        assert nxt == self.num_groups, (nxt, self.num_groups)

    # ----------------------------------------------------------- derived
    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def max_groups(self) -> int:
        """Padded per-stage stack depth: every stage's parameter stack is
        padded to this many groups; dead entries are masked at runtime."""
        return max(s.n_groups for s in self.stages)

    @property
    def total_microbatches(self) -> int:
        """Microbatches streamed end-to-end (spatial x sequential)."""
        return self.n_microbatches * self.n_rounds

    @property
    def stage_width(self) -> int:
        """Uniform mesh slot width (max over stages; narrow stages are
        replicate-padded up to it)."""
        return max(s.width for s in self.stages)

    @property
    def is_uniform(self) -> bool:
        return all(s.n_groups == self.stages[0].n_groups
                   for s in self.stages)

    @property
    def padding_waste(self) -> float:
        """Mean replicate-padding waste across stages (0 = the DSE chip
        split was already uniform)."""
        return float(np.mean([s.replica_waste for s in self.stages]))

    # ------------------------------------------------- executor interfaces
    def group_index_matrix(self) -> np.ndarray:
        """(n_stages, max_groups) int32 of *global* group indices: row s is
        stage s's groups, right-padded by repeating its last real group (a
        clamped gather keeps padded params finite, so masked-out compute
        cannot produce NaNs that would poison a select)."""
        G = self.max_groups
        out = np.zeros((self.n_stages, G), np.int32)
        for s in self.stages:
            for j in range(G):
                out[s.index, j] = s.first_group + min(j, s.n_groups - 1)
        return out

    def group_mask_matrix(self) -> np.ndarray:
        """(n_stages, max_groups) float32; 1.0 for live groups, 0.0 for
        padded entries (dead groups pass activations through unchanged)."""
        G = self.max_groups
        out = np.zeros((self.n_stages, G), np.float32)
        for s in self.stages:
            out[s.index, :s.n_groups] = 1.0
        return out

    def stage_of_group(self, g: int) -> int:
        for s in self.stages:
            if s.first_group <= g < s.first_group + s.n_groups:
                return s.index
        raise IndexError(g)

    def mesh_factors(self, width: Optional[int] = None) -> Tuple[int, int]:
        """(data, model) axis sizes for a rectangular (stage, data, model)
        mesh of slot width ``width``: the model axis is the largest tp all
        stages share (gcd), the data axis absorbs the rest."""
        w = width or self.stage_width
        m = w
        for s in self.stages:
            m = math.gcd(m, max(s.tp, 1))
        m = max(m, 1)
        return w // m, m

    # ------------------------------------------------------------- display
    def describe(self) -> str:
        lines = [f"ExecutionPlan: {self.n_stages} stages x "
                 f"{self.n_microbatches} microbatches x "
                 f"{self.n_rounds} rounds "
                 f"(groups={self.num_groups}, padded depth={self.max_groups},"
                 f" waste={self.padding_waste:.2f})"]
        for s in self.stages:
            lines.append(
                f"  stage {s.index}: groups [{s.first_group}.."
                f"{s.first_group + s.n_groups - 1}] acc{s.acc_id} "
                f"dp{s.dp}xtp{s.tp} width={s.width} "
                f"(requested {s.requested_chips} chips, "
                f"waste={s.replica_waste:.2f})")
        return "\n".join(lines)


@dataclass(frozen=True)
class ServingPlan:
    """An ``ExecutionPlan`` lowered for the continuous-batching engine.

    The plan's two pipeline dimensions map onto the two serving regimes
    (the SSR latency-throughput tradeoff under live traffic):

      * ``plan.stages``          — the *prefill pipeline*: admitted prompts
                                   are sliced into ``chunk``-token chunks
                                   that stream through the stage slices as
                                   microbatches, one stage-step per engine
                                   tick, interleaved with decode;
      * ``plan.n_microbatches``  — the *spatial width* becomes the number
                                   of independent decode replicas; the
                                   engine's ``slots`` are partitioned over
                                   them (``replica_slots``) and each
                                   replica runs a batched per-slot decode
                                   walk over the same stage slices.

    Pure data (like ``ExecutionPlan``); the runtime lowering lives in
    ``repro_torch.plan.serving``.
    """
    plan: ExecutionPlan
    slots: int                        # engine slots, total over replicas
    chunk: int                        # prefill chunk length (tokens)
    replica_slots: Tuple[int, ...]    # per-replica slot counts (sum = slots)

    def __post_init__(self):
        assert self.slots >= 1 and self.chunk >= 1, self
        assert sum(self.replica_slots) == self.slots, self
        assert all(n >= 1 for n in self.replica_slots), self

    @property
    def n_replicas(self) -> int:
        return len(self.replica_slots)

    @property
    def n_stages(self) -> int:
        return self.plan.n_stages

    @property
    def label(self) -> str:
        """Compact design-point tag ("3s x 2r c16") for controller logs,
        bench rows, and the serve CLI; the monolithic point (no plan) is
        conventionally labelled "mono"."""
        return f"{self.n_stages}s x {self.n_replicas}r c{self.chunk}"

    def replica_of_slot(self, slot: int) -> Tuple[int, int]:
        """Global slot id -> (replica index, slot index inside it)."""
        start = 0
        for r, n in enumerate(self.replica_slots):
            if slot < start + n:
                return r, slot - start
            start += n
        raise IndexError(slot)

    def replica_range(self, r: int) -> Tuple[int, int]:
        start = sum(self.replica_slots[:r])
        return start, start + self.replica_slots[r]

    def describe(self) -> str:
        return (f"ServingPlan: {self.n_replicas} decode replicas over "
                f"{self.slots} slots {list(self.replica_slots)}, "
                f"chunked prefill (chunk={self.chunk}) through "
                f"{self.n_stages} stages\n" + self.plan.describe())


def uniform_plan(num_groups: int, n_stages: int, n_microbatches: int, *,
                 n_rounds: int = 1, dp: int = 1, tp: int = 1
                 ) -> ExecutionPlan:
    """The legacy executor's contract as a plan: equal contiguous stage
    slices, one shared (dp, tp).  Requires num_groups % n_stages == 0 —
    uneven splits come from ``plan.lower.lower``, not from here."""
    if n_stages < 1 or num_groups % n_stages:
        raise ValueError(
            f"uniform_plan: n_stages={n_stages} does not evenly divide "
            f"num_groups={num_groups}; pick a divisor of the group count "
            f"or lower an uneven Assignment via plan.lower.lower")
    per = num_groups // n_stages
    stages = tuple(
        StagePlan(index=i, acc_id=i, first_group=i * per, n_groups=per,
                  dp=dp, tp=tp, width=dp * tp, requested_chips=dp * tp)
        for i in range(n_stages))
    return ExecutionPlan(stages=stages, num_groups=num_groups,
                         n_microbatches=n_microbatches, n_rounds=n_rounds)


def _divisor_pairs(w: int) -> Sequence[Tuple[int, int]]:
    return [(d, w // d) for d in range(1, w + 1) if w % d == 0]


def fit_dp_tp(width: int, want_dp: int, want_tp: int,
              max_dp: Optional[int] = None) -> Tuple[int, int]:
    """Realize a requested (dp, tp) on a slot of ``width`` devices: the
    divisor pair of ``width`` closest (log-ratio) to the requested
    factorization, with dp optionally capped (dp cannot exceed the
    per-microbatch batch)."""
    want = math.log(max(want_dp, 1) / max(want_tp, 1))
    best, best_d = None, math.inf
    for dp, tp in _divisor_pairs(width):
        if max_dp is not None and dp > max(max_dp, 1):
            continue
        d = abs(math.log(dp / tp) - want)
        if d < best_d:
            best, best_d = (dp, tp), d
    return best if best is not None else (1, width)
