"""Derived observability: typed traffic snapshots and utilization views.

``TrafficSnapshot`` is the single typed observation the adaptive
controller reads each window (it used to be an ad-hoc dict built inside
the controller from engine internals).  ``utilization_from_trace``
recomputes time-based stage/replica utilization from the trace stream;
``fold_engine_metrics`` projects an engine ``stats()`` dict onto the
Prometheus registry as gauges.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry


@dataclass(frozen=True)
class TrafficSnapshot:
    """One observation window of serving traffic, as the controller sees it.

    lam: arrival rate (requests/s) over the rolling window.
    avg_prompt: mean prompt tokens of recent arrivals.
    avg_new: mean requested new tokens of recent arrivals.
    queued_tok: prompt tokens waiting in the admission queue.
    depth: forecast decode depth (active slots + expected arrivals
        over the controller horizon, capped at slot count).
    queue_len: requests waiting in the admission queue.
    active: currently active decode slots.
    violated: True when the rolling TTFT/TPOT percentiles breach SLOs.
    window_s: the rolling window the snapshot was computed over.
    """

    lam: float
    avg_prompt: float
    avg_new: float
    queued_tok: float
    depth: float
    queue_len: int
    active: int
    violated: bool
    window_s: float


def utilization_from_trace(tracer: Any) -> Dict[str, Any]:
    """Time-based stage/replica utilization from retained trace records.

    Walks span records: ``("stage", j)`` tracks accumulate prefill busy
    time, ``("replica", r)`` tracks accumulate decode/verify busy time.
    The window is the full [min t0, max t1] extent of retained records.
    """
    stage_busy: Dict[int, float] = {}
    replica_busy: Dict[int, float] = {}
    tmin: Optional[float] = None
    tmax: Optional[float] = None
    for rec in tracer.records():
        if rec[0] != "X":
            continue
        _, track, _name, t0, t1 = rec[:5]
        tmin = t0 if tmin is None else min(tmin, t0)
        tmax = t1 if tmax is None else max(tmax, t1)
        if isinstance(track, tuple):
            kind, idx = track
            if kind == "stage":
                stage_busy[idx] = stage_busy.get(idx, 0.0) + (t1 - t0)
            elif kind == "replica":
                replica_busy[idx] = replica_busy.get(idx, 0.0) + (t1 - t0)
    window = (tmax - tmin) if (tmin is not None and tmax is not None) else 0.0
    out: Dict[str, Any] = {
        "window_s": window,
        "stage_busy_s": dict(sorted(stage_busy.items())),
        "replica_busy_s": dict(sorted(replica_busy.items())),
    }
    if window > 0:
        out["stage_busy_frac"] = {s: b / window for s, b in sorted(stage_busy.items())}
        out["replica_busy_frac"] = {r: b / window for r, b in sorted(replica_busy.items())}
    else:
        out["stage_busy_frac"] = {}
        out["replica_busy_frac"] = {}
    return out


def fold_engine_metrics(reg: MetricsRegistry, st: Dict[str, Any]) -> None:
    """Project an engine ``stats()`` dict onto registry gauges.

    Gauges are *set* (not accrued), so folding the same snapshot twice
    is idempotent — repeated exports in one window agree.
    """
    g = reg.gauge
    g("repro_throughput_tok_s", "generated tokens per second (window)").set(
        st.get("throughput_tok_s", 0.0))
    g("repro_slot_occupancy", "mean active-slot fraction per tick").set(
        st.get("slot_occupancy", 0.0))
    g("repro_tokens_per_step", "mean tokens committed per decode step").set(
        st.get("tokens_per_step", 0.0))
    g("repro_replans_total", "plan swaps this window").set(st.get("replans", 0))
    g("repro_migrations_total", "slot migrations this window").set(
        st.get("migrations", 0))
    g("repro_migration_copies_total", "KV copies during migration (0 = zero-copy)").set(
        st.get("migration_copies", 0))
    g("repro_ticks_total", "engine ticks this window").set(st.get("ticks", 0))
    for phase, secs in st.get("phase_time_s", {}).items():
        g("repro_phase_seconds", "host wall seconds per engine phase (window)",
          phase=phase).set(secs)
    util = st.get("utilization", {})
    for s, frac in util.get("stage_bubble_frac", {}).items():
        g("repro_stage_bubble_frac",
          "fraction of busy-pipeline ticks each prefill stage sat idle",
          stage=str(s)).set(frac)
    for r, occ in util.get("replica_occupancy", {}).items():
        g("repro_replica_occupancy",
          "mean occupied-slot fraction per decode replica",
          replica=str(r)).set(occ)
    g("repro_replica_load_spread",
      "max-min replica occupancy gap (0 = balanced)").set(
        util.get("replica_load_spread", 0.0))
    g("repro_spec_acceptance_rate", "accepted / proposed draft tokens").set(
        util.get("spec_acceptance_rate", 0.0))
    g("repro_prefix_hit_rate", "warm-prefix admissions / total admissions").set(
        util.get("prefix_hit_rate", 0.0))
    cache = st.get("cache")
    if cache:
        g("repro_cache_blocks_in_use", "paged KV blocks currently allocated").set(
            cache.get("blocks_in_use", 0))
        g("repro_cache_peak_blocks", "peak concurrent paged KV blocks").set(
            cache.get("peak_blocks_in_use", 0))
        g("repro_kv_capacity_x", "effective KV capacity multiplier (int8)").set(
            cache.get("kv_capacity_x", 1.0))
