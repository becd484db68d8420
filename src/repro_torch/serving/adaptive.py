"""Online Pareto navigation of the port: traffic-adaptive re-plan control
(the counterpart of the JAX package's ``serving/adaptive.py``).

The DSE hands serving a *set* of design points — the monolithic engine
(one dispatch per phase, the latency end) and ``ServingPlan``s of varying
spatial decode width / chunked-prefill depth (the throughput end).  Under
live traffic no single point dominates: near-idle, the monolithic step
wins (one dispatch serves every slot, and nothing queues behind a
prompt); under prompt bursts, the pipelined plan wins (chunked prefill
interleaves with decode, so TTFT does not stall behind whole-prompt
admissions).  ``ReplanController`` watches a rolling traffic window and
walks the engine along that Pareto front at runtime via
``ServingEngine.replan`` — zero-copy on the paged path (slot state moves
by block-table handoff, never by KV copy).

Signals (sampled every tick, decided every ``interval_ticks``):

  * arrival rate / prompt length / requested tokens over ``window_s``
    (from the engine's arrival log);
  * queued prompt tokens and active decode depth (live backlog);
  * observed TTFT of recently finished requests and the live
    head-of-queue wait, against the SLO targets.

Cost model (host-serial): each candidate's measured unit times
(``plan.validate.measure_serving_stage_times`` for plans, a mono probe
here; host wall seconds to the device's completion, as the engine's tick
feels them, not device times) price the
current backlog plus ``horizon_s`` of forecast arrivals.  The monolithic
point serializes prefill before decode resumes; a plan overlaps them but
pays every replica's decode dispatch per tick.  The candidate with the
lowest SLO-penalized makespan wins; ``hysteresis`` keeps the controller
from flapping between near-equal points (dropped to zero while an SLO is
being violated) and ``cooldown_ticks`` spaces consecutive swaps.

Degenerate case: when the best candidate IS the current plan, the
decision is still useful — ``replan(current)`` re-balances active slots
across the decode replicas (cross-replica work stealing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.plan.validate import measure_serving_stage_times, timed


@dataclass
class PlanProfile:
    """Unit times of one design point, normalized so mono and plan
    candidates price through the same formulas.

      * ``prefill_tok_s`` — steady-state seconds per backlog prefill
        token (mono: the whole-prompt rate; plan: pipeline-bottleneck
        stage time / chunk);
      * ``first_latency_s`` — extra latency of a prompt's own first
        token beyond the backlog rate (plan: one full stage walk of its
        first chunk; mono: 0 — the backlog rate already prices it);
      * ``decode_tick_s`` — host-serial decode cost per engine tick
        (mono: one full-batch dispatch; plan: every replica's dispatch);
      * ``interfere_s`` — prefill work a decode tick waits behind while
        prompts are streaming (mono: a whole admission; plan: roughly
        one stage-step).
    """
    prefill_tok_s: float
    first_latency_s: float
    decode_tick_s: float
    interfere_s: float
    chunk: int
    is_plan: bool
    measured: bool


@dataclass
class AdaptiveConfig:
    """Knobs for ``ReplanController``; pass as ``ServingEngine(adapt=...)``.

    ``plans`` lists the candidate design points: ``ServingPlan``s and/or
    ``None`` for the monolithic engine.  The engine's initial plan is
    added automatically if missing.  ``slo_ttft_s`` / ``slo_tpot_s`` of 0
    disable that SLO term.  ``measure=False`` skips the timing probes and
    prices candidates with an analytic group-count profile (deterministic
    — useful for tests)."""
    plans: Sequence[Any] = field(default_factory=list)
    slo_ttft_s: float = 0.0
    slo_tpot_s: float = 0.0
    window_s: float = 2.0
    interval_ticks: int = 8
    hysteresis: float = 0.25
    cooldown_ticks: int = 32
    measure: bool = True
    horizon_s: float = 0.5


def measure_mono_step_times(model, params, slots: int, max_seq: int, *,
                            repeat: int = 3) -> Dict[str, float]:
    """Timing probe for the monolithic design point: seconds per prefill
    token (one whole-prompt slot admission) and per full-batch decode
    step, on the model's device.  Uses a throwaway dense cache, so live
    engine state is never touched; one warmup call of each is outside the
    clock."""
    from repro_torch.serving.engine import (make_prefill_slot_step,
                                            make_serve_step)
    serve = make_serve_step(model)
    prefill = make_prefill_slot_step(model, max_seq)
    dev = model.device
    cache = model.init_cache(slots, max_seq)
    P = max(4, min(32, max_seq - 1))
    toks = torch.zeros((1, P), dtype=torch.int64, device=dev)
    pref_s, _ = timed(lambda: prefill(params, cache, toks, 0, P)[0], dev,
                      repeat)
    dtoks = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
    dpos = torch.zeros((slots,), dtype=torch.int64, device=dev)
    dec_s, _ = timed(lambda: serve(params, cache, dtoks, dpos)[0], dev,
                     repeat)
    return {"prefill_tok_s": pref_s / P, "decode_step_s": dec_s}


class ReplanController:
    """Rolling-window traffic watcher + windowed cost model deciding when
    ``ServingEngine`` should swap design points.  ``observe(engine)`` is
    called at the top of every tick; it returns ``None`` (keep the
    current binding) or a 1-tuple ``(plan,)`` naming the new binding
    (``(None,)`` = go monolithic — the tuple disambiguates "no decision"
    from "decide mono")."""

    def __init__(self, cfg: AdaptiveConfig):
        self.cfg = cfg
        self.paused = False           # warm_replans() sets this while it
        #                               drives candidates through the engine
        self._profiles: Dict[Any, PlanProfile] = {}
        self._ticks = 0
        self._cooldown = 0
        self.decisions: List[Tuple[int, str, str]] = []   # (tick, from, to)
        self.last_scores: Optional[List[List[Any]]] = None  # [[label,
        #                               score], ...] of the most recent
        #                               SCORING tick (None between
        #                               decision windows) — the engine
        #                               attaches this to its
        #                               "replan_decision" trace event

    # ------------------------------------------------------------ set-up
    def validate(self, eng) -> None:
        """Sanity-check the candidate ladder against the engine (called
        from ``ServingEngine.__post_init__``)."""
        self.cfg.plans = list(self.cfg.plans)
        for cand in self.cfg.plans:
            if cand is not None and cand.slots != eng.slots:
                raise ValueError(
                    f"adaptive candidate {cand.label!r} was lowered for "
                    f"{cand.slots} slots but the engine has {eng.slots}; "
                    f"re-lower via lower_serving(plan, slots={eng.slots}) "
                    f"or rereplicate_serving")
        if not any(cand == eng.plan for cand in self.cfg.plans):
            self.cfg.plans.insert(0, eng.plan)
        if len(self.cfg.plans) < 2:
            only = self.cfg.plans[0]
            if only is None or only.n_replicas < 2:
                raise ValueError(
                    "adaptive serving needs >= 2 candidate design points "
                    "(AdaptiveConfig.plans plus the engine's initial "
                    "plan), or a single multi-replica plan (the "
                    "degenerate case: cross-replica work stealing only)")

    def warm(self, eng) -> None:
        """Measure every candidate's profile up front (otherwise the
        first decision tick pays for it inside the serving window)."""
        for cand in self.cfg.plans:
            self._profile(eng, cand)

    # ----------------------------------------------------------- profiles
    def _profile(self, eng, cand) -> PlanProfile:
        prof = self._profiles.get(cand)
        if prof is None:
            prof = (self._measure(eng, cand) if self.cfg.measure
                    else self._analytic(eng, cand))
            self._profiles[cand] = prof
        return prof

    def _measure(self, eng, cand) -> PlanProfile:
        if cand is None:
            t = measure_mono_step_times(eng.model, eng.params, eng.slots,
                                        eng.max_seq)
            return PlanProfile(
                prefill_tok_s=t["prefill_tok_s"], first_latency_s=0.0,
                decode_tick_s=t["decode_step_s"],
                interfere_s=t["prefill_tok_s"] * 16,   # ~one admission of
                chunk=1, is_plan=False, measured=True)  # a short prompt
        t = measure_serving_stage_times(eng.model, eng.params, cand,
                                        eng.max_seq,
                                        runtime=eng._runtime_for(cand))
        stage_sum = float(sum(t["stage_s"]))
        stage_max = float(max(t["stage_s"]))
        return PlanProfile(
            prefill_tok_s=stage_max / max(cand.chunk, 1),
            first_latency_s=stage_sum,
            decode_tick_s=float(sum(t["decode_step_s"])),
            interfere_s=stage_sum / max(cand.n_stages, 1),
            chunk=cand.chunk, is_plan=True, measured=True)

    def _analytic(self, eng, cand) -> PlanProfile:
        """Deterministic structural profile (``measure=False``): unit cost
        per (group x token) of work, one dispatch overhead per call.
        Encodes only the host-serial shape — mono pays one
        dispatch per phase, a plan pays one per stage / per replica —
        not real silicon."""
        unit, disp = 1e-5, 1e-4
        G = max(int(getattr(eng.model.cfg, "num_groups", 1)), 1)
        if cand is None:
            return PlanProfile(
                prefill_tok_s=unit * G + disp / 16, first_latency_s=0.0,
                decode_tick_s=disp + unit * G, interfere_s=disp + 16 * unit * G,
                chunk=1, is_plan=False, measured=False)
        per_stage = [disp + unit * s.n_groups * cand.chunk
                     for s in cand.plan.stages]
        return PlanProfile(
            prefill_tok_s=max(per_stage) / cand.chunk,
            first_latency_s=sum(per_stage),
            decode_tick_s=cand.n_replicas * (disp + unit * G),
            interfere_s=sum(per_stage) / len(per_stage),
            chunk=cand.chunk, is_plan=True, measured=False)

    # ----------------------------------------------------------- decision
    def observe(self, eng) -> Optional[Tuple[Any]]:
        self._ticks += 1
        self.last_scores = None
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if self._ticks % max(self.cfg.interval_ticks, 1):
            return None
        sig = self._signals(eng)
        if sig is None:
            return None
        scored = [(self._score(eng, cand, sig), i, cand)
                  for i, cand in enumerate(self.cfg.plans)]
        self.last_scores = [
            [cand.label if cand is not None else "mono", float(s)]
            for s, _, cand in sorted(scored)]
        cur = next(s for s, _, cand in scored if cand == eng.plan)
        best_s, _, best = min(scored)
        if best == eng.plan:
            # degenerate case: the current multi-replica plan stays, but
            # its replicas drifted out of balance (retirements land
            # unevenly) — replan(current) is pure work stealing
            if eng.plan is not None and self._imbalanced(eng):
                self._cooldown = self.cfg.cooldown_ticks
                return (eng.plan,)
            return None
        margin = 0.0 if sig.violated else self.cfg.hysteresis
        if best_s >= cur * (1.0 - margin):
            return None
        self._cooldown = self.cfg.cooldown_ticks
        self.decisions.append((
            self._ticks,
            eng.plan.label if eng.plan is not None else "mono",
            best.label if best is not None else "mono"))
        return (best,)

    def _imbalanced(self, eng) -> bool:
        plan = eng.plan
        load = [0] * plan.n_replicas
        for s in range(eng.slots):
            if eng._slot_req[s] is not None or s in eng._reserved:
                load[plan.replica_of_slot(s)[0]] += 1
        return max(load) - min(load) > 1

    def _signals(self, eng):
        """One typed ``repro_torch.obs.TrafficSnapshot`` of the observation
        window (None = idle).  The engine owns the computation
        (``ServingEngine.traffic_snapshot``) — the controller only states
        which window/SLO parameters it observes under."""
        return eng.traffic_snapshot(
            self.cfg.window_s, slo_ttft_s=self.cfg.slo_ttft_s,
            slo_tpot_s=self.cfg.slo_tpot_s, horizon_s=self.cfg.horizon_s)

    def _score(self, eng, cand, sig) -> float:
        """SLO-penalized makespan of the backlog + ``horizon_s`` of
        forecast arrivals under candidate ``cand``, priced from a
        ``TrafficSnapshot``.  Mono serializes prefill ahead of decode; a
        plan overlaps them (max + half the smaller term) but pays every
        replica's dispatch per tick."""
        prof = self._profile(eng, cand)
        ptok = sig.queued_tok + sig.lam * self.cfg.horizon_s * sig.avg_prompt
        t_pref = ptok * prof.prefill_tok_s
        t_dec = sig.depth * prof.decode_tick_s
        if prof.is_plan:
            makespan = max(t_pref, t_dec) + 0.5 * min(t_pref, t_dec)
        else:
            makespan = t_pref + t_dec
        pen = 0.0
        if self.cfg.slo_ttft_s > 0:
            own = sig.avg_prompt * prof.prefill_tok_s \
                + prof.first_latency_s
            ttft_pred = t_pref + own
            pen += max(0.0, ttft_pred / self.cfg.slo_ttft_s - 1.0)
        if self.cfg.slo_tpot_s > 0:
            busy = min(1.0, ptok / max(prof.chunk, 1.0))
            tpot_pred = prof.decode_tick_s + busy * prof.interfere_s
            pen += max(0.0, tpot_pred / self.cfg.slo_tpot_s - 1.0)
        return makespan * (1.0 + pen)
