"""Live re-planning in the port's engine against the JAX sync engine, the
port's one-shot gold and the JAX re-plan controller.

``ServingEngine.replan`` swaps the engine between the monolithic point and
``ServingPlan``s mid-traffic.  The forced re-plan chains of
``tests/test_serving_parity.py`` run through the port and through the JAX
SYNC engine with the same swaps at the same ticks, on bridged weights:
every request's stream must equal the JAX engine's and the port's gold.
Cases: mono -> narrow -> wide -> mono (dense and paged), the zero-copy
rebalance on paged pools, swaps in the middle of a chunked prefill (to a
wider plan and to mono), speculation, overlap (held to the port's sync
engine and the gold: the JAX overlap engine is not a reference, its own
re-plan test is intermittent), the runtime cache, and the jamba hybrid,
whose migration copies a mamba-state row.  Each JAX run is memoized.

The controller: the port's ``ReplanController`` and JAX's, both with
``measure=False`` (analytic profiles), price the same scripted
``TrafficSnapshot``s to the same floats and take the same decisions; and
the JAX tests of the controller loop, the ladder validation and the
traced decisions are ported.  The stats key sets equal JAX's.  The
launcher's ``--adapt`` and SLO flags run in-process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro import obs as JO  # noqa: E402
from repro import plan as JP  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import AdaptiveConfig as JAdaptiveConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import AdaptiveConfig, Request  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from test_torch_serving import (SPEC_PROMPTS, STAGGERED,  # noqa: E402
                                gold_decode)

MAX_SEQ = 64
REBALANCE_PROMPTS = [np.arange(1, 6, dtype=np.int32),
                     np.arange(20, 29, dtype=np.int32)]
MID_PROMPTS = [np.arange(1, 4, dtype=np.int32),          # 13 tokens:
               np.arange(5, 18, dtype=np.int32)]         # 4 chunks of 4


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_reduced(J_REGISTRY["yi-6b"], layers=4))
    jp = jm.init(jax.random.key(0))
    tcfg = t_reduced(T_REGISTRY["yi-6b"], layers=4)
    tm = t_build(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")


@pytest.fixture(scope="module")
def hybrid_models():
    from test_torch_model import hybrid_configs, numpy_params
    jc, tc = hybrid_configs(layers=16)
    jm = j_build(jc)
    tree = numpy_params(jm, 1)
    tm = t_build(tc, device="cpu")
    return (jm, jax.tree.map(jax.numpy.asarray, tree), tm,
            params_from_numpy(tree, tc, "cpu"))


@pytest.fixture(scope="module")
def golds(models):
    _, _, tm, tp = models
    return [gold_decode(tm, tp, p, mn, MAX_SEQ) for p, mn, _ in STAGGERED]


@pytest.fixture(scope="module")
def spec_golds(models):
    _, _, tm, tp = models
    return [gold_decode(tm, tp, p, mn, MAX_SEQ) for p, mn, _ in SPEC_PROMPTS]


def ladder(mod, groups, slots, chunk=4):
    """{"mono", "narrow", "wide"}: the monolithic point, a 2-stage plan with
    one decode replica, and one with a replica per slot."""
    return {"mono": None,
            "narrow": mod.lower_serving(
                mod.uniform_plan(groups, 2, n_microbatches=1), slots=slots,
                chunk=chunk),
            "wide": mod.lower_serving(
                mod.uniform_plan(groups, 2, n_microbatches=slots),
                slots=slots, chunk=chunk)}


def run_replans(engine_cls, request_cls, mod, model, params, *, slots,
                swaps, sched=STAGGERED, **kw):
    """Drive ``sched`` (prompt, max_new, submit_tick) and force
    ``replan`` at the given ticks; ``swaps``: [(tick, ladder key)].
    Returns (engine, {uid: tokens})."""
    lad = ladder(mod, model.cfg.num_groups, slots)
    eng = engine_cls(model, params, slots=slots, max_seq=MAX_SEQ, **kw)
    pending = sorted(enumerate(sched), key=lambda x: x[1][2])
    swaps = sorted(swaps)
    tick, busy = 0, True
    while busy or pending or swaps:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _) = pending.pop(0)
            eng.submit(request_cls(uid, prompt, max_new))
        while swaps and swaps[0][0] <= tick:
            eng.replan(lad[swaps.pop(0)[1]])
        busy = eng.tick()
        tick += 1
    return eng, {r.uid: r.out_tokens for r in eng.done}


REPLAN_KEYS = ("replans", "migrations", "migration_copies", "plan_label",
               "requests", "gen_tokens", "spec_steps")
_jax_runs = {}


def jax_replans(key, jm, jp, **kw):
    """The JAX sync engine's streams and re-plan stats for one forced
    chain, run once."""
    if key not in _jax_runs:
        eng, got = run_replans(JEngine, JRequest, JP, jm, jp, **kw)
        st = eng.stats()
        _jax_runs[key] = (got, {k: st[k] for k in REPLAN_KEYS})
    return _jax_runs[key]


# ---------------------------------------------------------------------------
# forced re-plan chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_replan_sequence_mono_narrow_wide_mono(models, golds, paged):
    """Mono -> 1-replica plan -> 3-replica plan -> mono, forced across the
    staggered arrivals: every stream equals the JAX sync engine's and the
    gold; the re-plan counters equal JAX's.  Paged swaps move no K/V."""
    jm, jp, tm, tp = models
    kw = {"paged": True, "page_size": 4} if paged else {}
    swaps = [(3, "narrow"), (6, "wide"), (9, "mono")]
    jgot, jst = jax_replans(("sequence", paged), jm, jp, slots=3,
                            swaps=swaps, **kw)
    eng, got = run_replans(ServingEngine, Request, TP, tm, tp, slots=3,
                           swaps=swaps, **kw)
    assert len(got) == len(STAGGERED)
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"paged={paged} uid={uid}"
        assert got[uid] == jgot[uid], f"paged={paged} uid={uid}"
    st = eng.stats()
    assert {k: st[k] for k in REPLAN_KEYS} == jst
    assert st["replans"] == 3 and st["plan_label"] == "mono"
    assert eng._caches is None and eng._rt is None
    if paged:
        assert st["migration_copies"] == 0
        assert st["cache"]["migrations"] == eng._pager.migrations
    else:
        assert st["migration_copies"] == st["migrations"]


def rebalance_run(engine_cls, request_cls, mod, model, params, prompts,
                  new, stages=2):
    """Two requests decode on slots 0 and 1 of a 4-slot paged mono engine;
    then ``replan`` onto a 2-replica plan, whose replica 0 is slots [0, 1]:
    the load 2|0 forces one migration.  Returns (engine, streams, pool
    counters before the swap, pool counters right after it)."""
    eng = engine_cls(model, params, slots=4, max_seq=MAX_SEQ, paged=True,
                     page_size=4)
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(uid, p, new))
    for _ in range(3):
        eng.tick()
    assert [s for s in range(4) if eng._slot_req[s] is not None] == [0, 1]
    pool = eng._pager.pool

    def counters():
        return (pool.blocks_in_use, pool.cow_copies, pool.evictions)
    before = counters()
    eng.replan(mod.lower_serving(
        mod.uniform_plan(model.cfg.num_groups, stages, n_microbatches=2),
        slots=4, chunk=4))
    after = counters()
    moved = [s for s in range(4) if eng._slot_req[s] is not None]
    assert len(moved) == 2 and moved[1] >= 2
    return eng, {r.uid: r.out_tokens for r in eng.run()}, before, after



def test_replan_rebalance_migrates_zero_copy_paged(models):
    """Work stealing on the paged path: a block-table row handoff; the
    pool's blocks in use, copy-on-writes and evictions are unchanged by
    the swap, and both streams equal the JAX engine's and the gold."""
    jm, jp, tm, tp = models
    if "rebalance" not in _jax_runs:
        _, jgot, _, _ = rebalance_run(JEngine, JRequest, JP, jm, jp,
                                      REBALANCE_PROMPTS, 10)
        _jax_runs["rebalance"] = jgot
    jgot = _jax_runs["rebalance"]
    eng, got, before, after = rebalance_run(ServingEngine, Request, TP, tm,
                                            tp, REBALANCE_PROMPTS, 10)
    assert eng.migrations == 1 and eng._pager.migrations == 1
    assert eng.migration_copies == 0
    assert after == before
    for uid, p in enumerate(REBALANCE_PROMPTS):
        assert got[uid] == gold_decode(tm, tp, p, 10, MAX_SEQ)
        assert got[uid] == jgot[uid]
    st = eng.stats()
    assert st["migrations"] == 1 and st["cache"]["migrations"] == 1


def mid_prefill_run(engine_cls, request_cls, mod, model, params, to_mono):
    """A re-plan while request 1's 13-token prompt (4 chunks) is mid-way
    through the narrow plan's stages.  Returns (engine, streams, the
    item's runtime, the engine's runtime before the swap, whether the old
    pipeline survived a swap to mono)."""
    lad = ladder(mod, model.cfg.num_groups, 2)
    eng = engine_cls(model, params, slots=2, max_seq=MAX_SEQ,
                     plan=lad["narrow"], paged=True, page_size=4)
    eng.submit(request_cls(0, MID_PROMPTS[0], 8))
    while eng._slot_req[0] is None:
        eng.tick()
    eng.submit(request_cls(1, MID_PROMPTS[1], 6))
    eng.tick()
    assert 1 in eng._reserved
    item = eng._pf.items[0]
    rt0 = eng._rt
    eng.replan(lad["mono" if to_mono else "wide"])
    draining = eng._pf is not None
    return (eng, {r.uid: r.out_tokens for r in eng.run()}, item.rt, rt0,
            draining)



@pytest.mark.parametrize("to_mono", [False, True])
def test_replan_mid_prefill_drains_on_admission_runtime(models, to_mono):
    """Drain-and-rebind: the chunks left of a prefill in flight finish on
    the runtime they were admitted under (plan -> wider plan, and plan ->
    mono, where the old pipeline lives only to drain and is dropped when
    dry); the streams equal the JAX engine's and the gold."""
    jm, jp, tm, tp = models
    key = ("mid", to_mono)
    if key not in _jax_runs:
        _jax_runs[key] = mid_prefill_run(JEngine, JRequest, JP, jm, jp,
                                         to_mono)[1]
    jgot = _jax_runs[key]
    eng, got, item_rt, rt0, draining = mid_prefill_run(
        ServingEngine, Request, TP, tm, tp, to_mono)
    assert item_rt is rt0 and eng._rt is not rt0
    if to_mono:
        assert draining and eng._pf is None and eng.plan is None
    else:
        assert eng._pf is not None and eng._pf.rt is eng._rt
    assert got[0] == gold_decode(tm, tp, MID_PROMPTS[0], 8, MAX_SEQ)
    assert got[1] == gold_decode(tm, tp, MID_PROMPTS[1], 6, MAX_SEQ)
    assert got == jgot
    assert eng.stats()["migration_copies"] == 0


def test_replan_with_speculation_active_stays_gold(models, spec_golds):
    """Mono -> plan -> mono between speculative verify ticks: the streams
    equal the JAX engine's and the gold, and speculation accepts drafts."""
    jm, jp, tm, tp = models
    kw = dict(slots=2, sched=SPEC_PROMPTS, swaps=[(4, "narrow"), (8, "mono")],
              speculate=2, paged=True, page_size=4)
    jgot, jst = jax_replans("speculate", jm, jp, **kw)
    eng, got = run_replans(ServingEngine, Request, TP, tm, tp, **kw)
    st = eng.stats()
    assert st["replans"] == 2 and st["migration_copies"] == 0
    assert st["spec_steps"] > 0 and st["spec_accepted"] > 0
    assert {k: st[k] for k in REPLAN_KEYS} == jst
    for uid, gold in enumerate(spec_golds):
        assert got[uid] == gold and got[uid] == jgot[uid], f"uid={uid}"


def test_replan_under_overlap_drains_inflight_first(models, golds):
    """Overlap mode: a re-plan lands the undrained step first.  Across
    mono -> plan -> mono the overlapped streams equal the port's sync
    engine's under the same swaps and the gold."""
    _, _, tm, tp = models
    kw = dict(slots=2, swaps=[(4, "narrow"), (9, "mono")], paged=True,
              page_size=4)
    eng, got = run_replans(ServingEngine, Request, TP, tm, tp,
                           overlap=True, **kw)
    _, sync = run_replans(ServingEngine, Request, TP, tm, tp, **kw)
    assert eng._overlap and not eng._inflight
    assert eng.stats()["replans"] == 2
    for uid, gold in enumerate(golds):
        assert got[uid] == gold and got[uid] == sync[uid], f"uid={uid}"


def test_replan_drain_inflight_lands_steps_and_drops_the_chain(models):
    """A re-plan of an overlapped engine with a step in flight drains it
    and drops the device-side token chain before re-binding."""
    _, _, tm, tp = models
    lad = ladder(TP, tm.cfg.num_groups, 2)
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, overlap=True,
                        paged=True, page_size=4)
    eng.submit(Request(0, STAGGERED[0][0], 6))
    while not eng._inflight:
        eng.tick()
    assert eng._cur_dev is not None
    eng.replan(lad["wide"])
    assert not eng._inflight and eng._cur_dev is None
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert done[0] == gold_decode(tm, tp, STAGGERED[0][0], 6, MAX_SEQ)


def test_replan_to_unseen_plan_and_back_reuses_runtime_cache(models):
    """Swapping back to a design point seen before reuses its runtime."""
    _, _, tm, tp = models
    lad = ladder(TP, tm.cfg.num_groups, 2)
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, plan=lad["narrow"],
                        paged=True, page_size=4)
    rt0 = eng._rt
    eng.replan(lad["wide"])
    assert eng._rt is not rt0 and len(eng._caches) == 2
    eng.replan(lad["narrow"])
    assert eng._rt is rt0
    eng.replan(lad["mono"])
    assert eng._rt is None and eng.plan is None and eng._caches is None
    assert eng.stats()["replans"] == 3


def test_replan_views_write_through_and_contract(models):
    """After a swap the replicas' caches are views of the engine's one
    cache again, and a plan lowered for other slots is refused with JAX's
    message."""
    _, _, tm, tp = models
    lad = ladder(TP, tm.cfg.num_groups, 2)
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ)
    eng.replan(lad["wide"])
    for r, view in enumerate(eng._caches):
        for bk, sub in view.items():
            for key, leaf in sub.items():
                for n, t in leaf.items():
                    assert t.data_ptr() == \
                        eng._cache[bk][key][n][:, r:r + 1].data_ptr()
    other = ladder(TP, tm.cfg.num_groups, 3)["wide"]
    with pytest.raises(ValueError, match="lowered for 3 slots"):
        eng.replan(other)


def test_hybrid_migration_moves_the_mamba_row(hybrid_models):
    """The jamba hybrid, paged: a swap from mono onto a 1-stage,
    2-replica plan while both active slots sit on replica 0 moves one
    slot, whose mamba state (conv and SSM) is a dense row: one copy, and
    the streams equal the JAX hybrid sync engine's and the gold."""
    jm, jp, tm, tp = hybrid_models
    if "hybrid" not in _jax_runs:
        jeng, jgot, _, _ = rebalance_run(JEngine, JRequest, JP, jm, jp,
                                         REBALANCE_PROMPTS, 8, stages=1)
        _jax_runs["hybrid"] = (jgot, jeng.migration_copies)
    jgot, jcopies = _jax_runs["hybrid"]
    eng, got, before, after = rebalance_run(ServingEngine, Request, TP, tm,
                                            tp, REBALANCE_PROMPTS, 8,
                                            stages=1)
    st = eng.stats()
    assert st["migration_copies"] == st["migrations"] == jcopies >= 1
    assert after == before
    for uid, p in enumerate(REBALANCE_PROMPTS):
        assert got[uid] == gold_decode(tm, tp, p, 8, MAX_SEQ), f"uid={uid}"
        assert got[uid] == jgot[uid], f"uid={uid}"


def test_extract_dense_slot_views_only_dense_rows(hybrid_models):
    """``extract_dense_slot``: one batch row of the dense leaves as views,
    ``{}`` for an all-global-attention paged cache."""
    from repro_torch.models import transformer as T
    _, _, tm, _ = hybrid_models
    cache = tm.init_paged_cache(3, MAX_SEQ, page_size=4, num_blocks=8)
    part = T.extract_dense_slot(cache, 2)
    assert part and all(not T._block_is_paged(cache[bk]) for bk in part)
    for bk, sub in part.items():
        for key, leaf in sub.items():
            for n, t in leaf.items():
                assert t.shape[1] == 1 and t.data_ptr() == \
                    cache[bk][key][n][:, 2:3].data_ptr()
    ycfg = t_reduced(T_REGISTRY["yi-6b"], layers=2)
    ycache = t_build(ycfg, device="cpu").init_paged_cache(
        2, MAX_SEQ, page_size=4, num_blocks=8)
    assert T.extract_dense_slot(ycache, 1) == {}


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

SNAPSHOTS = [  # (lam, avg_prompt, avg_new, queued_tok, depth, queue_len,
    #            active, violated)
    (0.0, 0.0, 0.0, 0.0, 6.0, 0, 2, False),
    (40.0, 24.0, 4.0, 144.0, 4.0, 6, 2, False),
    (40.0, 24.0, 4.0, 96.0, 4.0, 4, 2, True),
    (3.0, 8.0, 12.0, 0.0, 9.0, 0, 3, False),
    (0.5, 5.0, 6.0, 0.0, 2.0, 0, 1, True),
    (120.0, 40.0, 16.0, 800.0, 16.0, 20, 3, False),
]


def controller_pair(models, start="mono", **cfg):
    """A JAX and a port engine (3 slots, bound to ``start``) with the same
    ladder and ``AdaptiveConfig`` (analytic profiles)."""
    jm, jp, tm, tp = models
    out = []
    for E, C, mod, m, p in ((JEngine, JAdaptiveConfig, JP, jm, jp),
                            (ServingEngine, AdaptiveConfig, TP, tm, tp)):
        lad = ladder(mod, m.cfg.num_groups, 3)
        out.append(E(m, p, slots=3, max_seq=MAX_SEQ, plan=lad[start],
                     adapt=C(
            plans=[lad["mono"], lad["narrow"], lad["wide"]], measure=False,
            **cfg)))
    return out


def snapshot(mod, row):
    return mod.TrafficSnapshot(*row, window_s=2.0)


@pytest.mark.parametrize("slo", [(0.0, 0.0), (0.05, 0.002)])
def test_controller_scores_equal_jax(models, slo):
    """``_score`` of every candidate on every scripted snapshot: the same
    float as JAX's, SLO penalties on and off."""
    jeng, teng = controller_pair(models, slo_ttft_s=slo[0],
                                 slo_tpot_s=slo[1])
    jctl, tctl = jeng._ctl, teng._ctl
    assert [c.label if c else "mono" for c in tctl.cfg.plans] == \
        [c.label if c else "mono" for c in jctl.cfg.plans]
    for row in SNAPSHOTS:
        js, ts = snapshot(JO, row), snapshot(TO, row)
        for jc, tc in zip(jctl.cfg.plans, tctl.cfg.plans):
            assert tctl._score(teng, tc, ts) == jctl._score(jeng, jc, js), \
                (row, tc)
    for jc, tc in zip(jctl.cfg.plans, tctl.cfg.plans):
        assert vars(tctl._profile(teng, tc)) == vars(jctl._profile(jeng, jc))


def test_controller_decisions_equal_jax(models):
    """``observe`` on a scripted snapshot sequence, every decision applied
    with ``replan``: the same decisions, scores and labels as JAX's (wide
    -> mono on decode-only traffic, mono -> narrow once a burst breaks
    the TTFT target)."""
    jeng, teng = controller_pair(models, start="wide", interval_ticks=1,
                                 cooldown_ticks=1, hysteresis=0.1,
                                 slo_ttft_s=0.05)
    seq = [SNAPSHOTS[i] for i in (0, 0, 2, 2, 0, 0, 1, 1, 4, 5)]
    for eng, mod in ((jeng, JO), (teng, TO)):
        it = iter(seq)
        eng._ctl._signals = lambda e, it=it, mod=mod: snapshot(mod, next(it))
    jscores, tscores = [], []
    for _ in seq:
        for eng, scores in ((jeng, jscores), (teng, tscores)):
            d = eng._ctl.observe(eng)
            scores.append(eng._ctl.last_scores)
            if d is not None:
                eng.replan(d[0])
    assert tscores == jscores
    assert teng._ctl.decisions == jeng._ctl.decisions
    assert teng._ctl.decisions[:2] == [(1, "2s x 3r c4", "mono"),
                                       (4, "mono", "2s x 1r c4")]
    assert teng.replans == jeng.replans


def test_adaptive_controller_navigates_burst_then_idle(models):
    """The controller loop (analytic profiles): a long-prompt burst drives
    the engine onto the pipelined plan, and the drained near-idle tail
    brings it back to the monolithic point, every stream completing."""
    _, _, tm, tp = models
    plan = TP.lower_serving(TP.uniform_plan(tm.cfg.num_groups, 2,
                                            n_microbatches=2),
                            slots=2, chunk=8)
    adapt = AdaptiveConfig(plans=[None, plan], measure=False,
                           interval_ticks=2, cooldown_ticks=2,
                           hysteresis=0.1, window_s=30.0, horizon_s=0.1)
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, paged=True,
                        page_size=4, adapt=adapt)
    assert eng._ctl is not None
    for uid in range(6):
        eng.submit(Request(uid, np.arange(1, 25, dtype=np.int32), 4))
    for _ in range(8):
        eng.tick()
    assert eng.plan == plan
    assert eng._ctl.decisions[0][2] == plan.label
    done = eng.run()
    assert len(done) == 6 and all(len(r.out_tokens) == 4 for r in done)
    assert eng.plan is None
    st = eng.stats()
    assert st["replans"] >= 2 and st["phase_time_s"]["replan"] > 0.0


def test_adaptive_config_validation(models):
    """Ladders are validated at construction with JAX's messages: a
    candidate lowered for other slots, and a single-point ladder."""
    jm, jp, tm, tp = models
    msgs = []
    for E, C, mod, m, p in ((JEngine, JAdaptiveConfig, JP, jm, jp),
                            (ServingEngine, AdaptiveConfig, TP, tm, tp)):
        wrong = mod.lower_serving(mod.uniform_plan(m.cfg.num_groups, 2,
                                                   n_microbatches=2),
                                  slots=4, chunk=4)
        got = []
        for plans in ([wrong], []):
            with pytest.raises(ValueError) as e:
                E(m, p, slots=2, max_seq=48, adapt=C(plans=plans))
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]
    assert "slots" in msgs[1][0]
    assert "candidate design points" in msgs[1][1]


def test_replan_decision_events_carry_scored_candidates(models):
    """A traced adaptive engine records ``replan_decision`` instants with
    the scored candidates and the decision."""
    _, _, tm, tp = models
    plan = TP.lower_serving(TP.uniform_plan(tm.cfg.num_groups, 2,
                                            n_microbatches=2),
                            slots=2, chunk=4)
    eng = ServingEngine(
        tm, tp, slots=2, max_seq=48, plan=plan, paged=True, page_size=4,
        trace=True, adapt=AdaptiveConfig(plans=[None, plan],
                                         interval_ticks=2, cooldown_ticks=2,
                                         window_s=5.0, measure=False))
    for uid in range(4):
        eng.submit(Request(uid, np.arange(1 + uid, 9 + uid, dtype=np.int32),
                           6))
    eng.run()
    decisions = [r for r in eng._tr.records()
                 if r[0] == "I" and r[2] == "replan_decision"]
    assert decisions, "no replan_decision instants traced"
    scored = [r for r in decisions if r[4]["scores"]]
    assert scored, "no decision carried candidate scores"
    for label, score in scored[0][4]["scores"]:
        assert isinstance(label, str) and isinstance(score, float)
    assert all("decision" in r[4] for r in decisions)


def test_warm_replans_restores_the_binding(models):
    """``warm_replans`` measures every candidate, serves a short request
    through each and returns to the initial binding; the stats then reset
    with the re-plan counters."""
    _, _, tm, tp = models
    lad = ladder(TP, tm.cfg.num_groups, 2)
    eng = ServingEngine(tm, tp, slots=2, max_seq=MAX_SEQ, paged=True,
                        page_size=4, plan=lad["narrow"],
                        adapt=AdaptiveConfig(plans=list(lad.values())))
    eng.warm_replans()
    assert eng.plan == lad["narrow"] and not eng._ctl.paused
    assert len(eng.done) == 3 and eng.replans == 4
    assert all(p.measured for p in eng._ctl._profiles.values())
    assert set(eng._rt_cache) == {lad["narrow"], lad["wide"]}
    eng.reset_stats()
    st = eng.stats()
    assert (st["replans"], st["migrations"], st["migration_copies"]) == \
        (0, 0, 0)
    assert st["phase_time_s"]["replan"] == 0.0
    assert st["cache"]["migrations"] == 0


# ---------------------------------------------------------------------------
# stats keys and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("plan_key", ["mono", "wide"])
def test_stats_key_sets_equal_jax(models, paged, plan_key):
    """The port's ``stats()``, ``phase_time_s`` and ``cache`` key sets
    equal the JAX engine's on the same engine layout."""
    jm, jp, tm, tp = models
    kw = {"paged": True, "page_size": 4} if paged else {}
    sts = []
    for E, mod, m, p in ((JEngine, JP, jm, jp), (ServingEngine, TP, tm, tp)):
        plan = ladder(mod, m.cfg.num_groups, 2)[plan_key]
        sts.append(E(m, p, slots=2, max_seq=MAX_SEQ, plan=plan, **kw).stats())
    jst, st = sts
    assert set(st) == set(jst)
    assert set(st["phase_time_s"]) == set(jst["phase_time_s"])
    assert set(st["cache"]) == set(jst["cache"])


def test_launcher_adapt_prints_its_decisions(monkeypatch, capsys):
    """``--adapt`` on the CPU at reduced width: the candidates are warmed
    and measured, the run serves, and the line and the decisions print."""
    monkeypatch.setitem(T_REGISTRY, "yi-6b", t_reduced(T_REGISTRY["yi-6b"]))
    launcher.main(["--device", "cpu", "--layers", "2", "--paged", "--adapt",
                   "--slo-ttft", "1", "--slo-tpot", "0.5", "--requests", "3",
                   "--new-tokens", "4", "--max-seq", "64", "--chunk", "4"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out
    assert ", adapt: replans=" in out and "(copies=0)" in out
    assert "[serve] adapt decisions (tick, from, to): [" in out


@pytest.mark.parametrize("args", [["--slo-ttft", "1"],
                                  ["--adapt", "--slo-tpot", "-1"]])
def test_launcher_slo_flags_exit_with_jax_messages(args):
    """SLO targets without ``--adapt``, and a negative SLO, end the
    launcher with the JAX launcher's messages."""
    from repro.launch.serve import main as j_main
    msgs = []
    for main in (j_main, launcher.main):
        with pytest.raises(SystemExit) as e:
            main(["--requests", "1", *args]
                 + (["--device", "cpu"] if main is launcher.main else []))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] and "--slo-ttft/--slo-tpot" in msgs[1]
