"""The port's overlapped decode runtime against its sync engine, its
one-shot gold and the JAX package's SYNC engine.

``ServingEngine(overlap=True)`` dispatches decode step N+1 before step N's
tokens are read back (one-step-delayed drain).  Every request's stream
must equal the port's sync stream, the port's isolated one-shot gold (fp
caches) and the JAX sync engine's stream on the same bridged weights, for
the monolithic engine (dense and paged), plan-driven serving (dense and
paged, ``uniform_plan`` at 3 slots, chunk 4), int8 pools (held to the
JAX int8 sync streams) and the jamba hybrid.  The schedule runs 5
requests through 2 slots, with one retiring on EOS and the rest on their
token budget.  The JAX overlap engine is not a reference here: its own
parity tests fail intermittently.  Each JAX layout runs once and is
memoized; the same runs hold the port's utilization integers to JAX's.
Beside parity: speculation forces sync, the phase clock stays coherent
under overlap, and ``_drain_inflight`` lands every step in flight.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro import plan as JP  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_serving import (SPEC_PROMPTS, STAGGERED,  # noqa: E402
                                gold_decode)

# (prompt, max_new, submit_after_tick, eos): 5 requests through 2 slots;
# uid 1 retires on EOS (its gold's first token that is new at index >= 2)
READMIT = [
    (np.arange(1, 4, dtype=np.int32), 6, 0),
    (np.arange(5, 14, dtype=np.int32), 8, 0),
    (np.array([9, 8, 7, 6, 5], np.int32), 5, 1),
    (np.array([2, 2], np.int32), 7, 2),
    (np.array([4, 5, 6, 7], np.int32), 6, 3),
]
EOS_UID = 1
MAX_SEQ = 64


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_reduced(J_REGISTRY["yi-6b"], layers=2))
    jp = jm.init(jax.random.key(0))
    tcfg = t_reduced(T_REGISTRY["yi-6b"], layers=2)
    tm = t_build(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                         "cpu")


@pytest.fixture(scope="module")
def hybrid_models():
    from test_torch_model import hybrid_configs, numpy_params
    jc, tc = hybrid_configs()
    jm = j_build(jc)
    tree = numpy_params(jm, 1)
    tm = t_build(tc, device="cpu")
    return (jm, jax.tree.map(jax.numpy.asarray, tree), tm,
            params_from_numpy(tree, tc, "cpu"))


@pytest.fixture(scope="module")
def sched(models):
    """READMIT with uid 1's EOS token, and the gold streams (uid 1's cut
    at its EOS)."""
    _, _, tm, tp = models
    golds = [gold_decode(tm, tp, p, mn, MAX_SEQ) for p, mn, _ in READMIT]
    g = golds[EOS_UID]
    j = next(i for i in range(2, len(g) - 1) if g[i] not in g[:i])
    golds[EOS_UID] = g[:j + 1]
    eos = {EOS_UID: g[j]}
    return ([(p, mn, t, eos.get(u)) for u, (p, mn, t) in enumerate(READMIT)],
            golds)


def run(engine_cls, request_cls, model, params, slots, sched, **kw):
    eng = engine_cls(model, params, slots=slots, max_seq=MAX_SEQ, **kw)
    pending = sorted(enumerate(sched), key=lambda x: x[1][2])
    tick, busy, peak = 0, True, 0
    while busy or pending:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _, *eos) = pending.pop(0)
            eng.submit(request_cls(uid, prompt, max_new,
                                   eos_token=eos[0] if eos else None))
        busy = eng.tick()
        peak = max(peak, len(getattr(eng, "_inflight", ())))
        tick += 1
    return eng, {r.uid: r.out_tokens for r in eng.done}, peak


def uniform(mod, cfg_groups=2):
    return mod.uniform_plan(cfg_groups, 2, n_microbatches=2)


LAYOUTS = {
    "mono-dense": (2, {}),
    "mono-paged": (2, {"paged": True, "page_size": 4}),
    "plan-dense": (3, {"plan": True}),
    "plan-paged": (3, {"plan": True, "paged": True, "page_size": 4}),
    "mono-int8": (2, {"paged": True, "page_size": 4, "kv_dtype": "int8"}),
}

_jax_runs = {}


def jax_sync(models, sched, layout):
    """The JAX sync engine's (streams, utilization) for one layout,
    run once."""
    if layout not in _jax_runs:
        jm, jp, _, _ = models
        slots, kw = LAYOUTS[layout]
        kw = dict(kw)
        if kw.pop("plan", False):
            kw["plan"] = JP.lower_serving(uniform(JP), slots=slots, chunk=4)
        eng, got, _ = run(JEngine, JRequest, jm, jp, slots, sched, **kw)
        _jax_runs[layout] = (got, eng.stats()["utilization"])
    return _jax_runs[layout]


def port_run(models, sched, layout, **extra):
    _, _, tm, tp = models
    slots, kw = LAYOUTS[layout]
    kw = dict(kw)
    if kw.pop("plan", False):
        kw["plan"] = TP.lower_serving(uniform(TP), slots=slots, chunk=4)
    return run(ServingEngine, Request, tm, tp, slots, sched, **kw, **extra)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_overlap_streams_match_sync_gold_and_jax_sync_engine(models, sched,
                                                             layout):
    sch, golds = sched
    jgot, _ = jax_sync(models, sch, layout)
    sync_eng, sync_got, _ = port_run(models, sch, layout)
    eng, got, peak = port_run(models, sch, layout, overlap=True)
    assert eng._overlap and not sync_eng._overlap
    assert peak == 1, "no step stayed in flight across a tick"
    assert not eng._inflight
    # retirement lands one tick later: never fewer ticks than sync
    assert eng.ticks >= sync_eng.ticks
    assert len(got) == len(READMIT)
    for uid in range(len(READMIT)):
        assert got[uid] == sync_got[uid], f"{layout} uid={uid}"
        assert got[uid] == jgot[uid], f"{layout} uid={uid}"
        if layout != "mono-int8":       # int8 rounds K/V: JAX int8 only
            assert got[uid] == golds[uid], f"{layout} uid={uid}"
    assert len(got[EOS_UID]) < READMIT[EOS_UID][1]     # the EOS retired it
    st = eng.stats()
    assert st["decode_tokens"] == sync_eng.stats()["decode_tokens"]
    assert st["gen_tokens"] == sum(len(g) for g in golds)
    if eng.paged:
        assert eng._pager.pool.blocks_in_use == 0


@pytest.mark.parametrize("layout", ["mono-dense", "plan-dense",
                                    "plan-paged"])
def test_utilization_integers_match_jax_sync_engine(models, sched, layout):
    """The always-on accumulators count what JAX's count on the same
    schedule: pipeline ticks, per-stage busy ticks and the per-replica
    occupied / dispatched slot-steps."""
    sch, _ = sched
    _, jutil = jax_sync(models, sch, layout)
    eng, _, _ = port_run(models, sch, layout)
    util = eng.stats()["utilization"]
    for key in ("pipeline_ticks", "stage_busy_ticks", "replica_occupancy",
                "stage_bubble_frac", "replica_load_spread"):
        assert util[key] == jutil[key], key
    if layout.startswith("plan"):
        assert util["pipeline_ticks"] > 0 and set(util["stage_busy_ticks"]) \
            == {0, 1}
        assert set(util["replica_occupancy"]) == {0, 1}


_jax_hybrid = {}


def test_hybrid_overlap_matches_sync_gold_and_jax_sync_engine(
        hybrid_models):
    """The jamba hybrid on paged pools (unfused paged decode, mamba state
    dense per slot) under overlap, 2 slots."""
    jm, jp, tm, tp = hybrid_models
    kw = {"paged": True, "page_size": 4}
    if "got" not in _jax_hybrid:
        _, _jax_hybrid["got"], _ = run(JEngine, JRequest, jm, jp, 2,
                                       STAGGERED, **kw)
    _, sync_got, _ = run(ServingEngine, Request, tm, tp, 2, STAGGERED, **kw)
    eng, got, peak = run(ServingEngine, Request, tm, tp, 2, STAGGERED,
                         overlap=True, **kw)
    assert eng._overlap and peak == 1
    for uid, (p, mn, _) in enumerate(STAGGERED):
        assert got[uid] == sync_got[uid] == _jax_hybrid["got"][uid], uid
        assert got[uid] == gold_decode(tm, tp, p, mn, MAX_SEQ), uid


@pytest.mark.parametrize("paged", [False, True])
def test_overlap_with_speculation_runs_sync(models, paged):
    """Speculation needs its drafts on the host every tick: an effective
    speculate forces the sync runtime, whose streams are the gold's."""
    _, _, tm, tp = models
    kw = {"paged": True, "page_size": 4} if paged else {}
    sch = [(p, mn, t) for p, mn, t in SPEC_PROMPTS]
    eng, got, peak = run(ServingEngine, Request, tm, tp, 2, sch,
                         overlap=True, speculate=4, **kw)
    assert not eng._overlap and peak == 0
    assert eng.stats()["spec_steps"] > 0
    for uid, (p, mn, _) in enumerate(sch):
        assert got[uid] == gold_decode(tm, tp, p, mn, MAX_SEQ), uid


def test_overlap_keeps_stats_coherent(models):
    """The phase clock under overlap: host_sync still accrues (the
    delayed drain reads back) and overlays the other phases, every key is
    present, and the token and request accounting holds while steps span
    tick boundaries."""
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, slots=2, max_seq=48, overlap=True)
    for uid in range(3):
        eng.submit(Request(uid, np.arange(1, 5 + uid, dtype=np.int32), 6))
    done = eng.run()
    assert len(done) == 3 and all(len(r.out_tokens) == 6 for r in done)
    st = eng.stats()
    assert st["ticks"] > 0 and st["gen_tokens"] == 18
    # a retiring slot rides one garbage step along, which emits nothing
    assert st["decode_tokens"] == 15 and 0.5 < st["tokens_per_step"] < 1.0
    pt = st["phase_time_s"]
    assert set(pt) == {"admission", "prefill", "decode", "replan", "idle",
                       "host_sync"}
    assert pt["host_sync"] > 0.0
    assert pt["host_sync"] <= pt["admission"] + pt["prefill"] + pt["decode"]
    assert pt["replan"] == 0.0           # no controller, no swap
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
    snap = eng.export_metrics().snapshot()
    assert snap["repro_requests_total"] == 3.0
    assert snap["repro_tokens_generated_total"] == 18.0


@pytest.mark.parametrize("layout", ["mono-paged", "plan-paged"])
def test_drain_inflight_lands_every_step(models, sched, layout):
    """``_drain_inflight`` mid-serve lands every dispatched step and drops
    the device-side token chain; serving then goes on from the host state
    to the same streams."""
    sch, golds = sched
    _, _, tm, tp = models
    slots, kw = LAYOUTS[layout]
    kw = dict(kw)
    if kw.pop("plan", False):
        kw["plan"] = TP.lower_serving(uniform(TP), slots=slots, chunk=4)
    eng = ServingEngine(tm, tp, slots=slots, max_seq=MAX_SEQ, overlap=True,
                        **kw)
    for uid, (p, mn, _, eos) in enumerate(sch):
        eng.submit(Request(uid, p, mn, eos_token=eos))
    drained = 0
    while eng.tick():
        if len(eng._inflight) == 1 and drained < 3:
            eng._drain_inflight()
            assert not eng._inflight and eng._cur_dev is None
            assert eng._cur_known.all()
            drained += 1
    assert drained == 3
    got = {r.uid: r.out_tokens for r in eng.done}
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, uid
