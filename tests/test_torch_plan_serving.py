"""Plan-driven serving in the port's engine against the JAX plan engine and
the port's one-shot gold.

The staggered harness of ``tests/test_serving_parity.py`` runs through
both engines on the same (bridged) weights with ``plan=lower_serving(...)``:
chunked prefill through the plan's stages and slot-partitioned decode
replicas.  Every request's greedy stream from the port must equal the JAX
plan engine's stream and, on fp caches, the port's isolated one-shot gold;
the per-admission chunk, token and batch counts must equal the JAX
engine's.  Layouts: a uniform 2-stage plan at 2 and 3 slots, the uneven
searched plan ([3, 1]), paged replicas, int8 pools, warm-prefix
suffix-only admissions at chunk 4 and 16, speculative replicas (dense and
paged), and the jamba hybrid at 16 layers (2 groups) through a 2-stage
plan, dense and paged.  Every case is held to a JAX run of its own
layout (the same plan, slots, chunk, cache kind and speculation).  A JAX
engine compiles per stage and chunk length (~5-7 s a run on the CPU, ~13 s
for the hybrid), so each JAX layout runs once and is memoized, and so are
the golds.

Beside parity: a replica's decode writes land in the engine's one cache
(replica caches are views), decode never stalls while a long prompt
streams through the stages, a reserved slot riding its replica's decode
cannot touch a shared block, and ``adapt``, ``overlap`` and ``trace``
construct on a plan engine (``tests/test_torch_adaptive.py``,
``tests/test_torch_overlap.py`` and ``tests/test_torch_obs.py`` hold
them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro import plan as JP  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import build_graph as j_graph  # noqa: E402
from repro.core import evolutionary_search as j_ea  # noqa: E402
from repro.core import ssr_dse as j_dse  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import build_graph as t_graph  # noqa: E402
from repro_torch.core import evolutionary_search as t_ea  # noqa: E402
from repro_torch.core import ssr_dse as t_dse  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_serving import (SPEC_PROMPTS, STAGGERED,  # noqa: E402
                                WARM_SEED, gold_decode, run_staggered)


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


def uniform(mod, groups, replicas=2):
    return mod.uniform_plan(groups, 2, n_microbatches=replicas)


def uneven_plans():
    """The JAX harness's uneven searched plan, lowered by both copies."""
    shape = ("t", 16, 8, "prefill")
    out = []
    for mod, reduced, reg, graph, ea, dse, shp in (
            (JP, j_reduced, J_REGISTRY, j_graph, j_ea, j_dse, JShape),
            (TP, t_reduced, T_REGISTRY, t_graph, t_ea, t_dse, TShape)):
        g = graph(reduced(reg["yi-6b"], layers=4), shp(*shape))
        res = ea(g, 8, n_acc=2, n_batches=2, n_pop=6, n_child=6, n_iter=3,
                 seed=1)
        plan = mod.lower(res.assignment, g, mesh_devices=8,
                         n_microbatches=2)
        if plan.is_uniform:
            _, _, assign = dse(g, (0, 0, 0, 0, 1, 1), 8, n_batches=2)
            plan = mod.lower(assign, g, mesh_devices=8, n_microbatches=2)
        out.append(plan)
    return out


def counts(eng):
    return (eng.prefill_chunk_counts, eng.prefill_token_counts,
            eng.prefill_batch_sizes)


_jax_runs = {}


def jax_run(key, jm, jp, plan, *, slots, chunk, sched=STAGGERED, **kw):
    """The JAX plan engine's (streams, counts, stats) for one layout,
    run once."""
    if key not in _jax_runs:
        eng, got = run_staggered(
            JEngine, JRequest, jm, jp, slots, sched=sched,
            plan=JP.lower_serving(plan, slots=slots, chunk=chunk), **kw)
        _jax_runs[key] = (got, counts(eng), eng.stats())
    return _jax_runs[key]


def port_run(tm, tp, plan, *, slots, chunk, sched=STAGGERED, **kw):
    return run_staggered(
        ServingEngine, Request, tm, tp, slots, sched=sched,
        plan=TP.lower_serving(plan, slots=slots, chunk=chunk), **kw)


@pytest.fixture(scope="module")
def golds(models):
    _, _, tm, tp = models
    return [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in STAGGERED]


@pytest.fixture(scope="module")
def hybrid_golds(hybrid_models):
    _, _, tm, tp = hybrid_models
    return [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in STAGGERED]


@pytest.fixture(scope="module")
def spec_golds(models):
    _, _, tm, tp = models
    return [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in SPEC_PROMPTS]


LAYOUTS = {"dense": {}, "paged": {"paged": True, "page_size": 4},
           "int8": {"paged": True, "page_size": 4, "kv_dtype": "int8"}}


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
@pytest.mark.parametrize("slots", [2, 3])
def test_uniform_plan_streams_match_jax_plan_engine_and_gold(
        models, golds, layout, slots):
    jm, jp, tm, tp = models
    jgot, jcounts, jst = jax_run(("uniform", layout, slots), jm, jp,
                                 uniform(JP, 4), slots=slots, chunk=4,
                                 **LAYOUTS[layout])
    eng, got = port_run(tm, tp, uniform(TP, 4), slots=slots, chunk=4,
                        **LAYOUTS[layout])
    assert got == jgot, f"{layout} slots={slots}"
    if layout != "int8":
        for uid, gold in enumerate(golds):
            assert got[uid] == gold, f"{layout} slots={slots} uid={uid}"
    # chunked prefill ran: the 9-token prompt streamed as ceil(9/4) chunks
    assert counts(eng) == jcounts
    assert counts(eng) == ([1, 3, 2, 1], [3, 9, 5, 2], [1, 1, 1, 1])
    st = eng.stats()
    for key in ("plan_label", "plan_stages", "decode_replicas",
                "prefill_chunk", "requests", "gen_tokens"):
        assert st[key] == jst[key], key
    assert st["cache"]["layout"] == ("dense" if layout == "dense"
                                     else "paged")
    if layout == "int8":
        assert eng._cache["b0"]["kv"]["k_pages"].dtype == torch.int8


def test_uneven_searched_plan_streams_match_jax_and_gold(models, golds):
    jm, jp, tm, tp = models
    jplan, tplan = uneven_plans()
    assert [s.n_groups for s in tplan.stages] == [3, 1]
    assert [s.n_groups for s in jplan.stages] == [3, 1]
    jgot, jcounts, _ = jax_run(("uneven",), jm, jp, jplan, slots=3,
                               chunk=4)
    eng, got = port_run(tm, tp, tplan, slots=3, chunk=4)
    assert got == jgot
    assert counts(eng) == jcounts
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"uid={uid}"


def _warm(engine_cls, request_cls, model, params, plan, chunk):
    warm = np.concatenate([WARM_SEED, np.arange(30, 40)]).astype(np.int32)
    eng = engine_cls(model, params, slots=2, max_seq=64, plan=plan,
                     paged=True, page_size=4)
    eng.submit(request_cls(0, WARM_SEED.copy(), 4))
    eng.run()                                  # the seed retires: blocks park
    eng.submit(request_cls(1, warm.copy(), 6))
    return eng, {r.uid: r.out_tokens for r in eng.run()}, warm


@pytest.mark.parametrize("chunk", [4, 16])
def test_warm_prefix_suffix_only_plan_matches_jax_and_gold(models, chunk):
    """A warm admission's 10-token suffix streams through the stages,
    chunked (chunk 4: 3 chunks) or whole (chunk 16), at pos_base 8."""
    jm, jp, tm, tp = models
    jeng, jgot, warm = _warm(JEngine, JRequest, jm, jp, JP.lower_serving(
        uniform(JP, 4, 1), slots=2, chunk=chunk), chunk)
    eng, got, _ = _warm(ServingEngine, Request, tm, tp, TP.lower_serving(
        uniform(TP, 4, 1), slots=2, chunk=chunk), chunk)
    assert got == jgot
    assert got[1] == gold_decode(tm, tp, warm, 6, 64)
    assert counts(eng) == counts(jeng)
    assert eng.prefill_token_counts[-1] == len(warm) - 8
    assert eng.prefill_chunk_counts[-1] == (3 if chunk == 4 else 1)
    pool = eng._pager.pool
    assert pool.prefill_compute_hits == 1
    assert pool.reused_prefill_tokens == 8
    st, jst = eng.cache_stats(), jeng.cache_stats()
    for key in ("prefix_hits", "prefix_queries", "prefill_compute_hits",
                "reused_prefill_tokens", "blocks_in_use"):
        assert st[key] == jst[key], key


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_speculative_plan_replicas_match_jax_and_gold(models, spec_golds,
                                                      layout):
    """Each replica verifies its own (K+1)-token windows."""
    jm, jp, tm, tp = models
    kw = dict(slots=4, chunk=4, sched=SPEC_PROMPTS, speculate=3)
    jgot, jcounts, jst = jax_run(("spec", layout), jm, jp, uniform(JP, 4),
                                 **kw, **LAYOUTS[layout])
    eng, got = port_run(tm, tp, uniform(TP, 4), **kw, **LAYOUTS[layout])
    assert got == jgot
    for uid, gold in enumerate(spec_golds):
        assert got[uid] == gold, f"{layout} uid={uid}"
    st = eng.stats()
    assert st["spec_steps"] > 0 and st["tokens_per_step"] > 1.0
    for key in ("spec_steps", "spec_proposed", "spec_accepted",
                "decode_steps"):
        assert st[key] == jst[key], key
    assert counts(eng) == jcounts


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_hybrid_two_stage_plan_matches_jax_and_gold(hybrid_models,
                                                    hybrid_golds, layout):
    """jamba dense-FFN at 16 layers (2 groups) through a 2-stage plan with
    2 replicas: mamba chunks after the first start from the state the
    previous chunk left, and the rope-free attention decodes per
    replica."""
    jm, jp, tm, tp = hybrid_models
    assert tm.cfg.num_groups == 2
    jgot, jcounts, _ = jax_run(("hybrid", layout), jm, jp, uniform(JP, 2),
                               slots=2, chunk=4, **LAYOUTS[layout])
    eng, got = port_run(tm, tp, uniform(TP, 2), slots=2, chunk=4,
                        **LAYOUTS[layout])
    assert got == jgot
    for uid, gold in enumerate(hybrid_golds):
        assert got[uid] == gold, uid
    assert counts(eng) == jcounts
    assert eng.prefill_chunk_counts == [1, 3, 2, 1]


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------

def test_replica_decode_writes_land_in_the_engine_cache(models):
    """Replica caches are views of the engine's one cache: after a tick,
    the K/V rows a replica's decode step wrote are in ``_cache``."""
    _, _, tm, tp = models
    splan = TP.lower_serving(uniform(TP, 4), slots=4, chunk=4)
    eng = ServingEngine(tm, tp, slots=4, max_seq=32, plan=splan)
    p = np.array([3, 1, 4, 1, 5], np.int32)
    for uid in range(4):
        eng.submit(Request(uid, p + uid, 20))
    for _ in range(20):
        if eng.active == 4:
            break
        eng.tick()
    assert eng.active == 4
    slot = 3                                    # replica 1, local slot 1
    assert splan.replica_of_slot(slot) == (1, 1)
    pos = int(eng._pos[slot])
    k = eng._cache["b0"]["kv"]["k"]             # (groups, slots, W, Hk, D)
    before = k[:, slot, pos].clone()
    assert float(before.abs().max()) == 0.0
    eng.tick()
    assert float(k[:, slot, pos].abs().max()) > 0.0
    view = eng._caches[1]["b0"]["kv"]["k"]
    assert view.data_ptr() == k[:, 2:].data_ptr()
    assert torch.equal(view[:, 1, pos], k[:, slot, pos])


def test_chunked_prefill_never_stalls_decode(models):
    """While a 13-token prompt streams through the stages, the active
    slot emits one token every tick; both streams equal the gold."""
    _, _, tm, tp = models
    p0 = np.array([5, 6, 7], np.int32)
    p1 = np.arange(1, 14, dtype=np.int32)
    eng = ServingEngine(tm, tp, slots=2, max_seq=64, plan=TP.lower_serving(
        uniform(TP, 4, 1), slots=2, chunk=4))
    eng.submit(Request(0, p0, 12))
    while eng._slot_req[0] is None:
        eng.tick()
    eng.submit(Request(1, p1, 6))
    n0 = len(eng._slot_req[0].out_tokens)
    ticks = 0
    while 1 in eng._reserved or eng._slot_req[1] is None:
        eng.tick()
        ticks += 1
        assert len(eng._pf.last_stages_run) <= eng.plan.n_stages
        if eng._slot_req[0] is not None:
            assert len(eng._slot_req[0].out_tokens) == n0 + ticks
    assert ticks > 2
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert done[0] == gold_decode(tm, tp, p0, 12, 64)
    assert done[1] == gold_decode(tm, tp, p1, 6, 64)
    assert eng.prefill_chunk_counts == [1, 4]


def test_reserved_paged_slot_cannot_corrupt_shared_blocks(models):
    """A slot mid-prefill rides its replica's decode with an unmapped
    table row, so its stale write cannot land in the block it shares
    with the other stream."""
    _, _, tm, tp = models
    pa = np.arange(1, 9, dtype=np.int32)
    pb = np.concatenate([pa, [30, 31]]).astype(np.int32)
    eng = ServingEngine(tm, tp, slots=2, max_seq=64, plan=TP.lower_serving(
        uniform(TP, 4, 1), slots=2, chunk=4), paged=True, page_size=4)
    eng.submit(Request(0, pa, 12))
    while eng._slot_req[0] is None:
        eng.tick()
    eng.submit(Request(1, pb, 6))
    pool = eng._pager.pool
    shared = False
    while 1 in eng._reserved or eng._slot_req[1] is None:
        eng.tick()
        if 1 in eng._reserved:
            assert eng._pager.tables[1].n_mapped == 0
            shared |= pool.refcount[eng._pager.tables[0].blocks[0]] == 2
    assert shared
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert done[0] == gold_decode(tm, tp, pa, 12, 64)
    assert done[1] == gold_decode(tm, tp, pb, 6, 64)


def test_plan_engine_contract(models):
    _, _, tm, tp = models
    splan = TP.lower_serving(uniform(TP, 4), slots=2, chunk=4)
    with pytest.raises(ValueError, match="lowered for 2 slots"):
        ServingEngine(tm, tp, slots=3, max_seq=32, plan=splan)
    from repro_torch.serving import AdaptiveConfig
    eng = ServingEngine(tm, tp, slots=2, max_seq=32, plan=splan,
                        adapt=AdaptiveConfig(plans=[None], measure=False))
    assert eng._ctl.cfg.plans == [splan, None]
    eng = ServingEngine(tm, tp, slots=2, max_seq=32, plan=splan,
                        overlap=True, trace=True)
    assert eng._overlap and eng._pf.tracer is eng._tr
    eng = ServingEngine(tm, tp, slots=2, max_seq=32, plan=splan)
    assert eng.prefill_bucket == 1 and len(eng._caches) == 2
    assert eng.stats()["plan_label"] == splan.label
    assert ServingEngine(tm, tp, slots=2, max_seq=32).stats()[
        "plan_label"] == "mono"
