"""The port's serving engine against the JAX engine and its own gold.

The staggered-arrival harness of ``tests/test_serving_parity.py`` runs
through both engines on the same (bridged) weights, for the dense and the
paged cache at 1-3 slots: every request's greedy stream from the port's
engine must equal the JAX engine's stream and the port's isolated one-shot
gold (dense ``Model.prefill`` + dense decode).  A warm-prefix admission
(suffix-only prefill at ``offset > 0``) is held to the same two
references, and the port's copy of ``PagedCacheManager`` must build the
same tables as the JAX package's on the same admit/decode/release
sequence.  Speculative decoding (prompt-lookup drafts, batched greedy
verify, rollback) and int8 pools are held the same way: speculative
streams equal the JAX engine's and, on fp caches, the gold; int8 streams
(with and without speculation) equal the JAX engine's int8 streams; the
paged tables equal the JAX engine's after every tick, rollbacks
included.  All on the CPU, where the kernel front doors take the plain
versions.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.cache import PagedCacheManager as JPager  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import ngram_draft as j_ngram_draft  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import PagedCacheManager as TPager  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import make_serve_step  # noqa: E402
from repro_torch.serving import ngram_draft  # noqa: E402

STAGGERED = [  # (prompt, max_new, submit_after_tick), as the JAX harness
    (np.arange(1, 4, dtype=np.int32), 6, 0),
    (np.arange(5, 14, dtype=np.int32), 8, 0),
    (np.array([9, 8, 7, 6, 5], np.int32), 5, 2),
    (np.array([2, 2], np.int32), 7, 4),
]
WARM_SEED = np.arange(1, 9, dtype=np.int32)          # 2 full 4-token pages
WARM_CASES = [np.concatenate([WARM_SEED, [30, 31]]).astype(np.int32),
              WARM_SEED[:6].copy(), WARM_SEED.copy()]


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_reduced(J_REGISTRY["yi-6b"], layers=1))
    jp = jm.init(jax.random.key(0))
    tcfg = t_reduced(T_REGISTRY["yi-6b"], layers=1)
    tm = t_build(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tm, tp


def gold_decode(model, params, prompt, max_new, max_seq):
    """The port's isolated one-shot greedy decode: dense prefill, then
    lock-step dense decode."""
    logits, cache = model.prefill(params, {"tokens": prompt[None]}, max_seq)
    out = [int(logits[0, -1].argmax())]
    step = make_serve_step(model)
    pos = len(prompt)
    while len(out) < max_new and pos < max_seq - 1:
        nxt, _, cache = step(params, cache,
                             np.array([[out[-1]]], np.int32), pos)
        out.append(int(nxt[0, 0]))
        pos += 1
    return out


def run_staggered(engine_cls, request_cls, model, params, slots,
                  max_seq=64, sched=STAGGERED, **kw):
    eng = engine_cls(model, params, slots=slots, max_seq=max_seq, **kw)
    pending = sorted(enumerate(sched), key=lambda x: x[1][2])
    tick, busy = 0, True
    while busy or pending:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _) = pending.pop(0)
            eng.submit(request_cls(uid, prompt, max_new))
        busy = eng.tick()
        tick += 1
    return eng, {r.uid: r.out_tokens for r in eng.done}


@pytest.fixture(scope="module")
def golds(models):
    _, _, tm, tp = models
    return [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in STAGGERED]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("slots", [1, 2, 3])
def test_staggered_streams_match_jax_engine_and_gold(models, golds, paged,
                                                     slots):
    jm, jp, tm, tp = models
    kw = {"paged": True, "page_size": 4} if paged else {}
    _, jgot = run_staggered(JEngine, JRequest, jm, jp, slots, **kw)
    eng, got = run_staggered(ServingEngine, Request, tm, tp, slots, **kw)
    assert eng.cache_stats()["layout"] == ("paged" if paged else "dense")
    assert eng.prefill_batch_sizes == [1] * len(STAGGERED)
    assert len(got) == len(STAGGERED)
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"paged={paged} slots={slots} uid={uid}"
        assert got[uid] == jgot[uid], f"paged={paged} slots={slots} uid={uid}"


def _warm_run(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, slots=2, max_seq=64, paged=True,
                     page_size=4, prefill_bucket=4, **kw)
    eng.submit(request_cls(99, WARM_SEED.copy(), 4))
    eng.run()                          # the seed retires: its blocks park
    eng.reset_stats()
    for uid, p in enumerate(WARM_CASES):
        eng.submit(request_cls(uid, p.copy(), 6))
    return eng, {r.uid: r.out_tokens for r in eng.run()}


def test_warm_prefix_admission_matches_jax_engine_and_gold(models):
    jm, jp, tm, tp = models
    _, jgot = _warm_run(JEngine, JRequest, jm, jp)
    eng, got = _warm_run(ServingEngine, Request, tm, tp)
    st = eng.cache_stats()
    assert st["prefill_compute_hits"] == len(WARM_CASES)
    assert st["reused_prefill_tokens"] == 8 + 5 + 7     # offsets > 0
    for uid, p in enumerate(WARM_CASES):
        assert got[uid] == gold_decode(tm, tp, p, 6, 64), f"warm {uid}"
        assert got[uid] == jgot[uid], f"warm {uid}"


def test_paged_cache_manager_builds_the_jax_tables():
    """Same admit / commit / decode / release sequence -> same tables,
    admission plans and pool counters as the JAX package's manager."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 50, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(1, 50, n)]).astype(
        np.int32) for n in (3, 5, 2)]
    mgrs = [cls(2, 32, 4, 12, prefix_cache=True) for cls in (JPager, TPager)]
    trace = [[], []]
    for i, mgr in enumerate(mgrs):
        for uid, p in enumerate(prompts):
            slot = uid % 2
            if uid >= 2:
                mgr.release_slot(slot)
            ap = mgr.admit(slot, p, 6, reuse_compute=True)
            trace[i].append((ap.reused_tokens, ap.block_table.tolist(),
                             ap.write_table.tolist()))
            mgr.commit(slot)
            pos = len(p)
            for t in range(5):
                cow = mgr.prepare_decode(slot, pos)
                trace[i].append(("cow", cow))
                mgr.note_written(slot, int(p[-1]) + t, pos)
                pos += 1
            trace[i].append(mgr.table_matrix().tolist())
        trace[i].append(mgr.stats())
    assert trace[0] == trace[1]


def test_stats_report_the_plain_kernel_path_and_phases(models):
    _, _, tm, tp = models
    eng, _ = run_staggered(ServingEngine, Request, tm, tp, 2, paged=True,
                           page_size=4)
    st = eng.stats()
    assert st["kernel_path"] == "cpu-plain"
    assert st["requests"] == len(STAGGERED)
    assert st["gen_tokens"] == sum(mn for _, mn, _ in STAGGERED)
    assert set(st["phase_time_s"]) == {"admission", "prefill", "decode",
                                       "idle", "host_sync"}
    assert st["cache"]["layout"] == "paged"


@pytest.mark.parametrize("feature", [
    {"plan": object()}, {"overlap": True}, {"adapt": object()},
    {"trace": True}])
def test_unported_engine_features_raise(models, feature):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError):
        ServingEngine(tm, tp, slots=2, max_seq=32, **feature)


# ---------------------------------------------------------------------------
# speculative decoding and int8 pools
# ---------------------------------------------------------------------------

SPEC_PROMPTS = [  # repetitive prompts so the n-gram drafter engages
    (np.array([5, 6, 7, 5, 6, 7, 5, 6], np.int32), 12, 0),
    (np.array([1, 2, 1, 2, 1, 2, 1], np.int32), 12, 0),
    (np.array([9, 8, 9, 8, 9, 8], np.int32), 10, 2),
    (np.array([3, 3, 3, 3, 3], np.int32), 8, 3),
]


@pytest.fixture(scope="module")
def spec_golds(models):
    _, _, tm, tp = models
    return [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in SPEC_PROMPTS]


def run_lockstep(jeng, teng, sched):
    """Drive the JAX and the port engine tick by tick through one
    schedule; paged tables must agree after every tick (allocation,
    copy-on-write and speculative rollback alike).  Returns both
    engines' streams."""
    pending = sorted(enumerate(sched), key=lambda x: x[1][2])
    tick, busy = 0, True
    while busy or pending:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _) = pending.pop(0)
            jeng.submit(JRequest(uid, prompt, max_new))
            teng.submit(Request(uid, prompt, max_new))
        busy = teng.tick()
        assert jeng.tick() == busy, f"tick {tick}"
        if teng.paged:
            np.testing.assert_array_equal(
                teng._pager.table_matrix(), jeng._pager.table_matrix(),
                err_msg=f"tick {tick}")
        tick += 1
    return ({r.uid: r.out_tokens for r in jeng.done},
            {r.uid: r.out_tokens for r in teng.done})


def _engines(models, slots, **kw):
    jm, jp, tm, tp = models
    return (JEngine(jm, jp, slots=slots, max_seq=64, **kw),
            ServingEngine(tm, tp, slots=slots, max_seq=64, **kw))


SPEC_CASES = [(False, 2, 2), (False, 4, 3), (True, 2, 2), (True, 4, 2),
              (True, 4, 1), (True, 4, 3)]


@pytest.mark.parametrize("paged,speculate,slots", SPEC_CASES)
def test_speculative_streams_match_jax_engine_and_gold(
        models, spec_golds, paged, speculate, slots):
    kw = {"paged": True, "page_size": 4} if paged else {}
    jeng, teng = _engines(models, slots, speculate=speculate, **kw)
    jgot, got = run_lockstep(jeng, teng, SPEC_PROMPTS)
    for uid, gold in enumerate(spec_golds):
        assert got[uid] == gold, f"uid={uid}"
        assert got[uid] == jgot[uid], f"uid={uid}"
    st_, jst = teng.stats(), jeng.stats()
    assert st_["spec_steps"] > 0 and st_["spec_accepted"] > 0
    assert st_["tokens_per_step"] > 1.0
    for key in ("spec_steps", "spec_proposed", "spec_accepted",
                "acceptance_rate", "tokens_per_step", "decode_steps",
                "decode_tokens"):
        assert st_[key] == jst[key], key
    assert st_["spec_acceptance_rate"] == \
        jst["utilization"]["spec_acceptance_rate"]
    if paged:
        assert teng._pager.pool.blocks_in_use == 0    # rollbacks released


@pytest.mark.parametrize("speculate,slots", [(0, 1), (0, 3), (2, 2),
                                             (4, 1), (4, 3)])
def test_int8_streams_match_jax_engine(models, speculate, slots):
    """int8 pools, with and without speculation: the same streams, stats
    and tables as the JAX engine's int8 run; the first token comes from
    the prefill logits, before any dequantized read, so it equals the
    fp gold's."""
    jeng, teng = _engines(models, slots, paged=True, page_size=4,
                          kv_dtype="int8", speculate=speculate)
    jgot, got = run_lockstep(jeng, teng, SPEC_PROMPTS)
    assert got == jgot
    _, _, tm, tp = models
    for uid, (p, mn, _) in enumerate(SPEC_PROMPTS):
        assert got[uid][0] == gold_decode(tm, tp, p, 1, 64)[0]
    st_, jst = teng.stats(), jeng.stats()
    assert st_["cache"]["kv_dtype"] == "int8"
    assert st_["cache"]["kv_capacity_x"] == jst["cache"]["kv_capacity_x"]
    assert st_["cache"]["kv_capacity_x"] == pytest.approx(4 * 16 / 20)
    assert st_["spec_steps"] == jst["spec_steps"]
    assert (st_["spec_steps"] > 0) == (speculate > 0)
    assert teng._cache["b0"]["kv"]["k_pages"].dtype == torch.int8


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_warm_prefix_admission_with_speculation_matches_jax(models,
                                                            kv_dtype):
    jm, jp, tm, tp = models
    kw = dict(kv_dtype=kv_dtype, speculate=4)
    _, jgot = _warm_run(JEngine, JRequest, jm, jp, **kw)
    eng, got = _warm_run(ServingEngine, Request, tm, tp, **kw)
    assert eng.cache_stats()["prefill_compute_hits"] == len(WARM_CASES)
    assert got == jgot
    if kv_dtype == "fp":
        for uid, p in enumerate(WARM_CASES):
            assert got[uid] == gold_decode(tm, tp, p, 6, 64), f"warm {uid}"


COW_SEED = np.array([5, 6, 7, 5, 6, 7, 5, 6], np.int32)
COW_SCHED = [(np.array([1, 2, 1, 2, 1, 2, 1], np.int32), 24, 0),
             (COW_SEED[:7].copy(), 8, 1)]


def _cow_run(engine_cls, request_cls, model, params, kv_dtype, log=None):
    eng = engine_cls(model, params, slots=2, max_seq=64, paged=True,
                     page_size=4, prefill_bucket=4, speculate=4,
                     kv_dtype=kv_dtype)
    eng.submit(request_cls(99, COW_SEED.copy(), 4))
    eng.run()                       # the seed retires: its pages park
    eng.reset_stats()
    if log is not None:
        inner, prep = eng._pager.prepare_decode, eng._prepare_verify_writes
        in_verify = []

        def prepare_decode(slot, pos):
            cow = inner(slot, pos)
            if cow is not None:
                log.append((slot, pos, bool(in_verify)))
            return cow

        def prepare_verify_writes(sw):
            in_verify.append(True)
            prep(sw)
            in_verify.pop()

        eng._pager.prepare_decode = prepare_decode
        eng._prepare_verify_writes = prepare_verify_writes
    pending = list(enumerate(COW_SCHED))
    tick, busy = 0, True
    while busy or pending:
        while pending and pending[0][1][2] <= tick:
            uid, (prompt, max_new, _) = pending.pop(0)
            eng.submit(request_cls(uid, prompt, max_new))
        busy = eng.tick()
        tick += 1
    return eng, {r.uid: r.out_tokens for r in eng.done}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_verify_window_copies_on_write_a_shared_page(models, kv_dtype):
    """Request 1's prompt shares the seed's first page and 3 rows of its
    second: its first decode position (7) is the LAST row of that shared
    page, and the tick that writes it is a verify (request 0 drafts), so
    the window copies the page on write at its first position and runs
    on into a fresh page.  Streams equal the JAX engine's (and the gold
    on fp), and so do the copy-on-write counts."""
    jm, jp, tm, tp = models
    log = []
    jeng, jgot = _cow_run(JEngine, JRequest, jm, jp, kv_dtype)
    eng, got = _cow_run(ServingEngine, Request, tm, tp, kv_dtype, log)
    assert log == [(1, 7, True)]       # the premise: COW inside a verify
    assert 7 % 4 == 3
    assert got == jgot
    assert eng.cache_stats()["cow_copies"] == \
        jeng.cache_stats()["cow_copies"] == 1
    if kv_dtype == "fp":
        for uid, (p, mn, _) in enumerate(COW_SCHED):
            assert got[uid] == gold_decode(tm, tp, p, mn, 64), uid


def test_kv_dtype_validation(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(tm, tp, slots=2, max_seq=48, paged=True,
                      kv_dtype="int4")
    with pytest.raises(ValueError, match="paged=True"):
        ServingEngine(tm, tp, slots=2, max_seq=48, kv_dtype="int8")


@settings(max_examples=60, deadline=None)
@given(ctx=st.lists(st.integers(0, 4), min_size=0, max_size=24),
       k=st.integers(0, 5), max_ngram=st.integers(1, 4))
def test_ngram_draft_matches_jax(ctx, k, max_ngram):
    arr = np.asarray(ctx, np.int32)
    assert ngram_draft(arr, k, max_ngram) == j_ngram_draft(arr, k,
                                                           max_ngram)
