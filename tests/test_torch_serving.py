"""The port's serving engine against the JAX engine and its own gold.

The staggered-arrival harness of ``tests/test_serving_parity.py`` runs
through both engines on the same (bridged) weights, for the dense and the
paged cache at 1-3 slots: every request's greedy stream from the port's
engine must equal the JAX engine's stream and the port's isolated one-shot
gold (dense ``Model.prefill`` + dense decode).  A warm-prefix admission
(suffix-only prefill at ``offset > 0``) is held to the same two
references, and the port's copy of ``PagedCacheManager`` must build the
same tables as the JAX package's on the same admit/decode/release
sequence.  All on the CPU, where the kernel front doors take the plain
versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.cache import PagedCacheManager as JPager  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cache import PagedCacheManager as TPager  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import make_serve_step  # noqa: E402

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
                  max_seq=64, **kw):
    eng = engine_cls(model, params, slots=slots, max_seq=max_seq, **kw)
    pending = sorted(enumerate(STAGGERED), key=lambda x: x[1][2])
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


def _warm_run(engine_cls, request_cls, model, params):
    eng = engine_cls(model, params, slots=2, max_seq=64, paged=True,
                     page_size=4, prefill_bucket=4)
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
    {"plan": object()}, {"speculate": 2}, {"overlap": True},
    {"kv_dtype": "int8", "paged": True}, {"adapt": object()},
    {"trace": True}])
def test_unported_engine_features_raise(models, feature):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError):
        ServingEngine(tm, tp, slots=2, max_seq=32, **feature)
