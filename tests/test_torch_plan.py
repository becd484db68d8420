"""The port's plan IR, lowering, validation and stage hooks against the JAX
package's.

* IR and lowering: ``lower``, ``lower_serving``, ``rereplicate_serving``,
  ``realized_assignment`` and ``uniform_plan`` give equal dataclasses,
  field by field, from both copies, for uneven, collapsed (one stage) and
  single-group cuts, and with the spatial width picked by
  ``auto_spatial_width``'s analytic branch; both launchers'
  ``_build_serving_plan`` lower the same plan for ``pipeline:2`` and
  ``hybrid:2``.
* Validation: ``check_roundtrip`` (the chained stage slices against
  ``Model.forward``) within 1e-5 in f32 for uniform and uneven plans;
  ``predict_plan`` equal to JAX's on the default chip, and finite and
  different on the H100; ``auto_spatial_width``'s measured branch picks a
  divisor of the batch (``tests/test_torch_validate.py`` holds the
  measured side against JAX's).
* The stage walk: the port's chained stage slices give JAX's
  ``stage_forward`` chain's logits on bridged weights at 1e-5 (f32), on
  yi-6b and the jamba hybrid.
* The chunked-prefill continuation: the dense branch of
  ``multi_head_attention(attend_cache=True)`` gives JAX's output and cache
  at 1e-5, and ``slice_cache_groups``/``slice_cache_slots`` are views
  (writes through them land in the cache).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as JP  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core import build_graph as j_graph  # noqa: E402
from repro.core import evolutionary_search as j_ea  # noqa: E402
from repro.core import ssr_dse as j_dse  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.plan import validate as JV  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import build_graph as t_graph  # noqa: E402
from repro_torch.core import evolutionary_search as t_ea  # noqa: E402
from repro_torch.core import ssr_dse as t_dse  # noqa: E402
from repro_torch.core.hw import H100  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.plan import validate as TV  # noqa: E402

TOL = 1e-5


def asdict(x):
    return dataclasses.asdict(x)


def yi_configs(layers):
    return (j_reduced(J_REGISTRY["yi-6b"], layers=layers),
            t_reduced(T_REGISTRY["yi-6b"], layers=layers))


def both_graphs(layers=4, shape=("t", 16, 8, "prefill")):
    jc, tc = yi_configs(layers)
    return j_graph(jc, JShape(*shape)), t_graph(tc, TShape(*shape))


def cuts():
    """(name, jax plan, port plan) for the uneven, collapsed and
    single-group cuts, and a spatial width picked analytically."""
    jg, tg = both_graphs()
    out = []
    # uneven: the guaranteed-uneven DSE cut of the JAX serving tests
    _, _, ja = j_dse(jg, (0, 0, 0, 0, 1, 1), 8, n_batches=2)
    _, _, ta = t_dse(tg, (0, 0, 0, 0, 1, 1), 8, n_batches=2)
    out.append(("uneven", JP.lower(ja, jg, mesh_devices=8,
                                   n_microbatches=2),
                TP.lower(ta, tg, mesh_devices=8, n_microbatches=2)))
    # collapsed: the EA's pick on full-width yi-6b is one stage
    jc, tc = J_REGISTRY["yi-6b"], T_REGISTRY["yi-6b"]
    shp = ("serve", 1024, 8, "prefill")
    fg, fh = j_graph(jc, JShape(*shp)), t_graph(tc, TShape(*shp))
    jr = j_ea(fg, 8, n_acc=2, n_batches=2, n_pop=6, n_child=6, n_iter=3,
              seed=0)
    tr = t_ea(fh, 8, n_acc=2, n_batches=2, n_pop=6, n_child=6, n_iter=3,
              seed=0)
    out.append(("collapsed", JP.lower(jr.assignment, fg, mesh_devices=8,
                                      n_microbatches=2),
                TP.lower(tr.assignment, fh, mesh_devices=8,
                         n_microbatches=2)))
    # single group: one layer, one stage
    jg1, tg1 = both_graphs(layers=1)
    _, _, ja1 = j_dse(jg1, (0, 0, 0), 8, n_batches=1)
    _, _, ta1 = t_dse(tg1, (0, 0, 0), 8, n_batches=1)
    out.append(("single-group", JP.lower(ja1, jg1, mesh_devices=8),
                TP.lower(ta1, tg1, mesh_devices=8)))
    # the spatial width from the analytic per-stage times
    out.append(("auto", JP.lower(ja, jg, mesh_devices=8,
                                 n_microbatches="auto"),
                TP.lower(ta, tg, mesh_devices=8, n_microbatches="auto")))
    return out


CUTS = cuts()


@pytest.mark.parametrize("name", [c[0] for c in CUTS])
def test_lowered_plans_equal(name):
    _, jp, tp = next(c for c in CUTS if c[0] == name)
    assert asdict(jp) == asdict(tp)
    assert jp.describe() == tp.describe()
    if name == "uneven":
        assert [s.n_groups for s in tp.stages] == [3, 1]
    if name in ("collapsed", "single-group"):
        assert tp.n_stages == 1
    for slots, chunk in ((2, 4), (3, 16), (4, 128)):
        if slots < tp.n_microbatches:
            continue
        js = JP.lower_serving(jp, slots, chunk=chunk)
        ts = TP.lower_serving(tp, slots, chunk=chunk)
        assert asdict(js) == asdict(ts)
        assert js.describe() == ts.describe() and js.label == ts.label
        assert [js.replica_of_slot(s) for s in range(slots)] == \
            [ts.replica_of_slot(s) for s in range(slots)]
        for r in (1, 2):
            if r <= slots:
                assert asdict(JP.rereplicate_serving(js, r)) == \
                    asdict(TP.rereplicate_serving(ts, r))


@pytest.mark.parametrize("name", ["uneven", "single-group"])
def test_realized_assignment_and_predict_plan_equal(name):
    _, jp, tp = next(c for c in CUTS if c[0] == name)
    jg, tg = both_graphs(layers=1 if name == "single-group" else 4)
    ja = JP.realized_assignment(jp, jg)
    ta = TP.realized_assignment(tp, tg)
    assert ja.acc_of == ta.acc_of
    assert [dataclasses.astuple(a) for a in ja.accs] == \
        [dataclasses.astuple(a) for a in ta.accs]
    jpr = JV.predict_plan(jp, jg)
    tpr = TV.predict_plan(tp, tg)
    assert set(jpr) == set(tpr)
    for k in ("latency_s", "makespan_s", "throughput_tops",
              "padding_waste"):
        assert math.isclose(jpr[k], tpr[k], rel_tol=1e-12, abs_tol=0.0), k
    assert all(math.isclose(a, b, rel_tol=1e-12)
               for a, b in zip(jpr["per_stage_s"], tpr["per_stage_s"]))
    # the port's card: finite, and not the TPU's prediction
    hpr = TV.predict_plan(tp, tg, hw=H100)
    assert all(math.isfinite(hpr[k]) and hpr[k] > 0
               for k in ("latency_s", "makespan_s", "throughput_tops"))
    assert hpr["makespan_s"] != tpr["makespan_s"]


def test_uniform_plans_equal():
    for groups, stages, m in ((4, 2, 2), (4, 4, 1), (6, 3, 3), (1, 1, 1)):
        assert asdict(JP.uniform_plan(groups, stages, n_microbatches=m)) \
            == asdict(TP.uniform_plan(groups, stages, n_microbatches=m))


def test_auto_spatial_width_measured_branch_is_not_ported(yi_models):
    """The measured branch, which raised before ``measure_plan`` was
    ported: each candidate width is timed on the model's device and the
    pick is a divisor of the batch."""
    _, _, tm, tp = yi_models
    _, tg = both_graphs()
    widths = []

    def build(m):
        widths.append(m)
        return TP.uniform_plan(4, 2, n_microbatches=m)
    batch = {"tokens": np.ones((8, 16), np.int32)}
    M = TV.auto_spatial_width(build, tg, measure_with=(tm, tp, batch))
    assert widths == [1, 2, 4, 8] and M in widths


@pytest.mark.parametrize("strategy", ["pipeline:2", "hybrid:2"])
@pytest.mark.parametrize("arch,layers", [("yi-6b", 4), ("yi-6b", 32)])
def test_both_launchers_build_the_same_serving_plan(strategy, arch, layers):
    from repro.launch.serve import _build_serving_plan as j_build_plan
    from repro_torch.launch.serve import _build_serving_plan as t_build_plan
    jc = dataclasses.replace(J_REGISTRY[arch], num_layers=layers)
    tc = dataclasses.replace(T_REGISTRY[arch], num_layers=layers)
    js = j_build_plan(jc, strategy, 4, 2, 128, 1024)
    ts = t_build_plan(tc, strategy, 4, 2, 128, 1024)
    assert asdict(js) == asdict(ts)
    assert js.describe() == ts.describe()
    assert ts.n_stages == 2 and ts.n_replicas == 2
    assert j_build_plan(jc, "mono", 4, 2, 8, 64) is None
    assert t_build_plan(tc, "mono", 4, 2, 8, 64) is None


# ---------------------------------------------------------------------------
# stage walk and round trip on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yi_models():
    jc, tc = yi_configs(4)
    jm = j_build(jc)
    jp = jm.init(jax.random.key(0))
    tm = t_build(tc, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                         "cpu")


@pytest.fixture(scope="module")
def hybrid_models():
    from test_torch_model import hybrid_configs, numpy_params
    jc, tc = hybrid_configs(layers=16)
    jm = j_build(jc)
    tree = numpy_params(jm, 1)
    tm = t_build(tc, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(tree, tc, "cpu"))


def _plans(num_groups):
    out = [("uniform", TP.uniform_plan(num_groups, 2, n_microbatches=2),
            JP.uniform_plan(num_groups, 2, n_microbatches=2))]
    if num_groups == 4:
        _, jp, tp = next(c for c in CUTS if c[0] == "uneven")
        out.append(("uneven", tp, jp))
    return out


def _walk(mod_v, model, params, tokens, plan):
    x = mod_v._embed(model, params, {"tokens": tokens})
    for s in range(plan.n_stages):
        x = mod_v.stage_forward(model, params, x, plan, s)
    return mod_v._finish(model, params, x)


@pytest.mark.parametrize("family", ["yi-6b", "hybrid"])
def test_stage_walk_matches_jax_stage_forward_chain(family, yi_models,
                                                    hybrid_models):
    jm, jp, tm, tp = yi_models if family == "yi-6b" else hybrid_models
    tokens = np.random.default_rng(3).integers(
        1, tm.cfg.vocab_size, (2, 11)).astype(np.int32)
    for name, tplan, jplan in _plans(tm.cfg.num_groups):
        got = _walk(TV, tm, tp, tokens, tplan)
        ref = np.asarray(_walk(JV, jm, jp, jnp.asarray(tokens), jplan))
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL,
                                   err_msg=f"{family} {name}")
        assert TV.check_roundtrip(tm, tp, {"tokens": tokens}, tplan) <= TOL


def test_stage_params_and_cache_slices_are_views(yi_models):
    _, _, tm, tp = yi_models
    plan = next(c for c in CUTS if c[0] == "uneven")[2]
    sl = TV._stage_slice(tp["stack"], plan, 1)
    assert len(sl) == 1 and sl[0] is tp["stack"][3]
    cache = tm.init_cache(4, 16)
    view = TT.slice_cache_groups(cache, 1, 2)
    view["b0"]["kv"]["k"][1, 3, 5].fill_(7.0)        # group 2, slot 3
    assert float(cache["b0"]["kv"]["k"][2, 3, 5].max()) == 7.0
    rep = TT.slice_cache_slots(cache, 2, 2)
    rep["b0"]["kv"]["v"][0, 1, 4].fill_(3.0)         # group 0, slot 3
    assert float(cache["b0"]["kv"]["v"][0, 3, 4].max()) == 3.0
    paged = tm.init_paged_cache(4, 16, page_size=4, num_blocks=8)
    pv = TT.slice_cache_slots(paged, 2, 2)
    assert pv["b0"]["kv"]["k_pages"] is paged["b0"]["kv"]["k_pages"]


# ---------------------------------------------------------------------------
# the dense chunked-prefill continuation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_base,chunk", [(4, 4), (5, 3)])
def test_dense_continuation_chunk_matches_jax(yi_models, pos_base, chunk):
    """A chunk-0 prefill of ``pos_base`` tokens, then a continuation chunk
    attending the ring's rows (unwritten rows masked) and its own keys:
    the output and the cache equal JAX's at 1e-5."""
    jm, jp, tm, tp = yi_models
    cfg_j, cfg_t = jm.cfg, tm.cfg
    W = 32
    rng = np.random.default_rng(pos_base * 10 + chunk)
    x0 = rng.standard_normal((1, pos_base, cfg_t.d_model)).astype(
        np.float32)
    x1 = rng.standard_normal((1, chunk, cfg_t.d_model)).astype(np.float32)
    jpa = jax.tree.map(lambda a: a[0], jp["stack"]["b0"]["mixer"])
    tpa = tp["stack"][0]["b0"]["mixer"]
    shp = (1, W, cfg_t.num_kv_heads, cfg_t.head_dim)
    jcache = {"k": jnp.zeros(shp), "v": jnp.zeros(shp)}
    tcache = {"k": torch.zeros(shp), "v": torch.zeros(shp)}
    _, jcache = JL.multi_head_attention(jpa, jnp.asarray(x0), cfg_j,
                                        kv_cache=jcache, cache_index=0)
    TL.multi_head_attention(tpa, tensor_from_numpy(x0, "cpu"), cfg_t,
                            kv_cache=tcache, cache_index=0)
    jout, jcache = JL.multi_head_attention(
        jpa, jnp.asarray(x1), cfg_j, kv_cache=jcache, cache_index=pos_base,
        attend_cache=True)
    tout, tcache = TL.multi_head_attention(
        tpa, tensor_from_numpy(x1, "cpu"), cfg_t, kv_cache=tcache,
        cache_index=pos_base, attend_cache=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   atol=TOL, rtol=TOL)
    # the continuation is the one-shot prefill's tail
    full = np.concatenate([x0, x1], axis=1)
    ocache = {"k": torch.zeros(shp), "v": torch.zeros(shp)}
    oneshot, _ = TL.multi_head_attention(
        tpa, tensor_from_numpy(full, "cpu"), cfg_t, kv_cache=ocache,
        cache_index=0)
    np.testing.assert_allclose(tout.numpy(), oneshot[:, pos_base:].numpy(),
                               atol=TOL, rtol=TOL)
