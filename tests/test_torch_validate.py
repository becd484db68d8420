"""The measured side of the port's plan validation against the JAX
package's, on the same plans and bridged weights.

``measure_plan``, ``measure_serving_stage_times``,
``measure_mono_step_times`` and ``measured_design_points`` run in both
packages: the result keys, the stage and replica counts, the design
points' strategy, width and source, and the f32 round-trip error
(< 1e-4, as ``tests/test_plan.py`` requires of JAX) are compared; times
are never compared (the CPU's are no device's, and the two packages run
different code).  ``auto_spatial_width`` and ``lower`` with
``n_microbatches="auto"`` pick, from measured times, a divisor that
respects ``n_rounds``, and refuse a bad ``n_rounds`` with JAX's message.
The timing helper drains the device around the clock and keeps one
warmup call outside it.
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
from repro.core import ssr_dse as j_dse  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.plan import validate as JV  # noqa: E402
from repro.serving import adaptive as JA  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import build_graph as t_graph  # noqa: E402
from repro_torch.core import ssr_dse as t_dse  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.plan import validate as TV  # noqa: E402
from repro_torch.serving import adaptive as TA  # noqa: E402

SHAPE = ("t", 16, 8, "prefill")
MAX_SEQ = 64


@pytest.fixture(scope="module")
def setup():
    """Both packages' reduced yi-6b (4 layers, f32) on the same weights,
    the graph of an 8 x 16 batch and its uneven DSE cut lowered at M=2."""
    jc = j_reduced(J_REGISTRY["yi-6b"], layers=4)
    tc = t_reduced(T_REGISTRY["yi-6b"], layers=4)
    jm = j_build(jc)
    jp = jm.init(jax.random.key(0))
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    jg, tg = j_graph(jc, JShape(*SHAPE)), t_graph(tc, TShape(*SHAPE))
    _, _, ja = j_dse(jg, (0, 0, 0, 0, 1, 1), 8, n_batches=2)
    _, _, ta = t_dse(tg, (0, 0, 0, 0, 1, 1), 8, n_batches=2)
    jplan = JP.lower(ja, jg, mesh_devices=8, n_microbatches=2)
    tplan = TP.lower(ta, tg, mesh_devices=8, n_microbatches=2)
    tokens = np.ones((8, 16), np.int32)
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jg=jg, tg=tg, jplan=jplan,
                tplan=tplan, jbatch={"tokens": jax.numpy.asarray(tokens)},
                tbatch={"tokens": tokens}, ta=ta)


_jax = {}


def jax_once(key, fn):
    if key not in _jax:
        _jax[key] = fn()
    return _jax[key]


def test_measure_plan_matches_jax(setup):
    s = setup
    jm = jax_once("measure_plan", lambda: JV.measure_plan(
        s["jm"], s["jp"], s["jbatch"], s["jplan"], repeat=1))
    tm = TV.measure_plan(s["tm"], s["tp"], s["tbatch"], s["tplan"],
                         repeat=1)
    assert set(tm) == set(jm)
    for key in ("n_stages", "n_microbatches"):
        assert tm[key] == jm[key] == getattr(
            s["tplan"], "total_microbatches" if key == "n_microbatches"
            else key)
    assert len(tm["per_stage_s"]) == len(jm["per_stage_s"]) == 2
    assert all(t > 0 for t in tm["per_stage_s"])
    assert tm["makespan_s"] >= tm["latency_s"] > 0
    assert tm["tokens_per_s"] > 0
    assert tm["max_abs_err"] < 1e-4 and jm["max_abs_err"] < 1e-4
    assert tm["backend"] == "cpu-plain"
    assert "max_abs_err" not in TV.measure_plan(
        s["tm"], s["tp"], s["tbatch"], s["tplan"], repeat=1, check=False)


@pytest.mark.parametrize("slots,replicas", [(3, 2), (2, 1)])
def test_measure_serving_stage_times_matches_jax(setup, slots, replicas):
    """The serving units of a 2-stage plan with uneven replica widths
    ([2, 1]) and with one replica: the same keys and list lengths as
    JAX's; a runtime passed in is used."""
    s = setup
    jsp = JP.lower_serving(JP.uniform_plan(4, 2, n_microbatches=replicas),
                           slots=slots, chunk=4)
    tsp = TP.lower_serving(TP.uniform_plan(4, 2, n_microbatches=replicas),
                           slots=slots, chunk=4)
    jt = jax_once(("serving", slots), lambda: JV.measure_serving_stage_times(
        s["jm"], s["jp"], jsp, MAX_SEQ, repeat=1))
    from repro_torch.plan.serving import PlanRuntime
    rt = PlanRuntime(s["tm"], tsp, MAX_SEQ)
    calls = []
    walk = rt.walk
    rt.walk = lambda *a, **k: calls.append(a[1]) or walk(*a, **k)
    tt = TV.measure_serving_stage_times(s["tm"], s["tp"], tsp, MAX_SEQ,
                                        runtime=rt, repeat=1)
    assert set(tt) == set(jt)
    assert len(tt["stage_s"]) == len(jt["stage_s"]) == tsp.n_stages
    assert len(tt["decode_step_s"]) == len(jt["decode_step_s"]) == replicas
    for key in ("chunk", "n_stages", "n_replicas"):
        assert tt[key] == jt[key]
    assert all(t > 0 for t in tt["stage_s"] + tt["decode_step_s"])
    # one warmup and one timed call per distinct replica width, each on
    # a throwaway cache of that width
    widths = sorted(set(tsp.replica_slots))
    assert sorted({next(iter(c["b0"]["kv"].values())).shape[1]
                   for c in calls}) == widths
    assert len(calls) == 2 * len(widths)


def test_measure_mono_step_times_matches_jax(setup):
    s = setup
    jt = jax_once("mono", lambda: JA.measure_mono_step_times(
        s["jm"], s["jp"], 2, MAX_SEQ, repeat=1))
    tt = TA.measure_mono_step_times(s["tm"], s["tp"], 2, MAX_SEQ, repeat=1)
    assert set(tt) == set(jt)
    assert tt["prefill_tok_s"] > 0 and tt["decode_step_s"] > 0


def test_measured_design_points_match_jax(setup):
    """A 1-stage and the uneven 2-stage plan: strategy, accelerators,
    batches and source as JAX's, positive latency and throughput."""
    s = setup
    jplans = [JP.uniform_plan(4, 1, n_microbatches=1), s["jplan"]]
    tplans = [TP.uniform_plan(4, 1, n_microbatches=1), s["tplan"]]
    jpts = jax_once("points", lambda: JV.measured_design_points(
        s["jm"], s["jp"], s["jbatch"], s["jg"], jplans, repeat=1))
    tpts = TV.measured_design_points(s["tm"], s["tp"], s["tbatch"], s["tg"],
                                     tplans, repeat=1)
    for jpt, tpt in zip(jpts, tpts, strict=True):
        for key in ("strategy", "n_acc", "n_batches", "source"):
            assert getattr(tpt, key) == getattr(jpt, key), key
        assert tpt.latency > 0 and tpt.throughput_tops > 0
        assert tpt.detail.startswith("measured on cpu-plain; err=")
    assert [p.strategy for p in tpts] == ["sequential", "hybrid"]


def test_lower_auto_microbatches_measured(setup):
    """``lower(n_microbatches="auto", measure_with=...)``: a measured pick
    that divides the batch, with ``n_rounds`` respected, and JAX's
    message for rounds that no width can satisfy."""
    s = setup
    plan = TP.lower(s["ta"], s["tg"], mesh_devices=8, n_microbatches="auto",
                    measure_with=(s["tm"], s["tp"], s["tbatch"]))
    assert 1 <= plan.n_microbatches <= 8 and 8 % plan.n_microbatches == 0
    plan2 = TP.lower(s["ta"], s["tg"], mesh_devices=8,
                     n_microbatches="auto", n_rounds=2,
                     measure_with=(s["tm"], s["tp"], s["tbatch"]))
    assert 8 % (plan2.n_microbatches * 2) == 0
    msgs = []
    for mod, a, g in ((JP, None, s["jg"]), (TP, s["ta"], s["tg"])):
        if a is None:
            _, _, a = j_dse(g, (0, 0, 0, 0, 1, 1), 8, n_batches=2)
        with pytest.raises(ValueError, match="does not divide") as e:
            mod.lower(a, g, mesh_devices=8, n_microbatches="auto",
                      n_rounds=3, measure_with=(None, None, None))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_timed_keeps_the_warmup_outside_the_clock():
    calls = []
    t, out = TV.timed(lambda: calls.append(1) or len(calls), "cpu", 3)
    assert len(calls) == 4 and out == 4 and t >= 0.0
