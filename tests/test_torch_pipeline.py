"""The port's SSR pipeline executor, device meshes and ``place_params``
against the JAX package's.

* The stage gathers: ``plan_stage_params`` picks JAX's groups, bit for
  bit, for an uneven plan, and ``stage_params_reshape`` is a uniform
  plan's gather.
* ``run_stack(group_mask=)``: a padded, masked stage equals its plain
  slice (and JAX's masked stage at 1e-5); the mask refuses a cache and a
  tensor off the host.
* The executor against JAX's ``Model.forward`` on the same weights,
  within 1e-4: ``pipeline_forward`` (2 stages on a (2, 2, 2) mesh of
  ``cpu`` slots, M=4), the uneven ``ssr_dse`` and ``evolutionary_search``
  plans of a 3-layer yi-6b and their 2 x 2 rounds, a 1-stage plan at 2
  rounds, and the jamba hybrid (mamba groups in a stage).  JAX's own
  ``plan_forward`` is not the reference: under jax 0.9.0 its stage scan's
  carry fails ``shard_map``'s type check.
* The mesh builders: JAX's error messages, repeated devices, the
  production meshes over ``meta`` devices.
* ``place_params`` without compute: a uniform plan's stages on their
  slots of a [cpu, meta] mesh, an uneven plan replicated on the lead
  device, one device passed through.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import pipeline as JX  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.plan import uniform_plan as j_uniform_plan  # noqa: E402
from repro_torch import pipeline as TX  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import build_graph as t_graph  # noqa: E402
from repro_torch.core import evolutionary_search as t_ea  # noqa: E402
from repro_torch.core import ssr_dse as t_dse  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.plan import lower as t_lower  # noqa: E402
from repro_torch.plan import uniform_plan as t_uniform_plan  # noqa: E402
from repro_torch.plan.serving import place_params  # noqa: E402

TOL = 1e-4          # the JAX executor tests' bound on |logits - forward|
B, S = 8, 32
CPU8 = ["cpu"] * 8


def _models(layers):
    jc = j_reduced(J_REGISTRY["yi-6b"], layers=layers)
    tc = t_reduced(T_REGISTRY["yi-6b"], layers=layers)
    jm = j_build(jc)
    jp = jm.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return jm, jp, t_build(tc, device="cpu"), params_from_numpy(tree, tc,
                                                                "cpu")


@pytest.fixture(scope="module")
def yi2():
    return _models(2)


@pytest.fixture(scope="module")
def yi3():
    return _models(3)


@pytest.fixture(scope="module")
def yi4():
    return _models(4)


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_logits(jm, jp, tokens):
    return np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)})[0])


def _err(got, ref):
    return float(np.max(np.abs(got.detach().numpy() - ref)))


def _uneven_assign(layers, seq=S):
    """The guaranteed-uneven DSE cut: the last layer's nodes on acc 1."""
    cfg = t_reduced(T_REGISTRY["yi-6b"], layers=layers)
    g = t_graph(cfg, TShape("t", seq, B, "prefill"))
    acc_of = (0,) * layers + (1, 1)         # the head's two nodes
    assert len(acc_of) == len(g.nodes)
    _, _, assign = t_dse(g, acc_of, 8, n_batches=2)
    return g, assign


# ---------------------------------------------------------------------------
# stage gathers and the group mask
# ---------------------------------------------------------------------------

def test_plan_stage_params_picks_jax_groups_bit_for_bit(yi4):
    jm, jp, tm, tp = yi4
    g, assign = _uneven_assign(4, seq=16)
    plan = t_lower(assign, g, mesh_devices=8, n_microbatches=4)
    assert [s.n_groups for s in plan.stages] == [3, 1]
    staged = TX.plan_stage_params(tp["stack"], plan)
    ref = JX.plan_stage_params(jp["stack"], plan)
    assert len(staged) == plan.n_stages
    assert all(len(row) == plan.max_groups for row in staged)
    for s in range(plan.n_stages):
        for j in range(plan.max_groups):
            got = staged[s][j]
            want = jax.tree.map(lambda a, s=s, j=j: np.asarray(a[s, j]), ref)
            jax.tree.map(lambda w, t: np.testing.assert_array_equal(
                t.numpy(), w), want, got)
    # the padded entries are the stage's last group itself: no copy
    assert staged[1][1] is staged[1][2] is tp["stack"][3]


def test_stage_params_reshape_is_the_uniform_gather(yi4):
    _, jp, _, tp = yi4
    plan = t_uniform_plan(4, 2, 2)
    ids = [[id(g) for g in row]
           for row in TX.stage_params_reshape(tp["stack"], 2)]
    assert ids == [[id(g) for g in row]
                   for row in TX.plan_stage_params(tp["stack"], plan)]
    ref = JX.stage_params_reshape(jp["stack"], 2)
    for s, row in enumerate(TX.stage_params_reshape(tp["stack"], 2)):
        for j, grp in enumerate(row):
            jax.tree.map(lambda w, t, s=s, j=j: np.testing.assert_array_equal(
                t.numpy(), np.asarray(w[s, j])), ref, grp)
    with pytest.raises(ValueError, match="do not divide"):
        TX.stage_params_reshape(tp["stack"], 3)


def test_masked_padded_stage_equals_plain_slice(yi4):
    jm, jp, tm, tp = yi4
    cfg = tm.cfg
    g, assign = _uneven_assign(4, seq=16)
    plan = t_lower(assign, g, mesh_devices=8)
    staged = TX.plan_stage_params(tp["stack"], plan)
    jstaged = JX.plan_stage_params(jp["stack"], plan)
    mask = plan.group_mask_matrix()
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    for st in plan.stages:
        padded, _, _ = TT.run_stack(staged[st.index], torch.from_numpy(x),
                                    cfg, group_mask=mask[st.index])
        plain, _, _ = TT.run_stack(
            tp["stack"][st.first_group:st.first_group + st.n_groups],
            torch.from_numpy(x), cfg)
        assert torch.equal(padded, plain), st.index
        ref, _, _ = JT.run_stack(
            jax.tree.map(lambda a, i=st.index: a[i], jstaged),
            jnp.asarray(x), jm.cfg, group_mask=jnp.asarray(mask[st.index]))
        assert _err(padded, np.asarray(ref)) < 1e-5, st.index


def test_group_mask_refuses_a_cache_and_a_device_tensor(yi4):
    _, _, tm, tp = yi4
    cfg = tm.cfg
    x = torch.zeros((1, 4, cfg.d_model))
    cache = tm.init_cache(1, 8)
    with pytest.raises(ValueError, match="no cache"):
        TT.run_stack(tp["stack"], x, cfg, cache=cache, cache_index=0,
                     group_mask=[1] * cfg.num_groups)
    with pytest.raises(TypeError, match="host"):
        TT.run_stack(tp["stack"], x, cfg,
                     group_mask=torch.ones(cfg.num_groups, device="meta"))
    with pytest.raises(ValueError, match="entries"):
        TT.run_stack(tp["stack"], x, cfg, group_mask=[1])


def test_dead_groups_launch_nothing(yi4, monkeypatch):
    _, _, tm, tp = yi4
    calls = []
    real = TT.apply_block

    def spy(p, *a, **k):
        calls.append(id(p))
        return real(p, *a, **k)
    monkeypatch.setattr(TT, "apply_block", spy)
    x = torch.zeros((1, 4, tm.cfg.d_model))
    TT.run_stack(tp["stack"], x, tm.cfg, group_mask=np.array([0, 1, 0, 1]))
    assert calls == [id(tp["stack"][1]["b0"]), id(tp["stack"][3]["b0"])]


# ---------------------------------------------------------------------------
# the executor against JAX's Model.forward
# ---------------------------------------------------------------------------

def test_pipeline_forward_matches_jax_forward(yi2):
    jm, jp, tm, tp = yi2
    tokens = _tokens(tm.cfg)
    mesh = TM.make_pipeline_mesh(2, model=2, total=8, devices=CPU8)
    assert mesh.shape == {"stage": 2, "data": 2, "model": 2}
    got = TX.pipeline_forward(tm, tp, {"tokens": tokens}, mesh, n_stages=2,
                              n_microbatches=4)
    assert got.shape == (B, S, tm.cfg.vocab_size)
    assert _err(got, _jax_logits(jm, jp, tokens)) < TOL


def _uneven_plans(layers):
    g, assign = _uneven_assign(layers)
    assert assign.accs[0].chips != assign.accs[1].chips, assign.accs
    ea = t_ea(g, 8, n_acc=2, n_batches=2, n_pop=6, n_child=6, n_iter=3,
              seed=0)
    return {"ea": t_lower(ea.assignment, g, mesh_devices=8,
                          n_microbatches=4),
            "dse": t_lower(assign, g, mesh_devices=8, n_microbatches=4),
            "rounds": t_lower(assign, g, mesh_devices=8, n_microbatches=2,
                              n_rounds=2)}


@pytest.mark.parametrize("name", ["ea", "dse", "rounds"])
def test_uneven_plans_match_jax_forward(name, yi3):
    jm, jp, tm, tp = yi3
    plan = _uneven_plans(3)[name]
    if name != "ea":
        assert [s.n_groups for s in plan.stages] == [2, 1]
        assert not plan.is_uniform
    assert plan.total_microbatches == 4
    tokens = _tokens(tm.cfg)
    mesh = TM.make_plan_mesh(plan, devices=CPU8)
    assert mesh.shape["stage"] == plan.n_stages
    got = TX.plan_forward(tm, tp, {"tokens": tokens}, mesh, plan)
    assert _err(got, _jax_logits(jm, jp, tokens)) < TOL, plan.describe()


def test_one_stage_plan_at_two_rounds(yi4):
    jm, jp, tm, tp = yi4
    g = t_graph(tm.cfg, TShape("t", 16, 8, "prefill"))
    _, _, assign = t_dse(g, (0,) * len(g.nodes), 8, n_batches=2)
    plan = t_lower(assign, g, mesh_devices=1, n_microbatches=2, n_rounds=2)
    assert plan.n_stages == 1 and plan.total_microbatches == 4
    tokens = _tokens(tm.cfg, s=16)
    mesh = TM.make_plan_mesh(plan, devices=["cpu"])
    got = TX.plan_forward(tm, tp, {"tokens": tokens}, mesh, plan)
    assert _err(got, _jax_logits(jm, jp, tokens)) < TOL


def test_hybrid_plan_matches_jax_forward():
    from test_torch_model import hybrid_configs, numpy_params
    jc, tc = hybrid_configs(layers=16)
    jm = j_build(jc)
    tree = numpy_params(jm, 1)
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(tree, tc, "cpu")
    tokens = _tokens(tc, b=4, s=12)
    ref = _jax_logits(jm, jax.tree.map(jnp.asarray, tree), tokens)
    plan = t_uniform_plan(tc.num_groups, 2, n_microbatches=2)
    assert any(b.mixer == "mamba" for b in tc.block_pattern)
    mesh = TM.make_plan_mesh(plan, devices=["cpu"] * 2)
    got = TX.plan_forward(tm, tp, {"tokens": tokens}, mesh, plan)
    assert _err(got, ref) < TOL


def test_plan_forward_takes_embeds_and_checks_its_contract(yi4):
    jm, jp, tm, tp = yi4
    plan = t_uniform_plan(4, 2, 4)
    mesh = TM.make_plan_mesh(plan, devices=["cpu"] * 2)
    tokens = _tokens(tm.cfg, s=16)
    emb = tm._embed(tp, tokens)
    got = TX.plan_forward(tm, tp, {"embeds": emb}, mesh, plan)
    assert _err(got, _jax_logits(jm, jp, tokens)) < TOL
    with pytest.raises(ValueError, match="not a multiple"):
        TX.plan_forward(tm, tp, {"tokens": tokens[:6]}, mesh, plan)
    with pytest.raises(ValueError, match="tiles"):
        TX.plan_forward(tm, tp, {"tokens": tokens}, mesh,
                        t_uniform_plan(2, 2, 2))


def test_pipeline_runner_shim_equals_the_plan_runner(yi4):
    _, _, tm, tp = yi4
    cfg = tm.cfg
    mesh = TM.make_pipeline_mesh(2, model=1, total=2, devices=["cpu"] * 2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 2, 8, cfg.d_model)).astype(np.float32))
    staged = TX.stage_params_reshape(tp["stack"], 2)
    got = TX.make_pipeline_runner(cfg, mesh, 2, 4)(staged, x)
    plan = t_uniform_plan(4, 2, 4)
    ref = TX.make_plan_runner(cfg, mesh, plan)(
        staged, plan.group_mask_matrix(), x)
    assert torch.equal(got, ref) and got.shape == x.shape
    # each microbatch alone through the whole stack
    for m in range(4):
        y, _, _ = TT.run_stack(tp["stack"], x[m], cfg)
        assert torch.equal(got[m], y)


# ---------------------------------------------------------------------------
# mesh builders
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_pipeline_mesh_error_equals_jax():
    got = _message(lambda: TM.make_pipeline_mesh(
        3, model=16, total=256, devices=["meta"] * 256))
    assert "does not evenly divide" in got
    assert got == _message(lambda: JM.make_pipeline_mesh(3, model=16,
                                                          total=256))


def test_plan_mesh_error_equals_jax():
    g, assign = _uneven_assign(4, seq=16)
    plan = t_lower(assign, g, mesh_devices=8)
    got = _message(lambda: TM.make_plan_mesh(plan, devices=["cpu"]))
    assert "every stage needs" in got
    assert got == _message(lambda: JM.make_plan_mesh(
        plan, devices=jax.devices()[:1]))


def test_plan_mesh_on_repeated_and_many_devices():
    g, assign = _uneven_assign(4, seq=16)
    plan = t_lower(assign, g, mesh_devices=8)
    two = TM.make_plan_mesh(plan, devices=["cpu"] * 2)
    assert two.shape == {"stage": 2, "data": 1, "model": 1}
    assert two.distinct_devices() == [torch.device("cpu")]
    eight = TM.make_plan_mesh(plan, devices=CPU8)
    data, model = plan.mesh_factors(plan.stage_width)
    assert eight.shape == {"stage": 2, "data": data, "model": model}
    assert eight.devices.size == 2 * plan.stage_width
    devs = [torch.device("cpu"), torch.device("meta")] * 5
    odd = TM.make_plan_mesh(plan, devices=devs)      # 10: two left out
    assert odd.devices.size == 8
    assert list(odd.devices.flat) == devs[:8]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_has_jax_axes_and_shape(multi_pod):
    n = 512 if multi_pod else 256
    mesh = TM.make_production_mesh(multi_pod=multi_pod,
                                   devices=["meta"] * n)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert mesh.shape == want and mesh.axis_names == tuple(want)
    assert mesh.devices.size == n
    with pytest.raises(ValueError, match="needs"):
        TM.make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (n - 1))
    stage = TM.make_pipeline_mesh(4, multi_pod=multi_pod,
                                  devices=["meta"] * n)
    assert stage.shape == {"stage": 4, "data": n // 64, "model": 16}


def test_host_mesh_and_local_devices():
    mesh = TM.make_host_mesh(devices=TM.local_devices("cpu"))
    assert mesh.shape == {"data": 1, "model": 1}
    one = TM.make_host_mesh(axes=("data",), devices=["cpu"] * 3)
    assert one.shape == {"data": 3}
    with pytest.raises(ValueError, match="kind"):
        TM.local_devices("tpu")
    assert all(d.type == "cuda" for d in TM.local_devices())


# ---------------------------------------------------------------------------
# place_params
# ---------------------------------------------------------------------------

def _devices_of(tree):
    out = set()
    jax.tree.map(lambda t: out.add(t.device.type), tree)
    return out


def test_place_params_uniform_plan_on_its_slots(yi4):
    _, _, _, tp = yi4
    plan = t_uniform_plan(4, 2, n_microbatches=2)
    placed, mesh = place_params(tp, plan, devices=["cpu", "meta"])
    assert mesh.shape == {"stage": 2, "data": 1, "model": 1}
    assert [_devices_of(g) for g in placed["stack"]] == \
        [{"cpu"}, {"cpu"}, {"meta"}, {"meta"}]
    assert _devices_of({k: v for k, v in placed.items()
                        if k != "stack"}) == {"cpu"}
    # the lead device's leaves are the caller's tensors, not copies
    assert placed["stack"][0]["b0"]["mixer"]["wq"] is \
        tp["stack"][0]["b0"]["mixer"]["wq"]


def test_place_params_replicates_an_uneven_plan(yi4):
    _, _, _, tp = yi4
    g, assign = _uneven_assign(4, seq=16)
    plan = t_lower(assign, g, mesh_devices=8)
    assert not plan.is_uniform
    placed, mesh = place_params(tp, plan, devices=["cpu", "meta"])
    assert mesh is not None and _devices_of(placed) == {"cpu"}


def test_place_params_one_device_passes_through(yi4):
    """Port of test_plan.py::test_place_params_single_device_passthrough,
    with two slots on one device too."""
    _, _, _, tp = yi4
    plan = t_uniform_plan(4, 2, n_microbatches=2)
    for devs in (["cpu"], ["cpu", "cpu"]):
        placed, mesh = place_params(tp, plan, devices=devs)
        assert mesh is None and placed is tp
    jplan = j_uniform_plan(4, 2, n_microbatches=2)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(plan)
