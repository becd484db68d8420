"""The port's plan runner one process a mesh rank against the JAX
package's ``Model.forward`` and the port's one-process ``plan_forward``
on the same weights: ranks are CPU processes on gloo (a ``file://``
store under the test's temporary directory), each importing only torch,
numpy and ``repro_torch``; they restore the port's checkpoint of JAX's
weights.  JAX's own ``plan_forward`` is not the reference: under jax
0.9.0 its stage scan's carry fails ``shard_map``'s type check.

Two spawns, started together, several cases a spawn (the ``runs``
fixture, once):
  * 8 ranks on (stage 2, data 2, model 2): yi-6b reduced to 3 layers
    through the uneven (2 | 1) SSR plan lowered at ``mesh_devices=8``,
    M=4; the same assignment at 2 microbatches x 2 rounds; and
    ``pipeline_forward(n_stages=2, n_microbatches=4)`` on yi-6b reduced
    to 2 layers;
  * 4 ranks, four meshes: (2, 1, 2) with one KV head (half a KV head a
    rank: K and V gathered over ``model``), (2, 2, 1) with the jamba
    hybrid (mamba groups data parallel inside a stage), (2, 1, 2) with
    the jamba hybrid again (its mamba stages tensor parallel over
    ``model``), and (2, 2, 1) with yi-6b reduced to 2 layers on FSDP's
    specs (each leaf cut over ``data`` too, gathered a group at a time
    by the model's group index).
Each rank reports what it holds (its stage's groups' shards, the
embedding on stage 0, the norm and head on the last stage), its sends
and their bytes (``stats()``), and rank 0 the logits ``gather_logits``
brought it.

In-process (a stand-in ``DeviceMesh``, no process group): a microbatch
the data axis does not divide raises ValueError, and ``plan_rank_tree``
cuts FSDP's leaves (a group-axis entry as the rank's block of whole
groups).

Tolerances: 1e-4 against JAX's ``Model.forward`` (the executor tests'
bound, ``tests/test_torch_pipeline.py``), 1e-5 against the one-process
``plan_forward`` (the same f32 arithmetic but for the tensor-parallel
sums' order; of the largest |logit| for the hybrid's mamba stages over
``model``, ``PORT_TOL_RELATIVE``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import checkpoint as TCK  # noqa: E402
from repro_torch import pipeline as TX  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import build_graph as t_graph  # noqa: E402
from repro_torch.core import ssr_dse as t_dse  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.plan import lower as t_lower  # noqa: E402
from repro_torch.plan import uniform_plan  # noqa: E402
from repro_torch.sharding import Parallel, axes_view  # noqa: E402
from repro_torch.sharding import param_specs, plan_rank_tree  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
JAX_TOL = 1e-4
PORT_TOL = 1e-5
# of the largest |logit|: the mamba stages over ``model`` add x_proj's
# and out_proj's row-parallel partial sums (1.1e-5 absolute on the CPU)
PORT_TOL_RELATIVE = ("hybrid_tp",)
B, S = 8, 32
HYBRID = "jamba-1.5-large-398b-dense-ffn"

# Each rank runs this (``python -c``), sys.argv = [case, rank, world,
# store, io_dir]; it writes ``{case}_rank{r}.json`` and, on rank 0, the
# gathered logits of each run as ``{case}_{label}.npy``.
WORKER = textwrap.dedent('''
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import sharding as SH
from repro_torch.checkpoint import restore
from repro_torch.configs import REGISTRY, ShapeConfig, reduced
from repro_torch.core import build_graph, ssr_dse
from repro_torch.launch.mesh import (Mesh, device_mesh, init_distributed,
                                     make_pipeline_mesh, make_plan_mesh)
from repro_torch.models import build_model
from repro_torch.pipeline import gather_logits, pipeline_forward, plan_forward
from repro_torch.plan import lower, uniform_plan
from repro_torch.plan.serving import place_params

case, rank, world, store, io = sys.argv[1:6]
rank, world = int(rank), int(world)
CPU = [torch.device("cpu")] * world


def grid(shape):
    return Mesh(np.asarray(CPU, dtype=object).reshape(shape),
                ("stage", "data", "model"))


def model_of(name):
    cfg = {"yi3": reduced(REGISTRY["yi-6b"], layers=3),
           "yi2": reduced(REGISTRY["yi-6b"], layers=2),
           "kv1": reduced(REGISTRY["yi-6b"], layers=2),
           "hybrid": reduced(REGISTRY["%s"], layers=16)}[name]
    if name == "kv1":
        cfg = dataclasses.replace(cfg, num_kv_heads=1)
    m = build_model(cfg, "cpu")
    return m, restore(m.init(torch.Generator().manual_seed(1)),
                      os.path.join(io, name))[0]


def tokens(name):
    return np.load(os.path.join(io, f"tokens_{name}.npy"))


def uneven(cfg, **kw):
    g = build_graph(cfg, ShapeConfig("t", %d, %d, "prefill"))
    _, _, assign = ssr_dse(g, (0,) * cfg.num_layers + (1, 1), 8,
                           n_batches=2)
    return lower(assign, g, mesh_devices=8, **kw)


def shape(t):
    return None if t is None else list(t.shape)


def run(label, model, params, plan, mesh, dm, batch, forward=None,
        fsdp=False):
    par = SH.Parallel(dm, SH.param_specs(params, SH.axes_view(dm),
                                         fsdp=True) if fsdp else None)
    rank_model = model.__class__(model.cfg, "cpu", par)
    tree, none = place_params(params, plan, par=par)
    SH.reset_stats()
    if forward is None:
        got = plan_forward(rank_model, tree, batch, mesh, plan)
    else:
        got = forward(rank_model, tree, batch, mesh)
    st = SH.stats()
    lead = next(iter(batch.values()))
    full = gather_logits(got, par, lead.shape[0], plan.total_microbatches,
                         lead.shape[1], model.cfg.vocab_size)
    if rank == 0:
        np.save(os.path.join(io, f"{case}_{label}.npy"), full.numpy())
    ids = {id(g) for g in tree["stack"]}
    out[label] = dict(
        coords=[par.rank(a) for a in ("stage", "data", "model")],
        keys=sorted(tree), groups=len(tree["stack"]), distinct=len(ids),
        wq=shape(tree["stack"][0]["b0"]["mixer"].get("wq")),
        in_proj=shape(tree["stack"][0]["b0"]["mixer"].get("in_proj")),
        table=shape(tree.get("embed", {}).get("table")),
        head=shape(tree.get("head", {}).get("w")),
        logits=None if got is None else list(got.shape),
        placed_none=none is None, stats=st)


out = {}
if case == "mesh8":
    m3, p3 = model_of("yi3")
    mesh = make_plan_mesh(uneven(m3.cfg, n_microbatches=4), devices=CPU)
    init_distributed(mesh, rank, world, init_method="file://" + store)
    dm = device_mesh(mesh)
    out["mesh"] = list(mesh.devices.shape)
    bt = {"tokens": tokens("yi")}
    run("uneven", m3, p3, uneven(m3.cfg, n_microbatches=4), mesh, dm, bt)
    run("rounds", m3, p3, uneven(m3.cfg, n_microbatches=2, n_rounds=2),
        mesh, dm, bt)
    m2, p2 = model_of("yi2")
    pmesh = make_pipeline_mesh(2, model=2, total=8, devices=CPU)
    run("pipeline", m2, p2, uniform_plan(2, 2, 4), pmesh, dm, bt,
        forward=lambda mod, tree, batch, mesh: pipeline_forward(
            mod, tree, batch, mesh, n_stages=2, n_microbatches=4))
else:
    mesh = grid((2, 1, 2))
    init_distributed(mesh, rank, world, init_method="file://" + store)
    mk, pk = model_of("kv1")
    run("kv1", mk, pk, uniform_plan(2, 2, 4), mesh, device_mesh(mesh),
        {"tokens": tokens("yi")})
    hmesh = grid((2, 2, 1))
    mh, ph = model_of("hybrid")
    run("hybrid", mh, ph, uniform_plan(mh.cfg.num_groups, 2, 2), hmesh,
        device_mesh(hmesh), {"tokens": tokens("hybrid")})
    tmesh = grid((2, 1, 2))
    run("hybrid_tp", mh, ph, uniform_plan(mh.cfg.num_groups, 2, 2), tmesh,
        device_mesh(tmesh), {"tokens": tokens("hybrid")})
    m2, p2 = model_of("yi2")
    run("fsdp", m2, p2, uniform_plan(2, 2, 4), hmesh, device_mesh(hmesh),
        {"tokens": tokens("yi")}, fsdp=True)
with open(os.path.join(io, f"{case}_rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
''' % (HYBRID, S, B))


def start(case, world, io):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    store = os.path.join(io, f"store_{case}")
    return case, io, [subprocess.Popen(
        [sys.executable, "-c", WORKER, case, str(r), str(world), store, io],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(run, timeout=180):
    case, io, procs = run
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rcs = [p.returncode for p in procs]
    assert not any(rcs), (rcs, "\n".join(x[-3000:] for x in logs))
    return [json.load(open(os.path.join(io, f"{case}_rank{r}.json")))
            for r in range(len(procs))]


def _configs():
    """name -> (JAX config, port config), the same numbers."""
    from test_torch_model import hybrid_configs
    out = {"yi3": (j_reduced(J_REGISTRY["yi-6b"], layers=3),
                   t_reduced(T_REGISTRY["yi-6b"], layers=3)),
           "yi2": (j_reduced(J_REGISTRY["yi-6b"], layers=2),
                   t_reduced(T_REGISTRY["yi-6b"], layers=2))}
    out["kv1"] = tuple(dataclasses.replace(c, num_kv_heads=1)
                       for c in out["yi2"])
    out["hybrid"] = hybrid_configs(layers=16)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, once: (rank results by case, references by run)."""
    from test_torch_model import numpy_params
    io = str(tmp_path_factory.mktemp("plan_mesh"))
    rng = np.random.default_rng(0)
    toks = {"yi": rng.integers(1, 256, (B, S)).astype(np.int32),
            "hybrid": rng.integers(1, 256, (4, 12)).astype(np.int32)}
    for name, t in toks.items():
        np.save(os.path.join(io, f"tokens_{name}.npy"), t)
    models = {}
    for name, (jc, tc) in _configs().items():
        jm = j_build(jc)
        tree = numpy_params(jm, 1)
        tp = params_from_numpy(tree, tc, "cpu")
        TCK.save(tp, os.path.join(io, name), 0)
        models[name] = (jm, jax.tree.map(jnp.asarray, tree),
                        t_build(tc, device="cpu"), tp)
    spawns = [start("mesh8", 8, io), start("mesh4", 4, io)]
    refs = {}
    for label, name, tk in (("uneven", "yi3", "yi"), ("pipeline", "yi2", "yi"),
                            ("kv1", "kv1", "yi"),
                            ("hybrid", "hybrid", "hybrid")):
        jm, jp, _, _ = models[name]
        refs[label] = np.asarray(jm.forward(
            jp, {"tokens": jnp.asarray(toks[tk])})[0])
    refs["rounds"] = refs["uneven"]
    refs["hybrid_tp"], refs["fsdp"] = refs["hybrid"], refs["pipeline"]
    cpu8 = ["cpu"] * 8
    _, _, tm, tp = models["yi3"]
    for label, kw in (("uneven", dict(n_microbatches=4)),
                      ("rounds", dict(n_microbatches=2, n_rounds=2))):
        plan = _uneven(tm.cfg, **kw)
        refs[label + "_port"] = TX.plan_forward(
            tm, tp, {"tokens": toks["yi"]}, TM.make_plan_mesh(
                plan, devices=cpu8), plan).numpy()
    _, _, tm, tp = models["yi2"]
    refs["pipeline_port"] = TX.pipeline_forward(
        tm, tp, {"tokens": toks["yi"]},
        TM.make_pipeline_mesh(2, model=2, total=8, devices=cpu8), 2,
        4).numpy()
    for label, name, tk, groups, m in (("kv1", "kv1", "yi", 2, 4),
                                       ("hybrid", "hybrid", "hybrid", 2, 2),
                                       ("fsdp", "yi2", "yi", 2, 4)):
        _, _, tm, tp = models[name]
        refs[label + "_port"] = TX.plan_forward(
            tm, tp, {"tokens": toks[tk]}, TM.make_plan_mesh(
                uniform_plan(groups, 2, m), devices=["cpu"] * 2),
            uniform_plan(groups, 2, m)).numpy()
    refs["hybrid_tp_port"] = refs["hybrid_port"]
    res = {case: finish(run) for case, run in
           zip(("mesh8", "mesh4"), spawns)}
    return res, refs, io


def _uneven(cfg, **kw):
    g = t_graph(cfg, TShape("t", S, B, "prefill"))
    _, _, assign = t_dse(g, (0,) * cfg.num_layers + (1, 1), 8, n_batches=2)
    return t_lower(assign, g, mesh_devices=8, **kw)


def _logits(runs, case, label):
    return np.load(os.path.join(runs[2], f"{case}_{label}.npy"))


def _err(got, want):
    return float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("case,label", [
    ("mesh8", "uneven"), ("mesh8", "rounds"), ("mesh8", "pipeline"),
    ("mesh4", "kv1"), ("mesh4", "hybrid"), ("mesh4", "hybrid_tp"),
    ("mesh4", "fsdp")])
def test_rank_plan_matches_jax_forward_and_the_one_process_plan(
        runs, case, label):
    res, refs, _ = runs
    got = _logits(runs, case, label)
    assert got.shape == refs[label].shape
    assert _err(got, refs[label]) < JAX_TOL, label
    want = refs[label + "_port"]
    scale = float(np.abs(want).max()) if label in PORT_TOL_RELATIVE else 1.0
    assert _err(got, want) < PORT_TOL * scale, label


def test_the_uneven_plan_runs_on_a_2x2x2_mesh(runs):
    plan = _uneven(t_reduced(T_REGISTRY["yi-6b"], layers=3),
                   n_microbatches=4)
    assert [s.n_groups for s in plan.stages] == [2, 1]
    assert plan.mesh_factors() == (2, 2)
    assert all(r["mesh"] == [2, 2, 2] for r in runs[0]["mesh8"])


@pytest.mark.parametrize("case,label", [
    ("mesh8", "uneven"), ("mesh8", "rounds"), ("mesh8", "pipeline"),
    ("mesh4", "kv1"), ("mesh4", "hybrid"), ("mesh4", "hybrid_tp")])
def test_each_rank_holds_its_stage_and_model_shards(runs, case, label):
    """Rank (s, d, m): its stage's groups (padded to the plan's depth,
    the padding sharing its last group), wq's columns over ``model``, the
    vocab-sharded embedding on stage 0 only, the final norm and the
    vocab-sharded head on the last stage only; only the last stage
    returns logits, its rows' full vocabulary."""
    res, refs, _ = runs
    cfgs = _configs()
    name = {"uneven": "yi3", "rounds": "yi3", "pipeline": "yi2",
            "hybrid_tp": "hybrid"}.get(label, label)
    cfg = cfgs[name][1]
    groups = {"uneven": [2, 1], "rounds": [2, 1]}.get(label, [
        cfg.num_groups // 2] * 2)
    for r in res[case]:
        row = r[label]
        s, d, m = row["coords"]
        tp = 2 if case == "mesh8" or label in ("kv1", "hybrid_tp") else 1
        if row["in_proj"]:
            di = cfg.ssm.expand * cfg.d_model
            assert row["in_proj"] == [cfg.d_model, 2 * di // tp]
        assert row["groups"] == max(groups)
        assert row["distinct"] == groups[s]
        assert row["placed_none"]
        want = {"stack"} | ({"embed"} if s == 0 else set()) | (
            {"final_norm", "head"} if s == 1 else set())
        assert set(row["keys"]) == want, row
        if row["wq"]:
            assert row["wq"] == [cfg.d_model,
                                 cfg.num_heads * cfg.head_dim // tp]
        if s == 0:
            assert row["table"] == [cfg.vocab_size // tp, cfg.d_model]
        if s == 1:
            assert row["head"] == [cfg.d_model, cfg.vocab_size // tp]
            rows = refs[label].shape[0] // (2 if case == "mesh8"
                                            or label == "hybrid" else 1)
            assert row["logits"] == [rows, refs[label].shape[1],
                                     cfg.vocab_size]
        else:
            assert row["logits"] is None


@pytest.mark.parametrize("case,label,m", [
    ("mesh8", "uneven", 4), ("mesh8", "rounds", 4), ("mesh8", "pipeline", 4),
    ("mesh4", "kv1", 4), ("mesh4", "hybrid", 2), ("mesh4", "hybrid_tp", 2),
    ("mesh4", "fsdp", 4)])
def test_stages_hand_each_microbatch_on_by_one_send(runs, case, label, m):
    """(S - 1) x M sends a chain of ranks, all from stage 0 here: one a
    microbatch, of its rows' (rows, seq, d_model) f32 activations."""
    res, refs, _ = runs
    cfgs = _configs()
    name = {"uneven": "yi3", "rounds": "yi3", "pipeline": "yi2",
            "hybrid_tp": "hybrid", "fsdp": "yi2"}.get(label, label)
    d_model = cfgs[name][1].d_model
    batch, seq = refs[label].shape[:2]
    dp = 2 if case == "mesh8" or label in ("hybrid", "fsdp") else 1
    for r in res[case]:
        row = r[label]
        sends = row["stats"]["by_op"].get("send", {"ops": 0, "bytes": 0})
        if row["coords"][0] == 0:
            assert sends == {"ops": m, "bytes": batch // dp * seq * d_model
                             * 4}, row
        else:
            assert sends["ops"] == 0


def test_tensor_parallel_ranks_all_reduce_over_model(runs):
    """On (2, 2, 2) each attention and MLP block all-reduces its
    row-parallel output over ``model`` once a microbatch; stage 0 adds
    the vocab-parallel embedding's, the last stage gathers the head's
    logits over ``model`` once."""
    res, _, _ = runs
    for r in res["mesh8"]:
        row = r["uneven"]
        s = row["coords"][0]
        ops = row["stats"]["by_op"]
        layers = [2, 1][s]
        assert ops["all_reduce"]["ops"] == 2 * layers * 4 + (s == 0)
        if s == 1:
            assert ops["all_gather"]["ops"] == 1
        else:
            assert "all_gather" not in ops


# ---------------------------------------------------------------------------
# in process: the refusals, before any collective
# ---------------------------------------------------------------------------

class _StandInMesh:
    """A ``DeviceMesh``'s questions answered for rank 0 of a mesh of the
    given shape over ("stage", "data", "model"), no process group."""
    device_type = "cpu"
    mesh_dim_names = ("stage", "data", "model")

    def __init__(self, shape):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)

    def size(self, i):
        return self.mesh.shape[i]

    def get_local_rank(self, axis):
        return 0

    def get_coordinate(self):
        return (0, 0, 0)


def test_mamba_stages_over_model_gather_and_all_reduce(runs):
    """The hybrid's mamba stages on (2, 1, 2): each mamba layer gathers
    its in_proj output over ``model`` once a microbatch (the rank's
    halves of [xi | z]) and all-reduces twice (x_proj's partial sum,
    out_proj's); the stage's one attention layer and eight FFNs
    all-reduce once each; stage 0 adds the embedding's, the last stage
    the head's gather."""
    res, _, _ = runs
    cfg = _configs()["hybrid"][1]
    mamba = sum(b.mixer == "mamba" for b in cfg.block_pattern)
    per_group = 2 * mamba + 1 + len(cfg.block_pattern)
    for r in res["mesh4"]:
        row = r["hybrid_tp"]
        s = row["coords"][0]
        ops = row["stats"]["by_op"]
        assert ops["all_reduce"]["ops"] == 2 * per_group + (s == 0)
        assert ops["all_gather"]["ops"] == 2 * mamba + (s == 1)
        assert "all_gather_replicated" not in ops


def test_a_microbatch_the_data_axis_does_not_divide_raises():
    tc = t_reduced(T_REGISTRY["yi-6b"], layers=2)
    tm = t_build(tc, device="cpu")
    par = Parallel(_StandInMesh((1, 3, 1)))
    assert (par.tp, par.dp, par.data_axes) == (1, 3, ("data",))
    plan = uniform_plan(2, 1, 2)
    mesh = TM.Mesh(np.asarray([torch.device("cpu")] * 3,
                              dtype=object).reshape(1, 3, 1),
                   ("stage", "data", "model"))
    tokens = np.ones((8, 4), np.int32)
    with pytest.raises(ValueError, match="does not split over 3 data"):
        TX.plan_forward(dataclasses.replace(tm, par=par), {}, {
            "tokens": tokens}, mesh, plan)
    with pytest.raises(ValueError, match="not a multiple"):
        TX.plan_forward(dataclasses.replace(tm, par=par), {}, {
            "tokens": tokens[:5]}, mesh, plan)


def test_fsdp_on_a_plan_mesh_cuts_each_leaf_over_data(runs):
    """FSDP's specs on (2, 2, 1): each rank holds its data block of every
    leaf, and its stage's groups gather theirs a group at a time (one
    all-gather a leaf a group a microbatch); the logits match (the
    parity test above).  In process: a spec that shards the group axis
    gives the rank its block of whole groups of the full stack, every
    group entry the same tensor; without FSDP the tree is the ``model``
    shards, copies of their own."""
    res, _, _ = runs
    cfg = _configs()["yi2"][1]
    for r in res["mesh4"]:
        row = r["fsdp"]
        s = row["coords"][0]
        assert row["wq"] == [cfg.d_model // 2, cfg.num_heads * cfg.head_dim]
        if s == 0:
            assert row["table"] == [cfg.vocab_size, cfg.d_model // 2]
        assert row["stats"]["by_op"]["all_gather"]["ops"] > 4
    tc = t_reduced(T_REGISTRY["yi-6b"], layers=4)
    tp = t_build(tc, device="cpu").init(torch.Generator().manual_seed(0))
    dm = _StandInMesh((1, 2, 2))
    par = Parallel(dm)
    specs = param_specs(tp, axes_view(dm), fsdp=True)
    specs["stack"]["b0"]["norm1"]["scale"] = ("data", None)
    tree = plan_rank_tree(tp, uniform_plan(4, 1, 2), par, specs=specs)
    block = tree["stack"][0]["b0"]["norm1"]["scale"]
    assert block.shape == (2, tc.d_model)
    assert all(g["b0"]["norm1"]["scale"] is block for g in tree["stack"])
    assert torch.equal(block, torch.stack(
        [g["b0"]["norm1"]["scale"] for g in tp["stack"][:2]]))
    assert tree["stack"][1]["b0"]["mixer"]["wq"].shape == (
        tc.d_model // 2, tc.num_heads * tc.head_dim // 2)
    tree = plan_rank_tree(tp, uniform_plan(4, 1, 2), par)
    assert tree["stack"][0]["b0"]["mixer"]["wq"].shape == (
        tc.d_model, tc.num_heads * tc.head_dim // 2)
    assert tree["stack"][0]["b0"]["mixer"]["wq"].data_ptr() != \
        tp["stack"][0]["b0"]["mixer"]["wq"].data_ptr()
