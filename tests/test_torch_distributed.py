"""The port's sharded training against the JAX package's single-device
step: ranks are CPU processes on gloo (a ``file://`` store under the
test's temporary directory), each importing only torch, numpy and
``repro_torch``; the JAX references run in the test's own process on one
CPU device, on weights that reach the ranks as a JAX checkpoint (which
the port restores, onto a mesh too).

One spawn a mesh, several cases a spawn (the ``runs`` fixture, once):
  * yi-6b reduced on (data=2, model=2): the plain sharded step, FSDP,
    ZeRO-1 moments, FSDP + ZeRO-1 on a batch whose data ranks mask
    different numbers of labels, and FSDP at grad_accum 2 on both
    batches (each rank's block of every global microbatch) -- loss,
    grad_norm and every param (and the ZeRO-1 moments) against
    ``jax.jit(make_train_step(...))`` on the same batch, the FSDP loss
    against ``jax.jit(m.loss)``; each rank's ``SyntheticLM(mesh=)`` rows
    against JAX's global batch; the autograd collectives alone;
  * qwen2-moe reduced on JAX's EP mesh (data=2, model=4): expert
    parallel and tensor parallel inside each expert; Hkv=2 at head_dim 16
    over 4 model ranks puts half a KV head on a rank, and the MoE
    capacity counts the global tokens;
  * (data=1, model=2): the (2, 2) run's params restored onto it and onto
    no mesh, bit-equal, and the JAX checkpoint restored onto it; gemma2's
    tied, softcapped vocab-parallel head there, and jamba's mamba and
    MoE blocks data parallel with FSDP on (2, 1), against ``m.loss``;
  * the sharded launcher: two ranks on (2, 1), then resumed on (1, 2).
The MoE steps' params are held to the port's unsharded step (see
there).
In-process: a cache under ``model`` > 1 (serving) raises
NotImplementedError; every block kind's tensor-parallel training is
``tests/test_torch_tp_blocks.py``'s.

Tolerances, JAX's own (``tests/test_distributed.py``): loss 1e-4,
params after one AdamW step at lr 1e-3 1e-4; grad_norm 1e-5 relative;
the moments 1e-4 of their leaf's largest; restores bit-equal.
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as JCK  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.data import SyntheticLM as JSynth  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import make_train_step as j_train_step  # noqa: E402
from repro_torch import checkpoint as TCK  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import AdamW  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
NORM_RTOL = 1e-5
MOMENT_TOL = 1e-4
B, S = 8, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)

# Each rank runs this (``python -c``), with sys.argv = [case, rank, world,
# store, io_dir]; it writes ``{case}_rank{r}.json`` and checkpoints.
WORKER = textwrap.dedent('''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import sharding as S
from repro_torch.checkpoint import restore, save
from repro_torch.configs import REGISTRY, ShapeConfig, reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import Mesh, device_mesh, init_distributed
from repro_torch.models import build_model
from repro_torch.sharding import placements
from repro_torch.training import (AdamW, init_sharded, make_train_step,
                                  sharded_train_step, zero1_specs)

case, rank, world, store, io = sys.argv[1:6]
rank, world = int(rank), int(world)
SHAPES = {"yi": (2, 2), "moe": (2, 4), "elastic": (1, 2)}
ARCH = {"yi": "yi-6b", "moe": "qwen2-moe-a2.7b", "elastic": "yi-6b"}
shape = SHAPES[case]
mesh = Mesh(np.asarray([torch.device("cpu")] * world,
                       dtype=object).reshape(shape), ("data", "model"))
init_distributed(mesh, rank, world, init_method="file://" + store)
dm = device_mesh(mesh)
view = S.axes_view(dm)
cfg = reduced(REGISTRY[ARCH[case]])
model = build_model(cfg, "cpu")
like = model.init(torch.Generator().manual_seed(0))
jax_ckpt = os.path.join(io, ARCH[case] + "_jax")
params, _ = restore(like, jax_ckpt)
opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
out = {}


def batch(name):
    with np.load(os.path.join(io, name + ".npz")) as f:
        return {k: f[k] for k in f.files}


def run(label, bt, fsdp=False, zero=False, ep=False, accum=1):
    pspecs = S.param_specs(params, view, fsdp=fsdp, expert_parallel=ep)
    ospecs = zero1_specs(pspecs, params, view) if zero else pspecs
    fn = sharded_train_step(make_train_step(model, opt, remat=True,
                                            grad_accum=accum),
                            dm, pspecs, ospecs, S.input_specs_tree(bt, view))
    sp = S.shard_tree(params, pspecs, dm)
    so = init_sharded(opt, sp, ospecs, dm)
    placed = all(list(t.placements) == placements(s, view) for t, s in
                 zip(S.execute.flat(sp).values(),
                     S.execute.flat(pspecs).values()))
    S.reset_stats()
    sp, so, met = fn(sp, so, S.shard_batch(bt, dm, accum))
    stats = S.stats()
    m_placed = all(list(t.placements) == placements(s, view) for t, s in
                   zip(S.execute.flat(so.m).values(),
                       S.execute.flat(ospecs).values()))
    save(sp, os.path.join(io, f"{label}_params"), 1)
    save(so, os.path.join(io, f"{label}_opt"), 1)
    out[label] = dict(loss=float(met["loss"]),
                      grad_norm=float(met["grad_norm"]),
                      params_placed=placed, moments_placed=m_placed,
                      moment_local_shapes={
                          "/".join(k): list(t.to_local().shape)
                          for k, t in S.execute.flat(so.m).items()},
                      collectives=stats)
    return sp


if case == "yi":
    a, b = batch("yi_a"), batch("yi_b")
    run("yi_step", a)
    run("yi_fsdp", a, fsdp=True)
    run("yi_zero1", a, zero=True)
    run("yi_masked", b, fsdp=True, zero=True)
    run("yi_accum", a, fsdp=True, accum=2)
    run("yi_accmask", b, fsdp=True, accum=2)
    # the autograd collectives alone: all-gather and reduce-scatter are
    # each other's transpose, f and g Megatron's pair
    par = S.Parallel(dm)
    x = torch.arange(6.0).reshape(2, 3).add(10 * rank).requires_grad_()
    y = par.all_gather(x, 0, "model")
    (gx,) = torch.autograd.grad((y * y).sum(), x)
    x2 = torch.ones(4, 2).mul(rank + 1).requires_grad_()
    r = par.reduce_scatter(x2, 0, "model")
    (gx2,) = torch.autograd.grad(r.sum() * (par.model_rank + 1), x2)
    w = torch.full((3,), float(rank + 1), requires_grad=True)
    (gf,) = torch.autograd.grad(par.f(w, "model").sum()
                                * (par.model_rank + 1), w)
    gv = par.g(w, "model")
    (gg,) = torch.autograd.grad(gv.sum(), w)
    out["collectives"] = dict(
        gather=y.tolist(), gather_grad=gx.tolist(),
        scatter=r.tolist(), scatter_grad=gx2.tolist(),
        f_grad=gf.tolist(), g=gv.tolist(), g_grad=gg.tolist())
    data = SyntheticLM(cfg, ShapeConfig("t", 16, 8, "train"), mesh=dm)
    np.savez(os.path.join(io, f"rows_rank{rank}.npz"), **data.batch_at(3))
    data = SyntheticLM(cfg, ShapeConfig("t", 16, 8, "train"), mesh=dm,
                       grad_accum=2)
    np.savez(os.path.join(io, f"rows2_rank{rank}.npz"), **data.batch_at(3))
    out["coords"] = [dm.get_local_rank("data"), dm.get_local_rank("model")]
elif case == "moe":
    bt = batch("moe")
    run("moe_ep", bt, ep=True)
    run("moe_tp", bt)
else:
    from repro_torch import tree as TR
    # a tied, softcapped vocab-parallel head (gemma2) on (1, 2), and the
    # hybrid's mamba and MoE blocks data parallel on (2, 1) with FSDP
    for arch, shp, fsdp in (("gemma2-9b", (1, 2), False),
                            ("jamba-1.5-large-398b", (2, 1), True)):
        m2 = Mesh(np.asarray([torch.device("cpu")] * world,
                             dtype=object).reshape(shp), ("data", "model"))
        dm2 = device_mesh(m2)
        v2 = S.axes_view(dm2)
        c2 = reduced(REGISTRY[arch])
        mod2 = build_model(c2, "cpu")
        p2, _ = restore(mod2.init(torch.Generator().manual_seed(0)),
                        os.path.join(io, arch + "_jax"))
        bt = batch(arch)
        ps2 = S.param_specs(p2, v2, fsdp=fsdp)
        fn2 = sharded_train_step(make_train_step(mod2, opt, remat=True),
                                 dm2, ps2, ps2, S.input_specs_tree(bt, v2))
        loss2, _ = fn2.value_and_grad(S.shard_tree(p2, ps2, dm2),
                                      S.shard_batch(bt, dm2))
        out[arch] = float(loss2)
    pspecs = S.param_specs(params, view, fsdp=True)
    tree_like = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    full, _ = restore(tree_like, os.path.join(io, "yi_step_params"))
    onto, _ = restore(tree_like, os.path.join(io, "yi_step_params"),
                      shardings=(pspecs, dm))
    back = S.gather_tree(onto)
    jx = S.gather_tree(restore(tree_like, jax_ckpt,
                               shardings=(pspecs, dm))[0])
    out["elastic"] = dict(
        onto_1x2=all(torch.equal(x, y) for x, y in
                     zip(TR.leaves(back), TR.leaves(full))),
        sharded=all(type(t).__name__ == "DTensor"
                    for t in TR.leaves(onto)),
        jax_onto_1x2=all(torch.equal(x, y) for x, y in
                         zip(TR.leaves(jx), TR.leaves(params))))
with open(os.path.join(io, f"{case}_rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
''')


def start(case, world, io):
    """Start ``WORKER``'s ``case`` on ``world`` rank processes."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    store = os.path.join(io, f"store_{case}")
    return case, io, [subprocess.Popen(
        [sys.executable, "-c", WORKER, case, str(r), str(world), store, io],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(run, timeout=240):
    """Wait for a ``start``ed case; return every rank's results."""
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


def _jax_pair(arch):
    jm = j_build(j_reduced(J_REGISTRY[arch]))
    return jm, jm.init(jax.random.key(0))


def _batch(cfg, seed, mask_rows=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if mask_rows:       # the first data rank's rows mask 33, the second's 0
        labels[:mask_rows, :7] = -1
        labels[0, 7:19] = -1
    return {"tokens": toks, "labels": labels}


def _jax_step(jm, jp, batch, grad_accum=1, fns={}):
    """JAX's jitted step and loss on ``batch`` (one jit a model and
    ``grad_accum``)."""
    key = (id(jm), grad_accum)
    if key not in fns:
        jopt = JAdamW(**OPT)
        fns[key] = (jopt, jax.jit(j_train_step(jm, jopt, remat=False,
                                                grad_accum=grad_accum)),
                    jax.jit(jm.loss))
    jopt, step, loss = fns[key]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p1, st1, met = step(jp, jopt.init(jp), jb)
    return dict(params=p1, opt=st1, loss=float(met["loss"]),
                grad_norm=float(met["grad_norm"]),
                plain_loss=float(loss(jp, jb)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of the module, once: (rank results by case, the JAX
    references, the io directory).  The ranks run while JAX compiles."""
    io = str(tmp_path_factory.mktemp("dist"))
    models, batches = {}, {}
    for arch in ("yi-6b", "qwen2-moe-a2.7b", "gemma2-9b",
                 "jamba-1.5-large-398b"):
        jm, jp = _jax_pair(arch)
        JCK.save(jp, os.path.join(io, f"{arch}_jax"), 0)
        models[arch] = (jm, jp)
    cfg = reduced(T_REGISTRY["yi-6b"])
    batches["yi_a"], batches["yi_b"] = _batch(cfg, 0), _batch(cfg, 1, 3)
    batches["moe"] = _batch(reduced(T_REGISTRY["qwen2-moe-a2.7b"]), 2)
    for arch in ("gemma2-9b", "jamba-1.5-large-398b"):
        batches[arch] = _batch(reduced(T_REGISTRY[arch]), 3, 2)
    for name, bt in batches.items():
        np.savez(os.path.join(io, f"{name}.npz"), **bt)
    yi, moe = start("yi", 4, io), start("moe", 8, io)
    refs = {name: _jax_step(*models["yi-6b"], batches[name])
            for name in ("yi_a", "yi_b")}
    refs["yi_accum"] = _jax_step(*models["yi-6b"], batches["yi_a"], 2)
    refs["yi_accmask"] = _jax_step(*models["yi-6b"], batches["yi_b"], 2)
    # the microbatches of data ranks that each split their own rows
    mixed = [0, 1, 4, 5, 2, 3, 6, 7]
    refs["yi_accmask_mixed"] = _jax_step(
        *models["yi-6b"], {k: v[mixed] for k, v in batches["yi_b"].items()},
        2)
    refs["moe"] = _jax_step(*models["qwen2-moe-a2.7b"], batches["moe"])
    refs["moe_port"] = _port_step(models["qwen2-moe-a2.7b"][1],
                                  "qwen2-moe-a2.7b", batches["moe"])
    refs["yi_params0"] = models["yi-6b"][1]
    res = {"yi": finish(yi)}
    elastic = start("elastic", 2, io)
    for arch in ("gemma2-9b", "jamba-1.5-large-398b"):
        jm, jp = models[arch]
        refs[arch] = float(jax.jit(jm.loss)(
            jp, {k: jnp.asarray(v) for k, v in batches[arch].items()}))
    res["moe"], res["elastic"] = finish(moe), finish(elastic)
    return res, refs, io


def _port(arch):
    cfg = reduced(T_REGISTRY[arch])
    model = build_model(cfg, "cpu")
    return cfg, model.init(torch.Generator().manual_seed(5))


def _restored_params(io, label, arch):
    cfg, like = _port(arch)
    return TCK.restore(like, os.path.join(io, f"{label}_params"))[0]


def _as_port(jparams, arch):
    cfg = reduced(T_REGISTRY[arch])
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _param_err(got, want):
    return max(float((a - b).abs().max())
               for a, b in zip(TR.leaves(got), TR.leaves(want)))


def _port_step(jp, arch, batch):
    """The port's unsharded step on JAX's weights (one process)."""
    from repro_torch.training import make_train_step
    cfg = reduced(T_REGISTRY[arch])
    model, opt = build_model(cfg, "cpu"), AdamW(**OPT)
    tp = _as_port(jp, arch)
    return make_train_step(model, opt, remat=True)(tp, opt.init(tp),
                                                   batch)[0]


def _check_step(runs, label, ref, arch="yi-6b", param_ref=None):
    """Loss and grad_norm against JAX's step; the params against JAX's
    step, or ``param_ref`` (a port param tree)."""
    res, refs, io = runs
    r0 = res[label.split("_")[0]][0][label]
    assert abs(r0["loss"] - refs[ref]["loss"]) <= LOSS_TOL, (r0, ref)
    assert abs(r0["grad_norm"] - refs[ref]["grad_norm"]) \
        <= NORM_RTOL * refs[ref]["grad_norm"]
    want = param_ref if param_ref is not None \
        else _as_port(refs[ref]["params"], arch)
    err = _param_err(_restored_params(io, label, arch), want)
    assert err <= PARAM_TOL, err


def test_sharded_step_matches_jax_on_2x2(runs):
    _check_step(runs, "yi_step", "yi_a")


def test_every_rank_reports_the_global_metrics(runs):
    res, _, _ = runs
    for label in ("yi_step", "yi_fsdp", "yi_zero1", "yi_masked",
                  "yi_accum", "yi_accmask"):
        vals = {(r[label]["loss"], r[label]["grad_norm"]) for r in res["yi"]}
        assert len(vals) == 1, (label, vals)


def test_autograd_collectives_on_two_model_ranks(runs):
    """On (2, 2), the two ranks of one data row (model ranks 0 and 1):
    all-gather concatenates along the dim and reduce-scatters its
    gradient back (2 y = 2 x from both ranks' uses: 4 x); reduce-scatter
    sums and gathers its gradient (the rank's own weight); f's gradient
    sums the ranks' (1 + 2 = 3), g sums forward and passes the gradient
    through."""
    res, _, _ = runs
    for rank, r in enumerate(res["yi"][:2]):
        c = r["collectives"]
        xs = [np.arange(6.0).reshape(2, 3) + 10 * k for k in range(2)]
        np.testing.assert_array_equal(c["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(c["gather_grad"], 4 * xs[rank])
        np.testing.assert_array_equal(c["scatter"], np.full((2, 2), 3.0))
        np.testing.assert_array_equal(
            c["scatter_grad"], np.repeat([[1.0], [2.0]], 2, 0).repeat(2, 1)
            .reshape(4, 2))
        np.testing.assert_array_equal(c["f_grad"], np.full(3, 3.0))
        np.testing.assert_array_equal(c["g"], np.full(3, 3.0))
        np.testing.assert_array_equal(c["g_grad"], np.ones(3))


def test_params_are_dtensors_placed_by_the_specs(runs):
    res, _, _ = runs
    for r in res["yi"] + res["moe"]:
        for label, row in r.items():
            if isinstance(row, dict) and "params_placed" in row:
                assert row["params_placed"] and row["moments_placed"], label


def test_fsdp_loss_matches_jax(runs):
    res, refs, _ = runs
    got = res["yi"][0]["yi_fsdp"]["loss"]
    assert abs(got - refs["yi_a"]["plain_loss"]) <= LOSS_TOL


def test_fsdp_step_matches_jax(runs):
    _check_step(runs, "yi_fsdp", "yi_a")


def test_fsdp_gathers_and_reduce_scatters(runs):
    """FSDP all-gathers the data-sharded leaves in the forward and the
    remat recompute and reduce-scatters their gradients; the plain
    step has no all-gather."""
    res, _, _ = runs
    plain = res["yi"][0]["yi_step"]["collectives"]["by_op"]
    fsdp = res["yi"][0]["yi_fsdp"]["collectives"]["by_op"]
    assert "all_gather" not in plain
    # a gradient reduce-scatter a data-sharded leaf; a gather a use: the
    # groups' leaves twice (the forward and remat's recompute), the
    # embedding table and the head once
    assert fsdp["all_gather"]["ops"] == 2 * fsdp["reduce_scatter"]["ops"] - 2


def test_zero1_moments_placed_as_zero1_specs(runs):
    """ZeRO-1 shards each moment over data where the param is not: the
    stacked (G=2, ...) leaves on their group axis, so a data rank holds
    one group's moments."""
    res, _, _ = runs
    shapes = res["yi"][0]["yi_zero1"]["moment_local_shapes"]
    plain = res["yi"][0]["yi_step"]["moment_local_shapes"]
    assert shapes["stack/b0/mixer/wq"][0] == 1
    assert plain["stack/b0/mixer/wq"][0] == 2
    assert shapes["embed/table"] != plain["embed/table"]


def test_zero1_step_matches_jax(runs):
    _check_step(runs, "yi_zero1", "yi_a")
    res, refs, io = runs
    cfg, like = _port("yi-6b")
    mine = TCK.restore(AdamW(**OPT).init(like),
                       os.path.join(io, "yi_zero1_opt"))[0]
    jst = refs["yi_a"]["opt"]
    theirs = opt_state_from_numpy(
        (np.asarray(jst.step), jax.tree.map(np.asarray, jst.m),
         jax.tree.map(np.asarray, jst.v)), cfg, "cpu")
    assert int(mine.step) == int(theirs.step) == 1
    for a, b in zip(TR.leaves((mine.m, mine.v)),
                    TR.leaves((theirs.m, theirs.v))):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= MOMENT_TOL * max(scale, 1e-30)


def test_microbatches_on_each_rank_match_jax(runs):
    """grad_accum 2 with FSDP: each rank holds its block of every global
    microbatch (``shard_batch(..., grad_accum=2)``) and splits its rows
    as JAX splits the global batch."""
    _check_step(runs, "yi_accum", "yi_accum")


def test_masked_microbatches_match_jax(runs):
    """grad_accum 2 on the masked batch: JAX's first microbatch (rows
    0-3) masks 33 labels, its second none.  Each microbatch's mean counts
    that microbatch's global labels, so a rank's microbatch i must be its
    block of JAX's microbatch i (splitting each rank's contiguous rows
    would mix rows 0, 1, 4, 5 into the first)."""
    _check_step(runs, "yi_accmask", "yi_accmask")
    res, refs, _ = runs
    assert abs(refs["yi_accmask_mixed"]["loss"]
               - refs["yi_accmask"]["loss"]) > LOSS_TOL


def test_masked_mean_is_the_global_one(runs):
    """Data rank 0's rows mask 33 labels, rank 1's none: the loss is the
    global masked mean (JAX's), not the mean of the ranks' means."""
    res, refs, io = runs
    _check_step(runs, "yi_masked", "yi_b")
    assert abs(refs["yi_b"]["loss"] - refs["yi_a"]["loss"]) > 1e-3


def test_grad_norm_counts_a_replicated_leaf_once(runs):
    """Every case's grad_norm equals JAX's: a norm scale replicated over
    both axes counts once, a leaf sharded over model or data sums its
    shards."""
    res, refs, _ = runs
    for label, ref in (("yi_step", "yi_a"), ("yi_fsdp", "yi_a"),
                       ("yi_zero1", "yi_a"), ("yi_masked", "yi_b"),
                       ("moe_ep", "moe"), ("moe_tp", "moe")):
        got = res[label.split("_")[0]][0][label]["grad_norm"]
        assert abs(got - refs[ref]["grad_norm"]) \
            <= NORM_RTOL * refs[ref]["grad_norm"], label


def test_synthetic_rows_are_the_specs_rows_of_jax_batch(runs):
    """``SyntheticLM(mesh=)`` draws JAX's global batch and each rank keeps
    its data block: ranks that differ only on model share rows."""
    res, _, io = runs
    cfg = j_reduced(J_REGISTRY["yi-6b"])
    glob = JSynth(cfg, JShape("t", 16, 8, "train")).batch_at(3)
    for r, out in enumerate(res["yi"]):
        d, _m = out["coords"]
        with np.load(os.path.join(io, f"rows_rank{r}.npz")) as f:
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(f[k],
                                              glob[k][4 * d:4 * d + 4])
        # grad_accum 2: its block of each 4-row microbatch
        rows = [2 * d, 2 * d + 1, 4 + 2 * d, 5 + 2 * d]
        with np.load(os.path.join(io, f"rows2_rank{r}.npz")) as f:
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(f[k], glob[k][rows])


def test_moe_expert_parallel_loss_on_jax_mesh(runs):
    """qwen2-moe on (2, 4) with EP: one expert a model rank, half a KV
    head a rank (all-gathered K/V), the global capacity."""
    res, refs, _ = runs
    got = res["moe"][0]["moe_ep"]["loss"]
    assert abs(got - refs["moe"]["plain_loss"]) <= LOSS_TOL


# The MoE steps' params are held to the port's unsharded step: on this
# batch the unsharded port's params after one AdamW step already differ
# from JAX's by 3.8e-4 on one shared-expert element (AdamW normalizes a
# near-zero gradient element to about lr whatever its size, so f32 noise
# in it moves the update; loss and grad_norm agree to 1e-7 relative).

def test_moe_expert_parallel_step_matches_unsharded(runs):
    _check_step(runs, "moe_ep", "moe", "qwen2-moe-a2.7b",
                param_ref=runs[1]["moe_port"])


def test_moe_tensor_parallel_step_matches_unsharded(runs):
    _check_step(runs, "moe_tp", "moe", "qwen2-moe-a2.7b",
                param_ref=runs[1]["moe_port"])


def test_elastic_restore_onto_another_mesh(runs):
    res, _, _ = runs
    el = res["elastic"][0]["elastic"]
    assert el["sharded"] and el["onto_1x2"]


def test_elastic_restore_onto_no_mesh(runs):
    """The (2, 2) run's checkpoint, written whole by rank 0, restores on
    one process and equals what its ranks gathered."""
    res, refs, io = runs
    got = _restored_params(io, "yi_step", "yi-6b")
    assert all(type(t) is torch.Tensor for t in TR.leaves(got))
    assert _param_err(got, _as_port(refs["yi_a"]["params"], "yi-6b")) \
        <= PARAM_TOL


@pytest.mark.parametrize("arch", ["gemma2-9b", "jamba-1.5-large-398b"])
def test_other_families_sharded_loss_matches_jax(runs, arch):
    """gemma2's tied, softcapped head vocab-parallel on (1, 2) (its
    sliding window and softcaps in the rank's attention), and jamba's
    mamba + MoE period data parallel with FSDP on (2, 1)."""
    res, refs, _ = runs
    assert abs(res["elastic"][0][arch] - refs[arch]) <= LOSS_TOL


def test_jax_checkpoint_restores_onto_a_port_mesh(runs):
    res, _, _ = runs
    assert res["elastic"][0]["elastic"]["jax_onto_1x2"]


def test_sharded_checkpoint_restores_in_jax(runs):
    """The format is unchanged: JAX's restore reads the sharded run's
    checkpoint."""
    res, refs, io = runs
    jp = refs["yi_params0"]
    back, step = JCK.restore(jp, os.path.join(io, "yi_step_params"))
    assert step == 1
    want = jax.tree.map(np.asarray, refs["yi_a"]["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.abs(np.asarray(a) - b).max() <= PARAM_TOL


# ---------------------------------------------------------------------------
# in-process: what stays refused under model > 1
# ---------------------------------------------------------------------------

def _stub_par(tp):
    """What ``run_stack`` reads before any collective."""
    return SimpleNamespace(tp=tp, dp=1, specs=None, model_rank=0,
                           data_axes=("data",),
                           gathered=lambda path, t: t,
                           gather_group=lambda gp, g, stack="stack": gp)


def test_model_axis_refuses_a_cache():
    """Serving under ``par`` (a cache over ``model``) stays refused: the
    sharded forward is the stateless one of training.  Every block kind
    runs tensor parallel (``tests/test_torch_tp_blocks.py``)."""
    cfg = reduced(T_REGISTRY["jamba-1.5-large-398b"])
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="no cache"):
        TT.run_stack(params["stack"], x, cfg, cache=model.init_cache(1, 8),
                     cache_index=0, par=_stub_par(2))


@pytest.mark.parametrize("accum,want", [
    (1, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (2, [[0, 1, 4, 5], [2, 3, 6, 7]]),
    (4, [[0, 2, 4, 6], [1, 3, 5, 7]])])
def test_batch_rows_give_a_rank_its_block_of_each_microbatch(accum, want):
    """A data rank's rows: one block of the batch, or with grad_accum its
    block of each of ``split_microbatches``' microbatches, in order."""
    from repro_torch.sharding.execute import batch_rows
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 2})
    for d in range(2):
        for m in range(2):
            got = [i for sl in batch_rows(8, mesh, {"data": d, "model": m},
                                          accum)
                   for i in range(8)[sl]]
            assert got == want[d], (accum, d, got)
    with pytest.raises(ValueError, match="microbatches"):
        batch_rows(8, mesh, {"data": 0, "model": 0}, 8)


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo")])
def test_backend_follows_the_mesh(devices, want):
    """NCCL for ranks on distinct cards; gloo for CPU ranks and for ranks
    that share a card."""
    from repro_torch.launch.mesh import Mesh, backend_for
    mesh = Mesh(np.asarray([torch.device(d) for d in devices],
                           dtype=object).reshape(1, 2), ("data", "model"))
    assert backend_for(mesh) == want


def test_checkpoint_reader_matches_numpy(tmp_path):
    """The checkpoint's array reader (stored members straight from their
    offsets) gives what ``np.load`` gives: C and Fortran order, bf16's
    2-byte void, 0-d arrays, and a compressed member through numpy."""
    from repro_torch.checkpoint.manager import _read_arrays
    arrays = {"a/b": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              "f": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
              "v": np.arange(6, dtype=np.uint16).view("V2"),
              "s": np.asarray(7)}
    for save in (np.savez, np.savez_compressed):
        path = str(tmp_path / f"{save.__name__}.npz")
        save(path, **arrays)
        got = _read_arrays(path, list(arrays))
        for k, a in arrays.items():
            assert got[k].dtype == a.dtype and got[k].shape == a.shape
            assert got[k].tobytes() == a.tobytes(), (save.__name__, k)


# ---------------------------------------------------------------------------
# the sharded launcher
# ---------------------------------------------------------------------------

def _launch(io, mesh, world, steps, store):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    args = [sys.executable, "-m", "repro_torch.launch.train", "--steps",
            str(steps), "--seq", "16", "--batch", "8", "--device", "cpu",
            "--ckpt-dir", os.path.join(io, "cli_ckpt")]
    args += ["--mesh", mesh, "--fsdp", "--zero1", "--init-method",
             "file://" + os.path.join(io, store), "--world-size", str(world)]
    procs = [subprocess.Popen(args + ["--rank", str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return outs[0].splitlines()


def test_launcher_resumes_on_another_mesh(tmp_path):
    """Two ranks on (2, 1) for 2 steps, resumed on (1, 2) for a third:
    rank 0 prints JAX's resume line, and the third loss equals the
    unsharded launcher's."""
    io = str(tmp_path)
    first = _launch(io, "2,1", 2, 2, "s1")
    assert first[-1] == "[train] done", first
    second = _launch(io, "1,2", 2, 3, "s2")
    assert "[train] resumed at step 2 (elastic reshard onto (1, 2))" \
        in second, second
    import contextlib
    import io as io_
    from repro_torch.launch import train as cli
    buf = io_.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--steps", "3", "--seq", "16", "--batch", "8",
                  "--device", "cpu"])
    one = buf.getvalue().splitlines()
    last = [ln for ln in second if ln.startswith("step 2:")]
    want = [ln for ln in one if ln.startswith("step 2:")]
    assert last and want and last[0].split()[2] == want[0].split()[2], \
        (second, one)
