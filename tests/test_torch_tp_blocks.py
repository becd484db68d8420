"""Tensor parallelism for every block kind and front end of the registry:
the port's sharded train step over ``model`` > 1 against the JAX
package's single-device step.  Ranks are CPU processes on gloo (a
``file://`` store under the test's temporary directory), each importing
only torch, numpy and ``repro_torch``; the JAX references run in the
test's own process on one CPU device, on weights that reach the ranks as
a JAX checkpoint.

Two spawns, started together, six configs each (the ``runs`` fixture,
once): (data=1, model=2) on 2 ranks and (data=2, model=2) on 4.  Each
arch is the registry's ``reduced`` config, its blocks tensor parallel on
the shards JAX's specs give a rank:
  * jamba-1.5-large-398b: mamba (``in_proj``'s output gathered, the
    conv, scan and gate on the rank's channels, ``x_proj``/``out_proj``
    row-parallel), attention, and MoE tensor parallel inside each
    expert;
  * xlstm-125m at one period: mLSTM (the rank's heads) and sLSTM (the
    recurrence whole on every rank: ``w_x``'s output and ``w_h`` through
    ``gather_replicated``; its GLU's ``up`` is cut on the 2 x 85 columns
    while ``down``'s 85 rows stay whole, so ``up``'s output is gathered
    for replicated compute too);
  * xlstm-125m at one period and one head: the mLSTM's wq columns cut
    its head (q, k and v gathered, the rank's d_inner / 2 columns of the
    normed output kept), the sLSTM's w_h whole;
  * whisper-base: the encoder, and the decoder's cross-attention over
    the encoder's output;
  * deit-t: 3 query heads over 2 ranks (a rank's wq columns cut a head:
    q, k and v gathered, every head attended), the class head cut on its
    classes (the vocab-parallel cross-entropy over the cls rows);
  * qwen2-vl-72b: the ``embeds`` path on distinct t/h/w M-RoPE streams
    (JAX's ``SyntheticLM`` draws three equal ones).
Each is held to ``jax.jit(make_train_step(...))`` and ``jax.jit(m.loss)``
on the same checkpoint and batch.  On (1, 2) the ranks also hold the
gather for replicated compute to its rule (its gradient counted once),
and the saved step's checkpoint restores bit-equal onto no mesh, in the
port and in JAX.

Tolerances, JAX's own (``tests/test_distributed.py``): loss 1e-4, params
after one AdamW step at lr 1e-3 (eps 1e-4: see ``OPT``) 1e-4, grad_norm
1e-5 relative; restores bit-equal.
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

from repro import checkpoint as JCK  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import make_train_step as j_train_step  # noqa: E402
from repro_torch import checkpoint as TCK  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
NORM_RTOL = 1e-5
B, S, FRAMES = 4, 16, 16
# AdamW's eps at 1e-4, as phase 10 of ``chip_smoke.py`` takes it: at the
# default 1e-8 the first update moves a gradient element near zero (a
# mamba out_proj element's 7.5e-8 beside its f32 summation noise of
# 1.6e-7 here) by about lr whatever its sign, so the port's own
# unsharded step already lies 1.8e-4 (jamba) and 2e-3 (xlstm) from
# JAX's; above most of those elements the update follows the gradient
OPT = dict(lr=1e-3, eps=1e-4, warmup_steps=1, total_steps=10)
ARCHS = ("jamba-1.5-large-398b", "xlstm-125m", "xlstm-125m-h1",
         "whisper-base", "deit-t", "qwen2-vl-72b")
# a registry arch with fields replaced: xlstm-125m at one head, so that
# the mLSTM's wq columns cut its one head over 2 ranks (every head run
# on every rank) and the sLSTM's w_h (1 head) stays whole
VARIANTS = {"xlstm-125m-h1": ("xlstm-125m", {"num_heads": 1,
                                             "num_kv_heads": 1})}
MESHES = {"m12": ((1, 2), 2), "m22": ((2, 2), 4)}
# xlstm-125m at one pattern period (3 mLSTM + 1 sLSTM): at two its f32
# gradients are ill-conditioned (``tests/test_torch_loss.py``)
LAYERS = {"xlstm-125m": 4, "xlstm-125m-h1": 4}
# grad_norm held to the port's unsharded step: xlstm-125m's recurrence
# in f32 puts the port's own unsharded gradients 2e-5 of a leaf's
# largest from JAX's, every leaf alike, and its grad_norm 9.5e-6
# relative (the sharded step lies 8.8e-7 from the unsharded one)
PORT_NORM_REF = ("xlstm-125m", "xlstm-125m-h1")

# Each rank runs this (``python -c``), sys.argv = [case, rank, world,
# store, io_dir]; it writes ``{case}_rank{r}.json`` and the stepped
# params' checkpoints.
WORKER = textwrap.dedent('''
import dataclasses, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import sharding as S
from repro_torch import tree as TR
from repro_torch.checkpoint import restore, save
from repro_torch.configs import REGISTRY, reduced
from repro_torch.launch.mesh import Mesh, device_mesh, init_distributed
from repro_torch.models import build_model
from repro_torch.training import (AdamW, init_sharded, make_train_step,
                                  sharded_train_step)

case, rank, world, store, io = sys.argv[1:6]
rank, world = int(rank), int(world)
shape = {"m12": (1, 2), "m22": (2, 2)}[case]
mesh = Mesh(np.asarray([torch.device("cpu")] * world,
                       dtype=object).reshape(shape), ("data", "model"))
init_distributed(mesh, rank, world, init_method="file://" + store)
dm = device_mesh(mesh)
view = S.axes_view(dm)
opt = AdamW(**%r)
out = {}
for arch in %r:
    base, kw = %r.get(arch, (arch, {}))
    cfg = dataclasses.replace(
        reduced(REGISTRY[base], layers=%r.get(arch, 0)), **kw)
    model = build_model(cfg, "cpu")
    like = model.init(torch.Generator().manual_seed(0))
    params, _ = restore(like, os.path.join(io, arch + "_jax"))
    with np.load(os.path.join(io, arch + ".npz")) as f:
        bt = {k: f[k] for k in f.files}
    pspecs = S.param_specs(params, view)
    fn = sharded_train_step(make_train_step(model, opt, remat=True), dm,
                            pspecs, pspecs, S.input_specs_tree(bt, view))
    sp = S.shard_tree(params, pspecs, dm)
    so = init_sharded(opt, sp, pspecs, dm)
    S.reset_stats()
    sp, so, met = fn(sp, so, S.shard_batch(bt, dm))
    st = S.stats()
    path = os.path.join(io, f"{case}_{arch}_params")
    save(sp, path, 1)
    row = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               stats=st, local={"/".join(k): list(t.to_local().shape)
                                for k, t in S.execute.flat(sp).items()})
    if case == "m12":
        back = S.gather_tree(sp)
        plain, _ = restore(like, path)
        row["restored_equal"] = all(
            torch.equal(a, b) for a, b in zip(TR.leaves(back),
                                              TR.leaves(plain)))
    out[arch] = row
if case == "m12":
    # the gather for replicated compute: every rank squares the whole
    # gathered tensor alike; its gradient is counted once (2 x), where
    # the summing gather's backward counts it on every rank (2 x tp x)
    par = S.Parallel(dm)
    x = torch.arange(6.0).reshape(2, 3).add(10 * rank).requires_grad_()
    S.reset_stats()
    y = par.gather_replicated(x, 0, "model")
    (g_once,) = torch.autograd.grad((y * y).sum(), x)
    st = S.stats()
    y2 = par.all_gather(x, 0, "model")
    (g_sum,) = torch.autograd.grad((y2 * y2).sum(), x)
    out["count_once"] = dict(x=x.tolist(), gathered=y.tolist(),
                             grad=g_once.tolist(), summed=g_sum.tolist(),
                             stats=st)
with open(os.path.join(io, f"{case}_rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
''' % (OPT, ARCHS, VARIANTS, LAYERS))


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


def _batch(arch, seed):
    """A batch of the arch's family, drawn with numpy: tokens, or ViT
    patch embeddings and class labels, or whisper's frames and decoder
    tokens, or qwen2-vl's merged embeddings on three distinct M-RoPE
    streams (t the token index, h and w a 2 x 3 grid's rows and
    columns)."""
    cfg = _cfg(arch)
    r = np.random.default_rng(seed)
    v, d = cfg.vocab_size, cfg.d_model

    def ids(*shape):
        return r.integers(0, v, shape).astype(np.int32)

    def emb(*shape):
        return r.standard_normal(shape).astype(np.float32)
    if cfg.family == "vision":
        return {"embeds": emb(B, S, d), "labels": ids(B)}
    if cfg.family == "audio":
        return {"enc_embeds": emb(B, FRAMES, d), "dec_tokens": ids(B, S),
                "labels": ids(B, S)}
    if cfg.family == "vlm":
        t = np.arange(S)
        pos = np.stack([t, t // 6 + (t % 6) // 3, t % 3])
        return {"embeds": emb(B, S, d), "labels": ids(B, S),
                "positions": np.broadcast_to(
                    pos[:, None], (3, B, S)).astype(np.int32).copy()}
    return {"tokens": ids(B, S), "labels": ids(B, S)}


def _params(jm, seed):
    """JAX-layout params drawn with numpy: dense weights N(0, 1)/sqrt(fan
    in), every other bias and the class token 0.1 N(0, 1) (so that each
    reaches the gradient), and JAX's init constants for the norm scales,
    mamba's D, dt_bias and A_log, and xLSTM's forget-gate bias (3: with
    forget gates near 0.5 the xLSTM step's f32 gradients are
    ill-conditioned, the port's unsharded step 6.5e-5 from JAX's in
    grad_norm)."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shp = path[-1].key, sd.shape
        if name in ("scale", "D"):
            a = np.ones(shp)
        elif name == "dt_bias":
            a = np.full(shp, -4.6)
        elif name == "f_bias":
            a = np.full(shp, 3.0)
        elif name == "A_log":
            a = np.broadcast_to(np.log(np.arange(1, shp[-1] + 1)), shp)
        elif len(shp) < 2 or name == "cls":
            a = 0.1 * r.standard_normal(shp)
        else:
            fan_in = shp[-1] if name == "table" else shp[-2]
            a = r.standard_normal(shp) / np.sqrt(fan_in)
        return np.asarray(a, sd.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.key(0)))


def _jax_step(jm, jp, batch):
    """JAX's jitted step and loss on ``batch``."""
    jopt = JAdamW(**OPT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p1, _, met = jax.jit(j_train_step(jm, jopt, remat=False))(
        jp, jopt.init(jp), jb)
    return dict(params=p1, loss=float(met["loss"]),
                grad_norm=float(met["grad_norm"]),
                plain_loss=float(jax.jit(jm.loss)(jp, jb)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, once: (rank results by case, the JAX references by
    arch, the io directory).  The ranks run while JAX compiles."""
    io = str(tmp_path_factory.mktemp("tp_blocks"))
    models = {}
    for i, arch in enumerate(ARCHS):
        base, kw = VARIANTS.get(arch, (arch, {}))
        jm = j_build(dataclasses.replace(j_reduced(
            J_REGISTRY[base], layers=LAYERS.get(arch, 0)), **kw))
        jp = jax.tree.map(jnp.asarray, _params(jm, i))
        JCK.save(jp, os.path.join(io, f"{arch}_jax"), 0)
        bt = _batch(arch, 10 + i)
        np.savez(os.path.join(io, f"{arch}.npz"), **bt)
        models[arch] = (jm, jp, bt)
    spawns = {case: start(case, world, io)
              for case, (_, world) in MESHES.items()}
    refs = {arch: _jax_step(*models[arch]) for arch in ARCHS}
    for arch in ARCHS:
        refs[arch]["params0"] = models[arch][1]
    for arch in PORT_NORM_REF:
        from repro_torch.training import AdamW, make_train_step
        _, jp, bt = models[arch]
        opt, tp = AdamW(**OPT), _as_port(jp, arch)
        met = make_train_step(build_model(_cfg(arch), "cpu"), opt)(
            tp, opt.init(tp), bt)[2]
        refs[arch]["port_grad_norm"] = float(met["grad_norm"])
    res = {case: finish(run) for case, run in spawns.items()}
    return res, refs, io


def _cfg(arch):
    base, kw = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(
        reduced(T_REGISTRY[base], layers=LAYERS.get(arch, 0)), **kw)


def _port_params(io, case, arch):
    cfg = _cfg(arch)
    like = build_model(cfg, "cpu").init(torch.Generator().manual_seed(5))
    return TCK.restore(like, os.path.join(io, f"{case}_{arch}_params"))[0]


def _as_port(jparams, arch):
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             _cfg(arch), "cpu")


GRID = [(case, arch) for case in MESHES for arch in ARCHS]


@pytest.mark.parametrize("case,arch", GRID)
def test_sharded_loss_matches_jax(runs, case, arch):
    """The step's loss is JAX's step's and ``jax.jit(m.loss)``'s, on
    every rank."""
    res, refs, _ = runs
    for r in res[case]:
        got = r[arch]["loss"]
        assert abs(got - refs[arch]["loss"]) <= LOSS_TOL, (got, refs[arch])
        assert abs(got - refs[arch]["plain_loss"]) <= LOSS_TOL


@pytest.mark.parametrize("case,arch", GRID)
def test_sharded_grad_norm_matches_jax(runs, case, arch):
    """JAX's, or for ``PORT_NORM_REF`` the port's unsharded step's."""
    res, refs, _ = runs
    want = refs[arch]["port_grad_norm" if arch in PORT_NORM_REF
                      else "grad_norm"]
    for r in res[case]:
        assert abs(r[arch]["grad_norm"] - want) <= NORM_RTOL * want, (
            r[arch]["grad_norm"], want)


@pytest.mark.parametrize("case,arch", GRID)
def test_sharded_params_after_a_step_match_jax(runs, case, arch):
    res, refs, io = runs
    got = _port_params(io, case, arch)
    want = _as_port(refs[arch]["params"], arch)
    err = max(float((a - b).abs().max())
              for a, b in zip(TR.leaves(got), TR.leaves(want)))
    assert err <= PARAM_TOL, err


# which leaf of each arch a rank must hold cut over model, by its path in
# JAX's stacked layout: (path, dim, the whole length)
CUT_LEAVES = {
    "jamba-1.5-large-398b": [("stack/b0/mixer/in_proj", 2, 256),
                             ("stack/b0/mixer/A_log", 1, 128),
                             ("stack/b0/mixer/x_proj", 1, 128),
                             ("stack/b1/ffn/wi", 3, 32)],
    "xlstm-125m": [("stack/b0/mixer/wq", 2, 128),
                   ("stack/b0/mixer/up_proj", 2, 256),
                   ("stack/b3/mixer/w_h", 1, 4),
                   ("stack/b3/mixer/w_x", 2, 256)],
    "xlstm-125m-h1": [("stack/b0/mixer/wq", 2, 128),
                      ("stack/b0/mixer/down_proj", 1, 128),
                      ("stack/b3/mixer/w_x", 2, 256)],
    "whisper-base": [("stack/b0/cross/wk", 2, 32),
                     ("enc_stack/b0/mixer/wq", 2, 64)],
    "deit-t": [("stack/b0/mixer/wq", 2, 48), ("head/w", 1, 256)],
    "qwen2-vl-72b": [("stack/b0/mixer/wq", 2, 64),
                     ("embed/table", 0, 256)],
}


@pytest.mark.parametrize("case,arch", GRID)
def test_each_rank_computes_with_its_model_shards(runs, case, arch):
    """The step ran on the cut leaves of JAX's specs (each rank's local
    shape half the whole on the model-sharded dim), and its collectives
    include the all-reduces of the row-parallel sums."""
    res, _, _ = runs
    for r in res[case]:
        row = r[arch]
        for path, dim, whole in CUT_LEAVES[arch]:
            assert row["local"][path][dim] == whole // 2, (path, row)
        assert row["stats"]["by_op"]["all_reduce"]["ops"] > 0


def test_slstm_recurrence_gathers_for_replicated_compute(runs):
    """xlstm-125m's sLSTM block gathers ``w_x``'s output and ``w_h`` (and,
    at the reduced 85-wide GLU, ``up``'s output) under their own name;
    the others do not."""
    res, _, _ = runs
    for case in MESHES:
        for r in res[case]:
            by = {a: r[a]["stats"]["by_op"] for a in ARCHS}
            assert by["xlstm-125m"]["all_gather_replicated"]["ops"] >= 3
            for arch in ("jamba-1.5-large-398b", "whisper-base",
                         "qwen2-vl-72b"):
                assert "all_gather_replicated" not in by[arch], arch


def test_replicated_gather_counts_the_gradient_once(runs):
    """On 2 ranks the gather for replicated compute gives each rank the
    whole tensor and, for a loss every rank computes alike from it, the
    unsharded gradient (2 x) -- not twice it, as the summing gather's
    backward gives."""
    res, _, _ = runs
    xs = [np.asarray(r["count_once"]["x"]) for r in res["m12"]]
    whole = np.concatenate(xs)
    for r, x in zip(res["m12"], xs):
        row = r["count_once"]
        assert np.array_equal(np.asarray(row["gathered"]), whole)
        assert np.array_equal(np.asarray(row["grad"]), 2 * x)
        assert np.array_equal(np.asarray(row["summed"]), 4 * x)
        assert row["stats"]["by_op"] == {"all_gather_replicated": {
            "ops": 1, "bytes": whole.size * 4}}


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_saved_on_1x2_restores_bit_equal(runs, arch):
    """Saved on (1, 2): gathered on the ranks it equals the restore onto
    no mesh bit for bit, and JAX's restore reads the same numbers."""
    res, refs, io = runs
    assert all(r[arch]["restored_equal"] for r in res["m12"])
    port = _port_params(io, "m12", arch)
    back, step = JCK.restore(refs[arch]["params0"],
                             os.path.join(io, f"m12_{arch}_params"))
    assert step == 1
    want = _as_port(back, arch)
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(port),
                                                 TR.leaves(want)))
