"""The port's training side against the JAX package's.

Held, in f32 on reduced configs with JAX's weights bridged across:
``Model.loss`` and its gradients with remat for every family (the cases
of ``test_torch_loss.py`` under ``jax.checkpoint``'s counterpart); three
AdamW steps of ``make_train_step`` on the same ``SyntheticLM`` batches
against JAX's (``grad_accum`` 1 and 2, with and without remat; qwen2-vl
splits its (3, B, S) positions on axis 1); the cases of JAX's
``tests/test_training.py`` (the quadratic, the schedule, the clip,
grad-accum and remat equivalence) on the port; ``SyntheticLM`` bit-equal
to JAX's for every family branch; checkpoints across the packages in
both directions, f32 and bf16 (equal manifests: keys, dtypes, shapes,
checksum), and the cases of JAX's ``tests/test_checkpoint.py`` on the
port (kill-and-resume bit-identical, retention, the checksum); the
training CLI on the CPU; and the gradient routes of the kernels: flash
and the selective scan as ``autograd.Function``s (their launches swapped
for the plain versions, since no kernel runs here), the f32-output
products' backward, and every other ctypes wrapper refusing a gradient.

Tolerances: losses 1e-5 relative; gradient leaves 1e-4 of the leaf's
largest (every family; see ``test_torch_loss.py``); params after
three AdamW steps at lr 1e-3 within 1e-4, the tolerance of JAX's own
grad-accum equivalence test at that lr (AdamW's step is about lr in size
whatever |g|, so f32 noise in a small gradient element moves its update
by a share of lr: 2.1e-5 seen on 1 of 8,192 elements of a qwen2-moe
leaf); the moments within 1e-4 of their leaf's largest; the optimizer
alone on identical gradients 1e-6; data, checkpoints and resume
bit-equal.
"""
import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import checkpoint as JCK  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.data import SyntheticLM as JSynth  # noqa: E402
from repro.training import AdamW as JAdamW  # noqa: E402
from repro.training import AdamWState as JState  # noqa: E402
from repro.training import make_train_step as j_train_step  # noqa: E402
from repro_torch import checkpoint as TCK  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                opt_state_to_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig, reduced  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import fused_matmul as FM  # noqa: E402
from repro_torch.kernels import layernorm as LN  # noqa: E402
from repro_torch.kernels import linear_scan as LS  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import selective_scan as SS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.training import (AdamW, AdamWState,  # noqa: E402
                                  make_train_step)
from test_torch_loss import (FAMILIES, flat, hold,  # noqa: E402
                             jax_loss_and_grads, make_batch,
                             pair, port_loss_and_grads)

PARAM_TOL = 1e-4


# ---------------------------------------------------------------------------
# loss and gradients under remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_remat_loss_and_grads_match_jax(name):
    jm, jp, tm, tp, cfg = pair(name, seed=1)
    batch = make_batch(cfg, seed=1)
    jl, jg = jax_loss_and_grads(jm, jp, batch, True)
    tl, tg = port_loss_and_grads(tm, tp, batch, True)
    hold(jl, jg, tl, tg)


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------

def _opts():
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    return JAdamW(**kw), AdamW(**kw)


@pytest.mark.parametrize("name,grad_accum,remat", [
    ("yi-6b", 1, False), ("yi-6b", 2, False), ("yi-6b", 1, True),
    ("yi-6b", 2, True), ("qwen2-moe-a2.7b", 2, True),
    ("qwen2-vl-72b", 2, False)])
def test_three_train_steps_match_jax(name, grad_accum, remat):
    """Three steps of each package's train step on the same SyntheticLM
    batches (4 rows of 16): loss, grad norm and lr every step, and the
    params and AdamW state after the third."""
    jm, jp, tm, tp, cfg = pair(name)
    jopt, topt = _opts()
    jstep = jax.jit(j_train_step(jm, jopt, remat=remat,
                                 grad_accum=grad_accum))
    tstep = make_train_step(tm, topt, remat=remat, grad_accum=grad_accum)
    data = SyntheticLM(cfg, ShapeConfig("t", 16, 4, "train"))
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        batch = data.batch_at(i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, ts, tmet = tstep(tp, ts, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) \
                <= 1e-5 * abs(float(jmet[k])), (i, k)
    assert int(ts.step) == int(js.step) == 3
    got = flat(params_to_numpy(tp))
    for key, ref in flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(got[key], ref, atol=PARAM_TOL, rtol=0,
                                   err_msg=key)
    step, m, v = opt_state_to_numpy(ts)
    for mine, theirs in ((m, js.m), (v, js.v)):
        theirs = flat(jax.tree.map(np.asarray, theirs))
        for key, a in flat(mine).items():
            scale = np.abs(theirs[key]).max()
            assert np.abs(a - theirs[key]).max() <= 1e-4 * scale, key


def test_adamw_update_matches_jax_on_the_same_grads():
    """One update on identical gradients (bf16 and f32 leaves, one past
    the clip) and identical state after two earlier steps."""
    r = np.random.default_rng(4)
    p = {"a": r.standard_normal((8, 6)).astype(np.float32),
         "b": {"c": r.standard_normal((5,)).astype(np.float32)}}
    g = {"a": 3 * r.standard_normal((8, 6)).astype(np.float32),
         "b": {"c": r.standard_normal((5,)).astype(np.float32)}}
    jopt, topt = _opts()
    jp = jax.tree.map(jnp.asarray, p)
    tp = TR.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update(TR.tree_map(torch.from_numpy, g), ts, tp)
    assert float(jm["grad_norm"]) > topt.clip_norm     # the clip acts
    for k in ("grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * float(jm[k])
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               atol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(),
                               np.asarray(jp["b"]["c"]), atol=1e-6)
    # bf16 params come back bf16, moments f32 (no master copy)
    bp = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    st = topt.init(bp)
    nb, st, _ = topt.update({"w": torch.ones((4,), dtype=torch.bfloat16)},
                            st, bp)
    assert nb["w"].dtype == torch.bfloat16 and st.m["w"].dtype == torch.float32


def test_adamw_runs_of_leaves_change_nothing(monkeypatch):
    """The update taken in runs of a few leaves (``_groups`` at a small
    cap) equals the one taken over all leaves at once, bit for bit."""
    from repro_torch.training import optimizer as O
    r = np.random.default_rng(5)
    shapes = [(8, 6), (5,), (40,), (3, 3), (7, 2)]
    p = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
         for s in shapes]
    g = [torch.from_numpy(r.standard_normal(s).astype(np.float32))
         for s in shapes]
    p[1] = p[1].to(torch.bfloat16)
    g[1] = g[1].to(torch.bfloat16)
    _, opt = _opts()
    assert O._groups(p, cap=50) == [[0], [1, 2], [3, 4]]
    whole = opt.update(g, opt.init(p), p)
    groups = O._groups
    monkeypatch.setattr(O, "_groups", lambda leaves: groups(leaves, cap=50))
    runs = opt.update(g, opt.init(p), p)
    for a, b in zip(TR.leaves(whole[:2]), TR.leaves(runs[:2])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert whole[0][1].dtype == torch.bfloat16
# the cases of JAX's tests/test_training.py, on the port

def test_adamw_decreases_quadratic():
    opt = AdamW(lr=0.1, warmup_steps=1, total_steps=300, weight_decay=0.0,
                clip_norm=100.0)
    p = {"w": torch.tensor([5.0, -3.0])}
    st = opt.init(p)
    for _ in range(150):
        p, st, _ = opt.update({"w": 2 * p["w"]}, st, p)
    assert float(p["w"].abs().max()) < 1.0


def test_schedule_warmup_and_decay():
    opt = AdamW(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(opt.schedule(1)) < 0.2
    assert float(opt.schedule(10)) == pytest.approx(1.0, abs=0.02)
    assert float(opt.schedule(100)) == pytest.approx(0.1, abs=0.02)
    jopt = JAdamW(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 37, 100, 150):
        assert float(opt.schedule(torch.tensor(s, dtype=torch.int32))) \
            == pytest.approx(float(jopt.schedule(jnp.int32(s))), rel=1e-6)


def test_grad_clip_applied():
    opt = AdamW(lr=1e-3, clip_norm=1.0, warmup_steps=1, total_steps=10)
    p = {"w": torch.zeros((4,))}
    st = opt.init(p)
    _, _, metrics = opt.update({"w": torch.full((4,), 1e6)}, st, p)
    assert float(metrics["grad_norm"]) > 1.0   # raw norm reported


def _yi_one_layer():
    cfg = reduced(T_REGISTRY["yi-6b"], layers=1)
    model = build_model(cfg, device="cpu")
    p = model.init(torch.Generator().manual_seed(0))
    return cfg, model, p


def test_grad_accum_equivalence():
    cfg, model, p = _yi_one_layer()
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    st = opt.init(p)
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "labels": r.integers(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32)}
    p1, _, m1 = make_train_step(model, opt, remat=False)(p, st, batch)
    p2, _, m2 = make_train_step(model, opt, remat=False,
                                grad_accum=2)(p, st, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    err = max(float((a - b).abs().max())
              for a, b in zip(TR.leaves(p1), TR.leaves(p2)))
    assert err < 1e-4, err


def test_remat_matches_no_remat():
    _, model, p = _yi_one_layer()
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    st = opt.init(p)
    batch = {"tokens": np.ones((2, 16), np.int32),
             "labels": np.ones((2, 16), np.int32)}
    pa, _, ma = make_train_step(model, opt, remat=False)(p, st, batch)
    pb, _, mb = make_train_step(model, opt, remat=True)(p, st, batch)
    assert abs(float(ma["loss"]) - float(mb["loss"])) < 1e-6
    err = max(float((a - b).abs().max())
              for a, b in zip(TR.leaves(pa), TR.leaves(pb)))
    assert err < 1e-5


def test_train_step_leaves_its_inputs_alone():
    """Functional, as JAX's: the params and state passed in are unchanged
    and never require grad after the step."""
    _, model, p = _yi_one_layer()
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    st = opt.init(p)
    before = [t.clone() for t in TR.leaves(p)]
    batch = {"tokens": np.ones((2, 8), np.int32),
             "labels": np.ones((2, 8), np.int32)}
    p2, st2, _ = make_train_step(model, opt)(p, st, batch)
    for a, b in zip(before, TR.leaves(p)):
        assert torch.equal(a, b)
    assert int(st.step) == 0 and int(st2.step) == 1
    assert not any(t.requires_grad for t in TR.leaves(p2))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["yi-6b", "deit-t", "whisper-base",
                                  "qwen2-vl-72b", "jamba-1.5-large-398b"])
def test_synthetic_lm_bit_equal_to_jax(name):
    """Every family branch (token LM, vision, audio, vlm with its equal
    M-RoPE streams, hybrid), several steps and seeds: same keys, dtypes
    and bits."""
    jc = j_reduced(J_REGISTRY[name])
    tc = reduced(T_REGISTRY[name])
    for seed, seq, batch in ((0, 32, 2), (5, 17, 3)):
        jd = JSynth(jc, JShape("t", seq, batch, "train"), seed=seed)
        td = SyntheticLM(tc, ShapeConfig("t", seq, batch, "train"),
                         seed=seed)
        for step in (0, 3, 11):
            a, b = jd.batch_at(step), td.batch_at(step)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    shape = ShapeConfig("t", 8, 2, "train")
    first = next(iter(SyntheticLM(tc, shape, start_step=3)))
    np.testing.assert_array_equal(first["labels"],
                                  SyntheticLM(tc, shape).batch_at(3)["labels"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16",
                               param_dtype="bfloat16")


def _trees(dtype):
    """JAX's and the port's {"params", "opt", "data_step"} trees holding
    the same numbers (qwen2-moe: a stack, MoE leaves; bf16 or f32)."""
    jm, jp, tm, tp, cfg = pair("qwen2-moe-a2.7b")
    if dtype == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        cfg = _bf16(cfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    r = np.random.default_rng(2)
    js = JState(step=jnp.int32(5),
                m=jax.tree.map(lambda a: jnp.asarray(r.standard_normal(
                    a.shape), jnp.float32), jp),
                v=jax.tree.map(lambda a: jnp.asarray(r.random(a.shape),
                                                     jnp.float32), jp))
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, tuple(js)), cfg,
                              "cpu")
    return ({"params": jp, "opt": js, "data_step": 2},
            {"params": tp, "opt": ts, "data_step": 2}, cfg)


def _bits(a):
    """bf16 (JAX's dtype, or the ``|V2`` JAX restores) as its bits."""
    a = np.asarray(a)
    if a.dtype in (ml_dtypes.bfloat16, np.dtype("V2")):
        return a.view(np.uint16)
    return a


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_checkpoints_cross_the_packages(tmp_path, dtype):
    """The same state saved by each package: equal manifests (keys such
    as ``opt/.m/stack/b0/ffn/wi``, dtypes, shapes, checksum); each
    package restores the other's checkpoint, bit for bit."""
    jt, tt, cfg = _trees(dtype)
    jpath = JCK.save(jt, str(tmp_path / "jax"), 7)
    tpath = TCK.save(tt, str(tmp_path / "port"), 7)
    mj, mt = _manifest(jpath), _manifest(tpath)
    assert mj == mt
    assert "opt/.step" in mt["keys"] and "data_step" in mt["keys"]
    assert mt["dtypes"]["params/embed/table"] == (
        "bfloat16" if dtype == "bf16" else "float32")
    # the port restores JAX's checkpoint
    like = {"params": tt["params"], "opt": tt["opt"], "data_step": 0}
    got, step = TCK.restore(like, str(tmp_path / "jax"))
    assert step == 7 and isinstance(got["opt"], AdamWState)
    assert int(got["data_step"]) == 2 and np.ndim(got["data_step"]) == 0
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 5
    assert isinstance(got["params"]["stack"], list)
    for a, b in zip(TR.leaves(got), TR.leaves(tt)):
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # JAX restores the port's checkpoint
    jlike = {"params": jt["params"], "opt": jt["opt"], "data_step": 0}
    jgot, step = JCK.restore(jlike, str(tmp_path / "port"))
    assert step == 7 and int(np.asarray(jgot["data_step"])) == 2
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_bridge_round_trips_params_and_opt_state():
    jt, tt, cfg = _trees("bf16")
    back = params_to_numpy(tt["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt["params"])):
        np.testing.assert_array_equal(a.view(ml_dtypes.bfloat16),
                                      np.asarray(b))
    step, m, v = opt_state_to_numpy(tt["opt"])
    assert int(step) == 5
    for a, b in zip(jax.tree.leaves(m), jax.tree.leaves(jt["opt"].m)):
        np.testing.assert_array_equal(a, np.asarray(b))


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.zeros((), dtype=torch.float32)}}


def test_roundtrip_and_latest_wins(tmp_path):
    t = tree()
    TCK.save(t, str(tmp_path), 1)
    TCK.save(TR.tree_map(lambda x: x + 1, t), str(tmp_path), 2)
    r, step = TCK.restore(t, str(tmp_path))
    assert step == 2
    assert torch.equal(r["a"], t["a"] + 1)
    r, step = TCK.restore(t, str(tmp_path), step=1)
    for a, b in zip(TR.leaves(r), TR.leaves(t)):
        assert torch.equal(a, b)


def test_corruption_detected(tmp_path):
    path = TCK.save(tree(), str(tmp_path), 1)
    mpath = os.path.join(path, "manifest.json")
    man = _manifest(path)
    man["checksum"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError, match="checksum"):
        TCK.restore(tree(), str(tmp_path))


def test_no_partial_checkpoint_visible(tmp_path):
    os.makedirs(tmp_path / "tmp.5.123")
    assert TCK.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        TCK.restore(tree(), str(tmp_path))


def test_manager_retention_and_async(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = tree()
    for s in range(5):
        mgr.save(TR.tree_map(lambda x, s=s: x + s, t), s)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]
    r, step = mgr.restore_latest(t)
    assert step == 4 and torch.equal(r["a"], t["a"] + 4)


def test_flatten_keys_stable():
    from repro_torch.checkpoint.manager import _flatten
    assert set(_flatten(tree())) == {"a", "b/c", "b/d"}
    st = AdamWState(step=torch.zeros((), dtype=torch.int32),
                    m={"stack": [{"w": torch.ones(2)}, {"w": torch.ones(2)}]},
                    v=[torch.ones(1), None])
    flat_st = _flatten({"opt": st})
    assert set(flat_st) == {"opt/.step", "opt/.m/stack/w", "opt/.v/0"}
    assert flat_st["opt/.m/stack/w"].shape == (2, 2)


def test_restart_resumes_training_bit_identically(tmp_path):
    """Kill-and-restart (JAX's test_checkpoint.py case): restored params,
    AdamW state and data step continue bit-identically against an
    uninterrupted run."""
    cfg, model, p0 = _yi_one_layer()
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLM(cfg, ShapeConfig("t", 16, 2, "train"))
    step_fn = make_train_step(model, opt, remat=False)
    p, st = p0, opt.init(p0)
    for i in range(4):
        p, st, _ = step_fn(p, st, data.batch_at(i))
    p2, st2 = p0, opt.init(p0)
    for i in range(2):
        p2, st2, _ = step_fn(p2, st2, data.batch_at(i))
    TCK.save({"params": p2, "opt": st2, "data_step": 2}, str(tmp_path), 2)
    fresh = model.init(torch.Generator().manual_seed(1))
    restored, _ = TCK.restore({"params": fresh, "opt": opt.init(fresh),
                               "data_step": 0}, str(tmp_path))
    p3, st3 = restored["params"], restored["opt"]
    for i in range(int(restored["data_step"]), 4):
        p3, st3, _ = step_fn(p3, st3, data.batch_at(i))
    for a, b in zip(TR.leaves((p, st)), TR.leaves((p3, st3))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run_cli(argv):
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(argv)
    return out.getvalue()


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    base = ["--arch", "yi-6b", "--seq", "16", "--batch", "4", "--device",
            "cpu", "--grad-accum", "2", "--ckpt-dir", str(tmp_path)]
    out = _run_cli(base + ["--steps", "3"])
    lines = out.splitlines()
    assert lines[0].startswith("step 0: loss=") and lines[0].endswith("ms")
    assert lines[1].startswith("step 2: loss=")
    assert lines[-1] == "[train] done"
    assert np.isfinite(float(lines[1].split("loss=")[1].split()[0]))
    assert TCK.latest_step(str(tmp_path)) == 3
    out = _run_cli(base + ["--steps", "4"])
    assert out.splitlines()[0] == "[train] resumed at step 3"
    assert out.splitlines()[-1] == "[train] done"
    assert TCK.latest_step(str(tmp_path)) == 4


def test_cli_refuses_a_depth_off_the_period_and_a_missing_gpu():
    with pytest.raises(SystemExit, match="not a multiple"):
        _run_cli(["--arch", "jamba-1.5-large-398b", "--layers", "3",
                  "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            _run_cli(["--steps", "1"])


# ---------------------------------------------------------------------------
# the kernels' gradient routes
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


REFUSERS = {
    "fused_paged_decode_grouped": lambda: PA.fused_paged_decode_grouped(
        _meta(1, 1, 2, 64), _meta(1, 1, 64), _meta(1, 1, 64),
        _meta(4, 16, 1, 64, grad=False), _meta(4, 16, 1, 64, grad=False),
        _meta(1, 2, dtype=torch.int32, grad=False),
        _meta(1, dtype=torch.int32, grad=False), theta=1e4),
    "paged_attention_grouped": lambda: PA.paged_attention_grouped(
        _meta(1, 1, 2, 64), _meta(4, 16, 1, 64), _meta(4, 16, 1, 64),
        _meta(1, 2, dtype=torch.int32, grad=False),
        _meta(1, dtype=torch.int32, grad=False)),
    "paged_prefill_attention_grouped":
        lambda: PA.paged_prefill_attention_grouped(
            _meta(1, 1, 2, 4, 64), _meta(4, 16, 1, 64), _meta(4, 16, 1, 64),
            _meta(1, 2, dtype=torch.int32, grad=False), 0),
    "paged_verify_attention_grouped":
        lambda: PA.paged_verify_attention_grouped(
            _meta(1, 1, 2, 4, 64), _meta(4, 16, 1, 64), _meta(4, 16, 1, 64),
            _meta(1, 2, dtype=torch.int32, grad=False),
            _meta(1, dtype=torch.int32, grad=False)),
    "linear_scan": lambda: LS.linear_scan(_meta(1, 4, 8), _meta(1, 4, 8)),
    "matmul_fused": lambda: FM.matmul_fused(_meta(4, 8), _meta(8, 16)),
    "norm_onepass": lambda: LN.norm_onepass(_meta(4, 8), _meta(8)),
}


@pytest.mark.parametrize("name", list(REFUSERS))
def test_kernels_without_a_backward_refuse_a_gradient(name):
    """Off the CPU, a ctypes kernel asked for a gradient raises (its
    launch would drop it); under no_grad it goes on to its launch path
    (here: no kernel for the meta device)."""
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        REFUSERS[name]()
    with torch.no_grad(), pytest.raises(ValueError, match="meta"):
        REFUSERS[name]()


def test_refuse_grad_ignores_inputs_without_grad():
    _build.refuse_grad("x", (_meta(2, grad=False), None))
    with torch.no_grad():
        _build.refuse_grad("x", (_meta(2),))


def _plain_flash(q, k, v, q_pos, k_pos, k_valid, causal, window, softcap):
    FA.flash_attention_bhsd.launches += 1
    return R.flash_attention_ref(q, k, v, q_pos, k_pos, k_valid,
                                 causal=causal, window=window,
                                 softcap=softcap)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 5, 20.0), (False, 0, 0.0)])
def test_flash_function_gradients_equal_the_plain_versions(
        monkeypatch, causal, window, softcap):
    """``_FlashAttention`` with its launch swapped for the plain version:
    one forward launch counted, and q, k, v gradients equal to autograd
    through the plain version (GQA: k, v summed over their groups)."""
    monkeypatch.setattr(FA, "_launch", _plain_flash)
    r = np.random.default_rng(0)
    q = torch.from_numpy(r.standard_normal((2, 4, 12, 64)).astype(
        np.float32))
    k = torch.from_numpy(r.standard_normal((2, 2, 12, 64)).astype(
        np.float32))
    v = torch.from_numpy(r.standard_normal((2, 2, 12, 64)).astype(
        np.float32))
    pos = torch.arange(12, dtype=torch.int32)
    valid = torch.ones(12, dtype=torch.int32)
    g = torch.from_numpy(r.standard_normal((2, 4, 12, 64)).astype(
        np.float32))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = FA.flash_attention_bhsd.launches
    out = FA._FlashAttention.apply(*ins, pos, pos, valid, causal, window,
                                   softcap)
    out.backward(g)
    assert FA.flash_attention_bhsd.launches == before + 1
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    R.flash_attention_ref(*ref_ins, pos, pos, valid, causal=causal,
                          window=window, softcap=softcap).backward(g)
    for a, b in zip(ins, ref_ins):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def _plain_scan(delta, xi, bm, cm, a_mat, h0):
    SS.mamba_scan_fused.launches += 1
    return R.mamba_scan_fused_ref(delta, xi, bm, cm, a_mat, h0)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_selective_scan_function_gradients_equal_the_plain_versions(
        monkeypatch, with_h0):
    monkeypatch.setattr(SS, "_launch", _plain_scan)
    r = np.random.default_rng(1)
    n_, s, d, n = 2, 9, 8, 4

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * r.standard_normal(shape)).astype(
            np.float32))
    delta = t(n_, s, d, scale=0.1).abs()
    args = [delta, t(n_, s, d), t(n_, s, n), t(n_, s, n), -t(d, n).abs(),
            t(n_, d, n) if with_h0 else None]
    gy, gh = t(n_, s, d), t(n_, d, n)
    ins = [None if a is None else a.clone().requires_grad_() for a in args]
    y, h = SS._SelectiveScan.apply(*ins)
    torch.autograd.backward((y, h), (gy, gh))
    ref_ins = [None if a is None else a.clone().requires_grad_()
               for a in args]
    ry, rh = R.mamba_scan_fused_ref(*ref_ins)
    torch.autograd.backward((ry, rh), (gy, gh))
    torch.testing.assert_close(y, ry, rtol=0, atol=0)
    for a, b in zip(ins, ref_ins):
        if a is not None:
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def _same_but_last_bit_flips(got, ref):
    """bf16 gradients equal but for rare flips of the final cast (their
    f32 sums differ in order): at most 1% of the elements differ, each by
    at most one bf16 step of the leaf's largest.  A cotangent rounded to
    bf16 before the products differs on about 40% of them."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert (got != ref).mean() <= 0.01, (got != ref).mean()
    assert np.abs(got - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batched", [False, True])
def test_f32_product_backward_follows_jax_transpose_rule(dtype, batched):
    """``matmul_f32_grads`` (the backward of the CUDA path's Function):
    each operand's gradient in its own dtype, an f32-accumulated product
    of the f32 cotangent -- in f32 equal to autograd through the CPU
    path's widened product, in bf16 equal to it but for last-bit flips
    of the cast (the cotangent enters as three bf16 terms)."""
    r = np.random.default_rng(2)
    lead = (3,) if batched else ()
    x = torch.from_numpy(r.standard_normal(lead + (64, 256)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((r.standard_normal(lead + (256, 48)) / 16).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(r.standard_normal(lead + (64, 48)).astype(
        np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    f = TL.bmm_f32 if batched else TL.matmul_f32
    out = f(xa, wa)
    assert out.dtype == torch.float32
    out.backward(g)
    gx, gw = TL.matmul_f32_grads(x, w, g)
    assert gx.dtype == dtype and gw.dtype == dtype
    for got, ref in ((gx, xa.grad), (gw, wa.grad)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
        else:
            _same_but_last_bit_flips(got, ref.float())
    assert TL.matmul_f32_grads(x, w, g, (False, True))[0] is None


def test_bf16_split_of_the_cotangent_is_exact_to_f32():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 48)).astype(np.float32)) * 1e3
    parts = TL._split_bf16(g)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    back = parts[2].double() + parts[1].double() + parts[0].double()
    assert (back - g.double()).abs().max() <= 2.0 ** -27 * g.abs().max()


@pytest.mark.parametrize("batched", [False, True])
def test_f32_product_bf16_grads_match_jax(batched):
    """``_MatmulF32`` on bf16 operands (the CUDA path's Function; its
    products widen here) against ``jax.vjp`` of JAX's bf16 einsum with
    ``preferred_element_type=f32``: the same gradients but for last-bit
    flips of the bf16 cast."""
    r = np.random.default_rng(2)
    lead = (3,) if batched else ()
    x = torch.from_numpy(r.standard_normal(lead + (64, 256)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((r.standard_normal(lead + (256, 48)) / 16).astype(
        np.float32)).to(torch.bfloat16)
    g = r.standard_normal(lead + (64, 48)).astype(np.float32)
    eq = "emk,ekn->emn" if batched else "mk,kn->mn"
    jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (x, w))
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        eq, a, b, preferred_element_type=jnp.float32), jx, jw)
    jgx, jgw = (np.asarray(t.astype(jnp.float32))
                for t in vjp(jnp.asarray(g)))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    TL._MatmulF32.apply(xa, wa).backward(torch.from_numpy(g))
    assert xa.grad.dtype == wa.grad.dtype == torch.bfloat16
    _same_but_last_bit_flips(xa.grad, jgx)
    _same_but_last_bit_flips(wa.grad, jgw)
