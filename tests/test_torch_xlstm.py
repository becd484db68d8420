"""xlstm-125m's mLSTM and sLSTM mixers of the port against JAX.

Weights are drawn with numpy in the JAX layout (``numpy_tree``) and
carried across by ``repro_torch.bridge.params_from_numpy``; inputs come
from a numpy seed.  Held, in f32: the port's xlstm-125m, qwen2-vl-72b and
jamba configs against JAX's field for field (the 8-expert jamba cut
differs in its name and expert count only); ``make_cache``'s mLSTM and
sLSTM leaves (shapes, dtypes); ``apply_mlstm``/``apply_slstm`` at
reduced and published width (d = 768, S = 16) with no state (the
stabilizer from -1e30), a zero state (the cache's, from 0) and a state
carried from an earlier chunk, returned states included; xlstm-125m at
one period (4 layers), reduced and published width: ``forward``, and
``prefill`` plus decode steps against JAX's and against the forward;
the engines (dense, ``paged=True`` falling back to dense, a chunked
2-stage plan, ``overlap=True``, a re-plan that migrates a slot's state
row) against the JAX engine's streams and the port's one-shot gold; no
speculation; the launcher.

Tolerances are JAX's own: 1e-5 for a mixer alone, atol 2e-4 / rtol 2e-3
for models (``tests/test_models.py``), greedy tokens identical.  The
engine schedule uses one prompt length: the JAX engine compiles once per
length when it prefills at exact lengths (a recurrent family always
does).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_serving import gold_decode, run_staggered  # noqa: E402

ARCH = "xlstm-125m"
MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)


def port_config(jcfg):
    """The JAX package's config as the port's dataclass, field for field
    (nested dataclasses included)."""
    from repro_torch.configs import base as B
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["block_pattern"] = tuple(B.BlockSpec(b.mixer, b.ffn)
                               for b in jcfg.block_pattern)
    d["moe"] = (None if jcfg.moe is None
                else B.MoEConfig(**dataclasses.asdict(jcfg.moe)))
    d["ssm"] = B.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    d["xlstm"] = B.XLSTMConfig(**dataclasses.asdict(jcfg.xlstm))
    return B.ModelConfig(**d)


def pair_configs(published: bool, layers: int = 4):
    """(JAX config, port config) of xlstm-125m at ``layers`` layers:
    reduced width (d 64, 4 heads: mLSTM head width 32, sLSTM 16) or the
    published one (d 768, vocab 50,304), in f32."""
    if published:
        kw = dict(num_layers=layers, dtype="float32",
                  param_dtype="float32")
        jc = dataclasses.replace(J_REGISTRY[ARCH], **kw)
        tc = dataclasses.replace(T_REGISTRY[ARCH], **kw)
    else:
        jc = j_reduced(J_REGISTRY[ARCH], layers=layers)
        tc = t_reduced(T_REGISTRY[ARCH], layers=layers)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def numpy_tree(shapes, seed):
    """numpy leaves of the shapes and dtypes of ``shapes`` (a tree of
    ShapeDtypeStructs): dense weights N(0, 1)/sqrt(fan_in) (the gate and
    recurrent weights too), norm scales 1 + N(0, 0.1^2), biases
    N(0, 0.1^2), ``f_bias`` 3 + N(0, 0.5^2) (JAX's init is 3)."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shp = path[-1].key, sd.shape
        if name == "scale":
            a = 1.0 + 0.1 * r.standard_normal(shp)
        elif name == "bias":
            a = 0.1 * r.standard_normal(shp)
        elif name == "f_bias":
            a = 3.0 + 0.5 * r.standard_normal(shp)
        else:
            fan_in = shp[-1] if name == "table" else shp[-2]
            a = r.standard_normal(shp) / np.sqrt(fan_in)
        return np.asarray(a, sd.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def model_pair(published: bool, layers: int = 4, seed: int = 5):
    jc, tc = pair_configs(published, layers)
    jm = j_build(jc)
    tree = numpy_tree(jax.eval_shape(jm.init, jax.random.key(0)), seed)
    tm = t_build(tc, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(tree, tc, "cpu"))


_pairs = {}


def _pair(published):
    if published not in _pairs:
        _pairs[published] = model_pair(published)
    return _pairs[published]


def _close(t, a, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **tol)


# ---------------------------------------------------------------------------
# configs and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-72b",
                                  "jamba-1.5-large-398b"])
def test_configs_match_jax_field_for_field(arch):
    assert dataclasses.asdict(T_REGISTRY[arch]) == \
        dataclasses.asdict(port_config(J_REGISTRY[arch]))
    TT.check_supported(T_REGISTRY[arch])


def test_jamba_expert_cut_differs_in_name_and_experts_only():
    """``jamba-1.5-large-398b-8e``: the published period (MoE at 1, 3, 5,
    7, top-2, expert d_ff 24,576) with 8 of the 16 experts."""
    cut = dataclasses.asdict(T_REGISTRY["jamba-1.5-large-398b-8e"])
    pub = dataclasses.asdict(port_config(J_REGISTRY["jamba-1.5-large-398b"]))
    assert cut["name"] == "jamba-1.5-large-398b-8e"
    assert cut["moe"]["num_experts"] == 8 and pub["moe"]["num_experts"] == 16
    cut["name"], cut["moe"]["num_experts"] = pub["name"], 16
    assert cut == pub
    assert [b.ffn for b in T_REGISTRY["jamba-1.5-large-398b-8e"]
            .block_pattern] == ["dense", "moe"] * 4


@pytest.mark.parametrize("published", [False, True])
def test_cache_leaves_match_jax(published):
    """mLSTM ``{"C", "n", "m"}`` and sLSTM ``{"c", "n", "h", "m"}``: f32,
    JAX's shapes (mLSTM's head width d_inner / H: 384 at published
    width), zero-filled, in either cache layout."""
    jc, tc = pair_configs(published, layers=4)
    want = JT.make_cache(jc, 2, 16, factory=jax.ShapeDtypeStruct)
    for cache in (TT.make_cache(tc, 2, 16, device="cpu"),
                  TT.make_paged_cache(tc, 2, 16, page_size=4, num_blocks=8,
                                      device="cpu")):
        assert set(cache) == set(want)
        for bk, sub in cache.items():
            assert set(sub) == {"ssm_state"}
            leaves = sub["ssm_state"]
            assert set(leaves) == set(want[bk]["ssm_state"])
            for n, t in leaves.items():
                sd = want[bk]["ssm_state"][n]
                assert tuple(t.shape) == sd.shape and t.dtype == \
                    torch.float32 and sd.dtype == jnp.float32, (bk, n)
                assert not t.any()
    assert not TT.has_paged_layers(tc)
    if published:
        assert want["b0"]["ssm_state"]["C"].shape == (1, 2, 4, 384, 384)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_bridge_keeps_leaf_dtypes_in_bf16():
    """At bf16 params the bridged tree has the port's own init's leaves,
    shapes and dtypes: the projections bf16, and mLSTM's ``w_i``, ``w_f``,
    ``f_bias``, ``out_norm`` and sLSTM's ``w_h``, ``bias``, ``f_bias`` f32,
    as JAX keeps them."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    jc = dataclasses.replace(j_reduced(J_REGISTRY[ARCH], layers=4), **kw)
    tc = dataclasses.replace(t_reduced(T_REGISTRY[ARCH], layers=4), **kw)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    tree = numpy_tree(jax.eval_shape(jm.init, jax.random.key(0)), 2)
    got = dict(_leaves(params_from_numpy(tree, tc, "cpu")))
    want = dict(_leaves(tm.init(torch.Generator().manual_seed(0))))
    assert set(got) == set(want)
    for path, t in want.items():
        assert (got[path].shape, got[path].dtype) == (t.shape, t.dtype), path
    f32 = {p[-1] for p, t in want.items() if t.dtype == torch.float32}
    assert {"w_i", "w_f", "f_bias", "scale", "w_h", "bias"} <= f32
    assert {p[-1] for p, t in want.items() if t.dtype == torch.bfloat16} \
        >= {"up_proj", "wq", "wk", "wv", "down_proj", "w_x", "up", "down",
            "table"}


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

MIXERS = {"mlstm": (JS.init_mlstm, JS.apply_mlstm, TS.apply_mlstm,
                    JS.mlstm_state_shape),
          "slstm": (JS.init_slstm, JS.apply_slstm, TS.apply_slstm,
                    JS.slstm_state_shape)}


@pytest.mark.parametrize("start", ["none", "zero", "carried"])
@pytest.mark.parametrize("published", [False, True])
@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_matches_jax(mixer, published, start):
    """One mixer on (2, 16, d) numpy inputs: outputs within 1e-5 of JAX's,
    returned states within 1e-5 of the leaf's largest magnitude (mLSTM's
    C sums outer products whose terms cancel below their f32 rounding in
    the projections, which XLA and torch sum in different orders: at
    published width 2 of its 1.2 M elements stray 1.2e-5 from JAX's).
    ``none``: no state (m from -1e30); ``zero``: a zero state (the
    cache's: m from 0); ``carried``: the state a first 16-step chunk
    returned, through a second chunk."""
    jinit, japply, tapply, jshape = MIXERS[mixer]
    jc, tc = pair_configs(published)
    shapes = jax.eval_shape(lambda k: jinit(k, jc), jax.random.key(0))
    tree = numpy_tree(shapes, 7)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = jax.tree.map(lambda a: tensor_from_numpy(a, "cpu"), tree)
    r = np.random.default_rng(8)
    xs = [r.standard_normal((2, 16, jc.d_model)).astype(np.float32)
          for _ in range(2)]
    jstate = tstate = None
    if start == "zero":
        zeros = {n: np.zeros(s, np.float32)
                 for n, s in jshape(jc, 2).items()}
        jstate = {n: jnp.asarray(a) for n, a in zeros.items()}
        tstate = {n: torch.from_numpy(a) for n, a in zeros.items()}
    elif start == "carried":
        _, jstate = japply(jp, jnp.asarray(xs[0]), jc)
        _, tstate = tapply(tp, torch.from_numpy(xs[0]), tc)
        xs = xs[1:]
    jy, jnew = japply(jp, jnp.asarray(xs[0]), jc, state=jstate)
    ty, tnew = tapply(tp, torch.from_numpy(xs[0]), tc, state=tstate)
    _close(ty, jy, MIXER_TOL)
    assert set(tnew) == set(jnew)
    for n in tnew:
        assert tnew[n].dtype == torch.float32
        ref = np.asarray(jnew[n])
        np.testing.assert_allclose(tnew[n].numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_fresh_state_and_zero_cache_differ_as_in_jax():
    """No state starts the stabilizer at -1e30, a zero cache at 0: the
    outputs are close and not identical, on both sides alike."""
    jc, tc = pair_configs(False)
    shapes = jax.eval_shape(lambda k: JS.init_mlstm(k, jc), jax.random.key(0))
    tree = numpy_tree(shapes, 9)
    tp = jax.tree.map(lambda a: tensor_from_numpy(a, "cpu"), tree)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 6, jc.d_model)).astype(np.float32))
    fresh, _ = TS.apply_mlstm(tp, x, tc)
    zero = {n: torch.zeros(s) for n, s in TS.mlstm_state_shape(tc, 1).items()}
    cached, _ = TS.apply_mlstm(tp, x, tc, state=zero)
    assert not torch.equal(fresh, cached)
    np.testing.assert_allclose(fresh.numpy(), cached.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("published", [False, True])
def test_forward_matches_jax(published):
    jm, jp, tm, tp = _pair(published)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert "head" not in tp                              # tied head
    toks = np.random.default_rng(1).integers(
        1, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(tp, {"tokens": toks})
    _close(tl, jl, MODEL_TOL)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl, -1)))
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("published", [False, True])
def test_prefill_and_decode_match_jax_and_forward(published):
    """prefill(T) then K decode steps, lock-step and per-slot: logits
    within the model tolerance of JAX's and of the full forward at the
    same positions (``tests/test_models.py``'s pattern), the caches'
    states of JAX's."""
    jm, jp, tm, tp = _pair(published)
    t_, k_ = 12, 4
    toks = np.random.default_rng(2).integers(
        1, tm.cfg.vocab_size, (2, t_ + k_)).astype(np.int32)
    full, _ = tm.forward(tp, {"tokens": toks})
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :t_])}, 32)
    tl, tc = tm.prefill(tp, {"tokens": toks[:, :t_]}, 32)
    _close(tl, jl, MODEL_TOL)
    _close(tl[:, 0], full[:, t_ - 1], MODEL_TOL)
    step = jax.jit(jm.decode_step)
    for t in range(t_, t_ + k_):
        cur = toks[:, t:t + 1]
        if t % 2:
            vec = np.full((2,), t, np.int32)
            jl, jc = step(jp, jc, jnp.asarray(cur), jnp.asarray(vec))
            tl, tc = tm.decode_step(tp, tc, cur, torch.from_numpy(vec))
        else:
            jl, jc = step(jp, jc, jnp.asarray(cur), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, cur, t)
        _close(tl, jl, MODEL_TOL)
        _close(tl[:, 0], full[:, t], MODEL_TOL)
    for bk, sub in tc.items():
        for n, leaf in sub["ssm_state"].items():
            _close(leaf, jc[bk]["ssm_state"][n], MODEL_TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

# one prompt length (9: the plan's chunks of 4 are 4, 4, 1); the third
# request waits for a slot of two
SCHED = [(np.array([3, 9, 4, 1, 7, 2, 8, 5, 6], np.int32), 6, 0),
         (np.array([9, 3, 7, 3, 9, 1, 1, 4, 2], np.int32), 5, 0),
         (np.array([4, 4, 8, 2, 6, 6, 3, 1, 9], np.int32), 4, 2)]
MAX_SEQ = 64


@pytest.fixture(scope="module")
def engines():
    """The reduced xlstm at 8 layers (2 groups), the JAX engine's streams
    and the port's one-shot gold."""
    jm, jp, tm, tp = model_pair(False, layers=8, seed=13)
    jeng, jgot = run_staggered(JEngine, JRequest, jm, jp, 2, sched=SCHED,
                               max_seq=MAX_SEQ)
    assert jeng.prefill_bucket == 1
    golds = [gold_decode(tm, tp, p, mn, MAX_SEQ) for p, mn, _ in SCHED]
    return tm, tp, jgot, golds


def _plan(tm, replicas, stages=2):
    return TP.lower_serving(TP.uniform_plan(tm.cfg.num_groups, stages,
                                            n_microbatches=replicas),
                            slots=2, chunk=4)


MODES = {"dense": lambda tm: {},
         "paged": lambda tm: dict(paged=True, page_size=4),
         "plan": lambda tm: dict(plan=_plan(tm, 2)),
         "overlap": lambda tm: dict(overlap=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_jax_engine_and_gold(engines, mode):
    """Every stream equals the JAX engine's and the gold: exact-length
    prefill (a recurrent state would fold pad tokens in), ``paged=True``
    running dense (no KV to page), the plan's chunks carrying the mLSTM
    and sLSTM state, the overlapped runtime."""
    tm, tp, jgot, golds = engines
    eng, got = run_staggered(ServingEngine, Request, tm, tp, 2, sched=SCHED,
                             max_seq=MAX_SEQ, **MODES[mode](tm))
    assert eng.prefill_bucket == 1
    assert not eng.paged and eng.cache_stats()["layout"] == "dense"
    if mode == "plan":
        assert eng.prefill_chunk_counts == [3] * len(SCHED)
    assert eng._overlap == (mode == "overlap")
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"{mode} uid={uid}"
        assert got[uid] == jgot[uid], f"{mode} uid={uid}"


def test_speculation_is_gated_off(engines):
    """A verify window cannot replay a recurrent state: ``speculate=4``
    gives no spec steps, and the streams stay the gold's."""
    tm, tp, _, golds = engines
    eng, got = run_staggered(ServingEngine, Request, tm, tp, 2, sched=SCHED,
                             max_seq=MAX_SEQ, speculate=4)
    assert eng._spec_k == 0 and eng.stats()["spec_steps"] == 0
    assert [got[u] for u in range(len(SCHED))] == golds


def test_replan_migrates_the_state_row(engines):
    """Two requests decode on slots 0 and 1 of a 4-slot engine; a re-plan
    onto a 1-stage plan of 2 replicas (replica 0: slots 0 and 1) moves
    one slot, whose mLSTM and sLSTM state is a dense row: one copy a
    migration, and the streams stay the gold's."""
    tm, tp, _, golds = engines
    eng = ServingEngine(tm, tp, slots=4, max_seq=MAX_SEQ)
    for uid, (p, mn, _) in enumerate(SCHED[:2]):
        eng.submit(Request(uid, p, mn))
    for _ in range(2):
        eng.tick()
    assert [s for s in range(4) if eng._slot_req[s] is not None] == [0, 1]
    eng.replan(TP.lower_serving(TP.uniform_plan(tm.cfg.num_groups, 1,
                                                n_microbatches=2),
                                slots=4, chunk=4))
    moved = [s for s in range(4) if eng._slot_req[s] is not None]
    assert moved[1] >= 2
    got = {r.uid: r.out_tokens for r in eng.run()}
    st = eng.stats()
    assert st["replans"] == 1
    assert st["migration_copies"] == st["migrations"] >= 1
    for uid in range(2):
        assert got[uid] == golds[uid], f"uid={uid}"


def test_launcher_serves_xlstm(capsys):
    """``repro_torch.launch.serve --arch xlstm-125m`` at published width, 4
    layers, on the CPU: ``--paged`` falls back to the dense layout and
    the line says ``ffn=none``."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--layers", "4", "--device", "cpu",
                "--paged", "--requests", "2", "--slots", "2",
                "--new-tokens", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert "[serve] 2 requests, 6 tokens" in out and "ffn=none" in out
    assert "paged p" not in out
