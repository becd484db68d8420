"""The port's model against the JAX model on the same (bridged) weights.

JAX draws the weights; ``repro_torch.bridge.params_from_numpy`` carries
them across.  Then the same tokens go through both: the full forward, a
dense prefill followed by lock-step and per-slot dense decode, and a
paged suffix prefill (cold and warm) followed by paged decode through the
fused kernel's front door, on fp and int8 pools; then a speculative
verify window of K+1 tokens per slot at per-slot positions, on the dense
cache and on fp and int8 pools.  Two shapes: ``reduced(yi-6b,
layers=2)`` (head_dim 16) and a head_dim-128 variant.

Tolerance: f32 logits at atol = rtol = 1e-4 (random weights give logits
of order 1-10; the frameworks sum in different orders through two layers
of matmuls), and greedy tokens must be identical.  In bf16, the MLP and
mamba layers are held to JAX's on the same bf16 weights: at most 1% of
the bf16 outputs differ, none by more than one bf16 ulp, and mamba's f32
state at rtol 1e-5 (the f32 accumulators JAX keeps, kept).  int8 rows must be
equal; their scales, which are amax/127 of activations, are held to the
logits' tolerance.
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
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
HD128 = dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=128)


def _pair(variant):
    jc = j_reduced(J_REGISTRY["yi-6b"], layers=2)
    tc = t_reduced(T_REGISTRY["yi-6b"], layers=2)
    if variant == "hd128":
        jc = dataclasses.replace(jc, **HD128)
        tc = dataclasses.replace(tc, **HD128)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm = j_build(jc)
    jp = jm.init(jax.random.key(7))
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=["reduced", "hd128"])
def pair(request):
    return _pair(request.param)


def _close(t, a):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **TOL)


def test_bridge_keeps_bf16_exact():
    from repro_torch.bridge import tensor_from_numpy
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  np.asarray(x, np.float32))


def test_param_counts_match(pair):
    jm, jp, tm, tp = pair
    assert tm.param_count(tp) == jm.param_count(jp)


def test_forward_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(
        1, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl, -1)))


def test_prefill_and_dense_decode_match_jax(pair):
    """Lock-step (scalar position) and per-slot (vector) dense decode."""
    jm, jp, tm, tp = pair
    max_seq = 32
    toks = np.random.default_rng(2).integers(
        1, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tc = tm.prefill(tp, {"tokens": toks}, max_seq)
    _close(tl, jl)
    pos = toks.shape[1]
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        if step % 2 == 0:
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
            tl, tc = tm.decode_step(tp, tc, nxt, pos)
        else:
            vec = np.full((2,), pos, np.int32)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                    jnp.asarray(vec))
            tl, tc = tm.decode_step(tp, tc, nxt, torch.from_numpy(vec))
        _close(tl, jl)
        pos += 1
    _close(tc["b0"]["kv"]["k"], jc["b0"]["kv"]["k"])


def _assert_pools(tcache, jcache):
    for name, t in tcache["b0"]["kv"].items():
        a = jcache["b0"]["kv"][name]
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        else:
            _close(t, a)


def _admit_two(jm, jp, tm, tp, kv_dtype, page=4, nb=8, max_seq=32,
               num_blocks=16):
    """Cold admission into slot 0, warm admission (offset > 0, shared
    first page, sentinel write entry) into slot 1.  Returns the caches,
    tables, first tokens and the prompt."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, tm.cfg.vocab_size, 10).astype(np.int32)
    jcache = jm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    tcache = tm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    sentinel = num_blocks
    bt = np.full((2, nb), sentinel, np.int32)
    bt[0, :4] = [5, 2, 9, 1]
    bt[1, :4] = [5, 11, 7, 13]         # slot 1 shares slot 0's first page
    wt1 = bt[1:2].copy()
    wt1[0, 0] = sentinel               # the shared page is never written
    admissions = [(0, 0, prompt, bt[0:1], bt[0:1]),
                  (1, 4, prompt[4:], bt[1:2], wt1)]
    first = []
    for slot, offset, suffix, btab, wtab in admissions:
        toks = np.zeros((1, len(suffix) + 2), np.int32)   # right-padded
        toks[0, :len(suffix)] = suffix
        jl, jcache = jm.prefill_suffix_paged(
            jp, jcache, jnp.asarray(toks), slot, jnp.int32(offset),
            jnp.int32(len(suffix)), max_seq, jnp.asarray(btab),
            jnp.asarray(wtab))
        tl, tcache = tm.prefill_suffix_paged(
            tp, tcache, toks, slot, offset, len(suffix), max_seq, btab, wtab)
        _close(tl, jl)
        first.append(int(tl[0, -1].argmax()))
    return jcache, tcache, bt, first, prompt


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_suffix_prefill_and_fused_decode_match_jax(pair, kv_dtype):
    """Cold and warm paged admissions, then batched paged decode at
    per-slot positions through the fused front door -- logits, tokens and
    pools (int8 rows and their scales on int8 pools)."""
    jm, jp, tm, tp = pair
    jcache, tcache, bt, first, _ = _admit_two(jm, jp, tm, tp, kv_dtype)
    assert first[0] == first[1]        # same prompt, cold and warm
    _assert_pools(tcache, jcache)
    cur = np.array([[first[0]], [first[1]]], np.int32)
    pos = np.array([10, 10], np.int32)
    for _ in range(4):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(cur),
                                    jnp.asarray(pos),
                                    block_tables=jnp.asarray(bt))
        tl, tcache = tm.decode_step(tp, tcache, cur, torch.from_numpy(pos),
                                    block_tables=bt)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
        cur = nxt[:, None]
        pos = pos + 1
    _assert_pools(tcache, jcache)


@pytest.mark.parametrize("cache", ["dense", "fp", "int8"])
def test_verify_window_decode_matches_jax(pair, cache):
    """A (B, K+1) verify window at per-slot positions (slot 0 crosses a
    page boundary, slot 1's window runs past its mapped blocks into the
    drop sentinel) -- logits of every window position and the caches."""
    jm, jp, tm, tp = pair
    window = np.array([[7, 3, 9, 1, 4], [2, 8, 8, 5, 6]], np.int32)
    if cache == "dense":
        toks = np.random.default_rng(4).integers(
            1, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
        _, tcache = tm.prefill(tp, {"tokens": toks}, 32)
        pos = np.array([9, 6], np.int32)
        kw_j = kw_t = {}
    else:
        jcache, tcache, bt, _, _ = _admit_two(jm, jp, tm, tp, cache)
        bt[1, 3] = 16                  # slot 1's window passes its table
        pos = np.array([10, 9], np.int32)
        kw_j = dict(block_tables=jnp.asarray(bt))
        kw_t = dict(block_tables=bt)
    jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(window),
                                jnp.asarray(pos), **kw_j)
    tl, tcache = tm.decode_step(tp, tcache, window, torch.from_numpy(pos),
                                **kw_t)
    assert tl.shape == (2, 5, tm.cfg.vocab_size)
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl, -1)))
    if cache == "dense":
        _close(tcache["b0"]["kv"]["k"], jcache["b0"]["kv"]["k"])
    else:
        _assert_pools(tcache, jcache)


# ---------------------------------------------------------------------------
# the jamba hybrid (mamba + rope-free attention, dense FFNs)
# ---------------------------------------------------------------------------

HYBRID = "jamba-1.5-large-398b-dense-ffn"


def hybrid_configs(layers=8):
    """The reduced jamba-dense-ffn config on both sides: the port's
    registry variant, and on the JAX side the reduced published jamba
    with every FFN dense (no JAX file knows the variant)."""
    tc = t_reduced(T_REGISTRY[HYBRID], layers=layers)
    jc = dataclasses.replace(
        j_reduced(J_REGISTRY["jamba-1.5-large-398b"], layers=layers),
        name=tc.name, moe=None, block_pattern=tc.block_pattern)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def numpy_params(jm, seed):
    """JAX-layout params drawn with numpy (JAX's init runs for seconds on
    a hybrid): the leaf shapes and dtypes of ``jm.init``, dense weights
    N(0, 1)/sqrt(fan_in), and JAX's init constants for the norm scales and
    mamba's conv_b, dt_bias, A_log and D."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shp = path[-1].key, sd.shape
        if name in ("scale", "D"):
            a = np.ones(shp)
        elif name == "conv_b":
            a = np.zeros(shp)
        elif name == "dt_bias":
            a = np.full(shp, -4.6)
        elif name == "A_log":
            a = np.broadcast_to(np.log(np.arange(1, shp[-1] + 1)), shp)
        else:
            fan_in = shp[-1] if name == "table" else shp[-2]
            a = r.standard_normal(shp) / np.sqrt(fan_in)
        return np.asarray(a, sd.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jm.init, jax.random.key(0)))


@pytest.fixture(scope="module")
def hybrid():
    jc, tc = hybrid_configs()
    jm = j_build(jc)
    tree = numpy_params(jm, 5)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(tree, tc, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def jitted(hybrid):
    """The JAX model's methods, jitted once for the module (eager JAX
    re-traces every layer scan on every call)."""
    jm = hybrid[0]
    return dict(forward=jax.jit(jm.forward),
                prefill=jax.jit(jm.prefill, static_argnums=(2,)),
                decode=jax.jit(jm.decode_step),
                suffix=jax.jit(jm.prefill_suffix_paged,
                               static_argnums=(6,)))


def _assert_states(tcache, jcache):
    """Every mamba slot's conv and ssm leaves, and their f32 dtype."""
    for bk, sub in tcache.items():
        if "ssm_state" in sub:
            for name, t in sub["ssm_state"].items():
                assert t.dtype == torch.float32
                _close(t, jcache[bk]["ssm_state"][name])


def test_hybrid_param_counts_and_bridge_match(hybrid):
    """Counts equal, and the f32 mamba leaves cross the bridge exactly."""
    jm, jp, tm, tp = hybrid
    assert tm.param_count(tp) == jm.param_count(jp)
    for name in ("in_proj", "conv_w", "dt_proj", "A_log", "D", "out_proj"):
        t = tp["stack"][0]["b0"]["mixer"][name]
        a = np.asarray(jp["stack"]["b0"]["mixer"][name])[0]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)


def test_hybrid_init_keeps_jax_shapes_and_constants(hybrid):
    """The port's own init: JAX's leaf shapes and dtypes, and its
    constants (A_log to 1 ulp: the two logs may round apart)."""
    jm, jp, tm, _ = hybrid
    tp = tm.init(torch.Generator().manual_seed(0))
    assert tm.param_count(tp) == jm.param_count(jp)
    mix_j = jax.tree.map(lambda a: np.asarray(a)[0],
                         jp["stack"]["b0"]["mixer"])
    mix_t = tp["stack"][0]["b0"]["mixer"]
    assert set(mix_t) == set(mix_j)
    for name, a in mix_j.items():
        assert tuple(mix_t[name].shape) == a.shape, name
        assert str(mix_t[name].dtype)[6:] == str(a.dtype), name
    for name in ("conv_b", "dt_bias", "D"):
        np.testing.assert_array_equal(mix_t[name].numpy(), mix_j[name])
    np.testing.assert_allclose(mix_t["A_log"].numpy(), mix_j["A_log"],
                               rtol=1.2e-7, atol=0)


def _mamba_pair(hybrid, seed, s):
    from repro.models import ssm as JS
    from repro_torch.models import ssm as TSM
    jm, jp, tm, tp = hybrid
    pj = jax.tree.map(lambda a: a[0], jp["stack"]["b0"]["mixer"])
    pt = tp["stack"][0]["b0"]["mixer"]
    x = np.random.default_rng(seed).standard_normal(
        (2, s, tm.cfg.d_model)).astype(np.float32)
    return JS, TSM, pj, pt, x, jm.cfg, tm.cfg


def test_apply_mamba_prefill_matches_jax_chunked(hybrid, monkeypatch):
    """Prefill against JAX's materialized-scan branch (REPRO_MAMBA=chunked):
    atol = rtol = 1e-5.  The port prefills through its fused selective
    scan, whose plain version steps through t with that branch's
    arithmetic (exp(delta A), (delta x) B, a h + b, then C . h)."""
    JS, TSM, pj, pt, x, jc, tc = _mamba_pair(hybrid, 11, 12)
    monkeypatch.setenv("REPRO_MAMBA", "chunked")
    jy, jst = JS.apply_mamba(pj, jnp.asarray(x), jc)
    ty, tst = TSM.apply_mamba(pt, torch.from_numpy(x), tc)
    tight = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tight)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                   **tight)


def _bf16_ulp(a):
    """One bf16 ulp at each magnitude of ``a`` (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_bf16_within_one_ulp(t, a, share=0.01):
    """At most ``share`` of the bf16 elements differ from JAX's, and none
    by more than one bf16 ulp (the frameworks sum in different orders).
    An element's ulp is taken at its own magnitude or at the output's RMS,
    whichever is larger: an element that cancels to near zero carries the
    rounding of the terms that summed to it, not of its own size."""
    t = t.to(torch.float32).numpy()
    a = np.asarray(a, np.float32)
    diff = np.abs(t - a)
    rms = np.sqrt(np.mean(np.square(a)))
    ulp = _bf16_ulp(np.maximum(np.maximum(np.abs(t), np.abs(a)), rms))
    assert (diff > 0).mean() <= share, (
        f"{(diff > 0).mean():.2%} of elements differ (max {diff.max():.3g})")
    assert (diff <= ulp).all(), (
        f"{(diff > ulp).sum()} elements differ by more than one ulp (max "
        f"difference {diff.max():.3g})")


def test_apply_mlp_bf16_keeps_jax_f32_accumulators():
    """bf16 gated MLP of the yi-6b family (reduced: d_model 512, d_ff 1376;
    32 tokens) against JAX's on the same bf16 weights.  JAX keeps the
    hidden and gate products as f32 accumulators and forms silu(gate) *
    hid in f32; so does the port (``matmul_f32``).  The tree before that
    repair rounded both products to bf16 first and fails this test: 61%
    of the output elements differed, by up to 0.0156."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    kw = dict(d_ff=1376, dtype="bfloat16", param_dtype="bfloat16")
    jc = dataclasses.replace(j_reduced(J_REGISTRY["yi-6b"], layers=2,
                                       d_model=512), **kw)
    tc = dataclasses.replace(t_reduced(T_REGISTRY["yi-6b"], layers=2,
                                       d_model=512), **kw)
    pj = JL.init_mlp(jax.random.key(3), jc)
    pt = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in pj.items()}
    assert all(t.dtype == torch.bfloat16 for t in pt.values())
    xj = jnp.asarray(np.random.default_rng(21).standard_normal((2, 16, 512)),
                     jnp.bfloat16)
    ty = TL.apply_mlp(pt, tensor_from_numpy(np.asarray(xj), "cpu"), tc)
    jy = JL.apply_mlp(pj, xj, jc)
    assert ty.dtype == torch.bfloat16
    _assert_bf16_within_one_ulp(ty, jy)


def test_apply_mamba_bf16_keeps_jax_f32_x_projection(monkeypatch):
    """bf16 mamba prefill of the reduced hybrid (12 tokens) against JAX's
    materialized-scan branch (REPRO_MAMBA=chunked) on the same bf16
    weights.  JAX keeps the x projection's f32 accumulator, and so does
    the port (``matmul_f32``): the f32 SSM state agrees at rtol 1e-5
    (with an absolute floor of 1e-5 of the state's largest magnitude, for
    elements near zero) and the bf16 output within one bf16 ulp.  The
    tree before that repair rounded the x projection to bf16 and fails
    this test: 1840 of the state's 2048 elements left that tolerance (max
    absolute difference 3.4e-4)."""
    from repro.models import ssm as JS
    from repro_torch.models import ssm as TSM
    jc, tc = (dataclasses.replace(c, dtype="bfloat16",
                                  param_dtype="bfloat16")
              for c in hybrid_configs())
    tree = numpy_params(j_build(jc), 5)
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["stack"]["b0"]["mixer"])
    pt = params_from_numpy(tree, tc, "cpu")["stack"][0]["b0"]["mixer"]
    assert pt["x_proj"].dtype == torch.bfloat16
    xj = jnp.asarray(np.random.default_rng(22).standard_normal(
        (2, 12, tc.d_model)), jnp.bfloat16)
    monkeypatch.setenv("REPRO_MAMBA", "chunked")
    jy, jst = JS.apply_mamba(pj, xj, jc)
    ty, tst = TSM.apply_mamba(pt, tensor_from_numpy(np.asarray(xj), "cpu"),
                              tc)
    assert tst["ssm"].dtype == torch.float32
    js = np.asarray(jst["ssm"])
    np.testing.assert_allclose(tst["ssm"].numpy(), js, rtol=1e-5,
                               atol=1e-5 * np.abs(js).max())
    _assert_bf16_within_one_ulp(ty, jy)


def test_apply_mamba_prefill_matches_jax_fused_default(hybrid, monkeypatch):
    """Prefill against JAX's default fused chunk scan, at JAX's own
    fused-vs-chunked tolerance (tests/test_perf_paths.py): 2e-4."""
    JS, TSM, pj, pt, x, jc, tc = _mamba_pair(hybrid, 12, 20)
    monkeypatch.delenv("REPRO_MAMBA", raising=False)
    jy, jst = JS.apply_mamba(pj, jnp.asarray(x), jc)
    ty, tst = TSM.apply_mamba(pt, torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]),
                               atol=2e-4, rtol=2e-4)


def test_apply_mamba_decode_step_with_state_matches_jax(hybrid):
    """One S = 1 step from a carried f32 state (the decode path: the scan
    at S = 1 with h0, the conv mixing its f32 history with the step's
    input)."""
    JS, TSM, pj, pt, x, jc, tc = _mamba_pair(hybrid, 13, 1)
    r = np.random.default_rng(14)
    shapes = JS.mamba_state_shape(jc, 2)
    assert shapes == TSM.mamba_state_shape(tc, 2)
    st = {k: r.standard_normal(v).astype(np.float32)
          for k, v in shapes.items()}
    jy, jst = JS.apply_mamba(pj, jnp.asarray(x), jc,
                             {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = TSM.apply_mamba(pt, torch.from_numpy(x), tc,
                              {k: torch.from_numpy(v) for k, v in st.items()})
    _close(ty, jy)
    for name in ("conv", "ssm"):
        assert tst[name].dtype == torch.float32
        _close(tst[name], jst[name])


def test_hybrid_forward_logits_match_jax(hybrid, jitted):
    jm, jp, tm, tp = hybrid
    toks = np.random.default_rng(15).integers(
        1, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = jitted["forward"](jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl, -1)))


def test_hybrid_prefill_and_dense_decode_match_jax(hybrid, jitted):
    """Dense prefill, then lock-step and per-slot decode: logits, the
    attention cache and every mamba state leaf."""
    jm, jp, tm, tp = hybrid
    toks = np.random.default_rng(16).integers(
        1, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jitted["prefill"](jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": toks}, 32)
    _close(tl, jl)
    _assert_states(tc, jc)
    pos = toks.shape[1]
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        idx_j, idx_t = (jnp.int32(pos), pos) if step % 2 == 0 else (
            jnp.full((2,), pos, jnp.int32),
            torch.full((2,), pos, dtype=torch.int32))
        jl, jc = jitted["decode"](jp, jc, jnp.asarray(nxt), idx_j)
        tl, tc = tm.decode_step(tp, tc, nxt, idx_t)
        _close(tl, jl)
        pos += 1
    _close(tc["b3"]["kv"]["k"], jc["b3"]["kv"]["k"])
    _assert_states(tc, jc)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_hybrid_paged_prefill_and_unfused_decode_match_jax(hybrid, jitted,
                                                           kv_dtype):
    """Cold paged admissions of two 9-token prompts into slots 0 and 1
    (the mamba state in a batch-1 part landing in the slot's row), then
    per-slot paged decode through the unfused kernel's front door, the
    writes crossing a page boundary (position 12): logits, tokens, the
    attention pools (int8 rows equal) and every mamba state leaf."""
    jm, jp, tm, tp = hybrid
    page, nb, max_seq, num_blocks = 4, 8, 32, 16
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, tm.cfg.vocab_size, 9).astype(np.int32)
               for _ in range(2)]
    jcache = jm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    tcache = tm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    bt = np.full((2, nb), num_blocks, np.int32)
    bt[0, :4] = [5, 2, 9, 1]
    bt[1, :4] = [3, 11, 7, 13]
    cur = []
    for slot, p in enumerate(prompts):
        toks = p[None]                       # exact length: no padding
        jl, jcache = jitted["suffix"](
            jp, jcache, jnp.asarray(toks), slot, jnp.int32(0),
            jnp.int32(len(p)), max_seq, jnp.asarray(bt[slot:slot + 1]),
            jnp.asarray(bt[slot:slot + 1]))
        tl, tcache = tm.prefill_suffix_paged(
            tp, tcache, toks, slot, 0, len(p), max_seq, bt[slot:slot + 1],
            bt[slot:slot + 1])
        _close(tl, jl)
        cur.append(int(tl[0, -1].argmax()))
    _assert_pools(_attn_view(tcache), _attn_view(jcache))
    _assert_states(tcache, jcache)
    cur = np.array(cur, np.int32)[:, None]
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(4):
        jl, jcache = jitted["decode"](jp, jcache, jnp.asarray(cur),
                                      jnp.asarray(pos), None,
                                      jnp.asarray(bt))
        tl, tcache = tm.decode_step(tp, tcache, cur, torch.from_numpy(pos),
                                    block_tables=bt)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
        cur, pos = nxt[:, None], pos + 1
    _assert_pools(_attn_view(tcache), _attn_view(jcache))
    _assert_states(tcache, jcache)


def _attn_view(cache):
    """The attention slot's pools, under the key ``_assert_pools`` reads."""
    return {"b0": cache["b3"]}


# the encoder, vision and recurrent families: each builds
LATER_FAMILIES = ("xlstm-125m", "whisper-base", "qwen2-vl-72b", "deit-t",
                  "lv-vit-t")
# built by the port, but refused by per-slot serving, as JAX refuses them
NOT_PER_SLOT = ("whisper-base", "qwen2-vl-72b", "deit-t", "lv-vit-t")
PER_SLOT = "per-slot prefill"      # both packages' refusal names it


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "yi-6b",
                                  "gemma2-9b", *LATER_FAMILIES])
def test_check_supported_lets_only_served_blocks_through(arch):
    """Every config of the port's registry builds, the published jamba
    with its MoE layers, gemma2, xlstm-125m and qwen2-vl too; yi-6b with
    MoE FFNs, LayerNorm, a plain squared-ReLU MLP, a gated GELU MLP, a
    tied head, post-block norms, a final softcap, local-window mixers,
    xLSTM mixers, blocks without an FFN, M-RoPE or qk-norm builds; an
    unknown mixer, FFN, family or activation raises.  xlstm-125m's
    engine constructs and serves.  whisper, qwen2-vl, deit and lv-vit
    build, and per-slot serving refuses them with NotImplementedError, as
    JAX's does: ``prefill_one`` and the dense and paged
    ``ServingEngine`` on the port's side, ``prefill_one`` and the engine
    on JAX's."""
    from types import SimpleNamespace

    from repro_torch.configs.base import BlockSpec, MoEConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServingEngine
    for name in T_REGISTRY:
        T.check_supported(T_REGISTRY[name])
    assert set(J_REGISTRY) <= set(T_REGISTRY)
    if arch in NOT_PER_SLOT:
        _assert_per_slot_serving_refused(arch)
        return
    cfg = T_REGISTRY[arch]
    t_build(cfg, device="cpu")
    if arch == "xlstm-125m":
        tm = t_build(t_reduced(cfg, layers=4), device="cpu")
        tp = tm.init(torch.Generator().manual_seed(0))
        for paged in (False, True):
            eng = ServingEngine(tm, tp, slots=2, max_seq=16, paged=paged,
                                page_size=8)
            eng.submit(Request(0, np.arange(1, 6, dtype=np.int32), 2))
            assert not eng.paged
            assert [len(r.out_tokens) for r in eng.run()] == [2]
    if arch == "yi-6b":
        for kw in (dict(block_pattern=(BlockSpec("attn", "moe"),),
                        moe=MoEConfig(num_experts=4, expert_d_ff=64)),
                   dict(norm_kind="layernorm"),
                   dict(mlp_activation="relu2", gated_mlp=False),
                   dict(mlp_activation="gelu"),
                   dict(tie_embeddings=True),
                   dict(post_block_norm=True, final_logit_softcap=30.0),
                   dict(block_pattern=(BlockSpec("attn_local", "dense"),
                                       BlockSpec("attn_global", "dense")),
                        num_layers=2)):
            T.check_supported(dataclasses.replace(cfg, **kw))
        for blk in (BlockSpec("mlstm", "dense"), BlockSpec("slstm", "dense"),
                    BlockSpec("attn", "none")):
            T.check_supported(dataclasses.replace(cfg, block_pattern=(blk,)))
        for kw in (dict(mrope_sections=(16, 24, 24)), dict(qk_norm=True)):
            T.check_supported(dataclasses.replace(cfg, **kw))
        # BlockSpec itself asserts its kinds: stand-ins carry unknown ones
        for kw in (dict(block_pattern=(SimpleNamespace(mixer="rwkv",
                                                       ffn="dense"),)),
                   dict(block_pattern=(SimpleNamespace(mixer="attn",
                                                       ffn="glu"),)),
                   dict(mlp_activation="tanh"), dict(family="vlm"),
                   dict(norm_kind="batchnorm")):
            with pytest.raises(NotImplementedError):
                T.check_supported(dataclasses.replace(cfg, **kw))


def _assert_per_slot_serving_refused(arch):
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine
    from repro_torch.serving import Request, ServingEngine
    jc = j_reduced(J_REGISTRY[arch], layers=1)
    tc = t_reduced(T_REGISTRY[arch], layers=1)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    tm = t_build(T_REGISTRY[arch], device="cpu")
    assert tm.cfg is T_REGISTRY[arch]
    tm = t_build(tc, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jm = j_build(jc)
    jp = jm.init(jax.random.key(0))
    prompt = np.arange(1, 6, dtype=np.int32)
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        tm.prefill_one(tp, prompt[None], 5, 16)
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        jm.prefill_one(jp, jnp.asarray(prompt[None]), 5, 16)
    for paged in (False, True):
        eng = ServingEngine(tm, tp, slots=2, max_seq=16, paged=paged,
                            page_size=8)
        eng.submit(Request(0, prompt, 2))
        with pytest.raises(NotImplementedError, match=PER_SLOT):
            eng.run()
    jeng = JEngine(jm, jp, slots=2, max_seq=16)
    jeng.submit(JRequest(0, prompt, 2))
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        jeng.run()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["deit-t", "whisper-base"])
def test_launcher_refuses_per_slot_serving_of_encoders(arch, paged):
    """``repro_torch.launch.serve --arch deit-t|whisper-base`` (one layer,
    on the CPU) fails with the per-slot prefill's NotImplementedError, not
    with an unrelated error and not by serving something else."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--layers", "1", "--device", "cpu",
            "--requests", "1", "--slots", "1", "--new-tokens", "2",
            "--max-seq", "16"] + (["--paged", "--page-size", "8"]
                                  if paged else [])
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        serve.main(argv)
