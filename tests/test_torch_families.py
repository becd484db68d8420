"""The non-llama dense and the MoE families of the port against JAX.

Weights are drawn with numpy in the JAX layout (``numpy_tree``: norm
scales near 1 and LayerNorm biases near 0, so that both are exercised)
and carried across by ``repro_torch.bridge.params_from_numpy``.  Layers:
LayerNorm and nemotron's non-gated squared-ReLU MLP in f32 and bf16 (the
f32 accumulators kept), and the tied head (granite-moe: the embedding
table's transpose, no ``head`` leaf).  Models, reduced: qwen2-moe (MoE
with a shared expert), granite-moe (MoE top-2 of 4 at reduced size,
tied head, head_dim 16 like every reduced config), nemotron
(LayerNorm, relu2), yi-34b (llama-style) and the published jamba with
its MoE layers: the parameter count, forward logits and aux loss, a
dense prefill followed by lock-step and per-slot decode, and a cold then
a warm paged suffix prefill followed by paged decode (the fused decode,
or the unfused one for jamba's rope-free attention) on fp and int8
pools.  Engines: qwen2-moe's and nemotron's greedy streams, dense and
paged, equal the JAX engine's and the port's one-shot gold; the MoE
engine prefills at the exact prompt length; a 2-stage plan engine over
qwen2-moe equals JAX's plan engine and prefills each prompt in one
chunk.

Tolerances: f32 at atol = rtol = 1e-4 (``test_torch_model.py``), greedy
tokens identical, int8 rows equal; the aux loss at rtol 1e-5; bf16
layers within one bf16 ulp on at most 1% of the elements.  The engine
schedules use one prompt length: the JAX engine compiles once per
length when it prefills at exact lengths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as JP  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_model import _assert_bf16_within_one_ulp  # noqa: E402
from test_torch_serving import gold_decode, run_staggered  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m", "nemotron-4-15b",
         "yi-34b", "jamba-1.5-large-398b")


def pair_configs(arch, **kw):
    jc = dataclasses.replace(j_reduced(J_REGISTRY[arch]), **kw)
    tc = dataclasses.replace(t_reduced(T_REGISTRY[arch]), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def numpy_tree(jm, seed):
    """JAX-layout params drawn with numpy: the leaf shapes and dtypes of
    ``jm.init``; dense weights (and the f32 router) N(0, 1)/sqrt(fan_in);
    norm scales 1 + N(0, 0.1^2), LayerNorm biases N(0, 0.1^2); mamba's
    conv_b, dt_bias, A_log and D at JAX's init constants."""
    r = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shp = path[-1].key, sd.shape
        if name == "scale":
            a = 1.0 + 0.1 * r.standard_normal(shp)
        elif name == "bias":
            a = 0.1 * r.standard_normal(shp)
        elif name == "D":
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


def build_pair(arch, seed=11):
    jc, tc = pair_configs(arch)
    jm = j_build(jc)
    tree = numpy_tree(jm, seed)
    tm = t_build(tc, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            params_from_numpy(tree, tc, "cpu"))


_pairs = {}


@pytest.fixture(params=ARCHS)
def pair(request):
    if request.param not in _pairs:
        _pairs[request.param] = build_pair(request.param)
    return _pairs[request.param]


def _close(t, a):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **TOL)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_relu2_mlp_match_jax(dtype):
    """nemotron's LayerNorm (scale and bias) and non-gated relu2 MLP at
    d_model 512, d_ff 1376, 32 tokens.  In bf16 JAX keeps the hidden
    product's f32 accumulator through relu2 and so does the port
    (``matmul_f32``)."""
    kw = dict(d_model=512, d_ff=1376, dtype=dtype, param_dtype=dtype)
    jc, tc = pair_configs("nemotron-4-15b", **kw)
    assert tc.norm_kind == "layernorm" and not tc.gated_mlp
    r = np.random.default_rng(3)
    jdt = jnp.dtype(dtype)
    norm = {"scale": jnp.asarray(1 + 0.1 * r.standard_normal(512),
                                 jnp.float32),
            "bias": jnp.asarray(0.1 * r.standard_normal(512), jnp.float32)}
    mlp = {"wi": jnp.asarray(r.standard_normal((512, 1376)) / np.sqrt(512),
                             jdt),
           "wo": jnp.asarray(r.standard_normal((1376, 512)) / np.sqrt(1376),
                             jdt)}
    assert set(TL.init_mlp(torch.Generator().manual_seed(0), tc,
                           "cpu")) == {"wi", "wo"}
    assert set(TL.init_norm(tc, "cpu")) == {"scale", "bias"}
    xj = jnp.asarray(2.0 + r.standard_normal((2, 16, 512)), jdt)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    tn, tw = ({k: tensor_from_numpy(np.asarray(v), "cpu")
               for k, v in tree.items()} for tree in (norm, mlp))
    jh, th = JL.apply_norm(norm, xj, jc), TL.apply_norm(tn, xt, tc)
    jy = JL.apply_mlp(mlp, jh, jc)
    ty = TL.apply_mlp(tw, tensor_from_numpy(np.asarray(jh), "cpu"), tc)
    assert th.dtype == ty.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)
        _close(ty, jy)
    else:
        _assert_bf16_within_one_ulp(th, jh)
        _assert_bf16_within_one_ulp(ty, jy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_head_reads_the_embedding_transpose(dtype):
    """granite-moe ties its head: the port's params hold no ``head``, and
    its logits are x @ table.T with JAX's f32 accumulator."""
    jc, tc = pair_configs("granite-moe-1b-a400m", dtype=dtype,
                          param_dtype=dtype)
    assert tc.tie_embeddings and tc.family == "moe"
    assert "head" not in t_build(tc, device="cpu").init(
        torch.Generator().manual_seed(0))
    r = np.random.default_rng(4)
    jdt = jnp.dtype(dtype)
    table = jnp.asarray(r.standard_normal((tc.vocab_size, tc.d_model))
                        / np.sqrt(tc.d_model), jdt)
    xj = jnp.asarray(r.standard_normal((2, 5, tc.d_model)), jdt)
    jl = JL.logits_head({"table": table}, None, xj, jc)
    tl = TL.logits_head({"table": tensor_from_numpy(np.asarray(table),
                                                    "cpu")}, None,
                        tensor_from_numpy(np.asarray(xj), "cpu"), tc)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_published_param_counts_match_jax(arch):
    """At published size (shapes only: JAX's ``eval_shape``, the port's
    params on the meta device): qwen2-moe 14.316 B, granite-moe 1.335 B,
    nemotron 15.629 B, yi-34b 34.389 B, jamba 398.555 B."""
    shapes = jax.eval_shape(j_build(J_REGISTRY[arch]).init,
                            jax.random.key(0))
    tm = t_build(T_REGISTRY[arch], device="meta")
    assert tm.param_count(tm.init(None)) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_param_counts_and_trees_match(pair):
    jm, jp, tm, tp = pair
    assert tm.param_count(tp) == jm.param_count(jp)
    assert ("head" in tp) == (not tm.cfg.tie_embeddings)


def test_forward_logits_and_aux_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(
        1, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl, -1)))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == (tm.cfg.moe is not None)


def test_prefill_and_dense_decode_match_jax(pair):
    """Lock-step (scalar position) and per-slot (vector) dense decode."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(2).integers(
        1, tm.cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": toks}, 32)
    _close(tl, jl)
    pos = toks.shape[1]
    for step in range(2):
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


def _assert_caches(tcache, jcache):
    """Every leaf of every block: int8 rows equal, the rest close."""
    for bk, sub in tcache.items():
        for key, leaf in sub.items():
            for name, t in leaf.items():
                a = jcache[bk][key][name]
                if t.dtype == torch.int8:
                    np.testing.assert_array_equal(t.numpy(), np.asarray(a))
                else:
                    _close(t, a)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_prefill_and_decode_match_jax(pair, kv_dtype):
    """A cold admission into slot 0 and a warm one (offset 4, the first
    page shared, its write entry the sentinel) into slot 1, right-padded,
    then batched paged decode at per-slot positions: logits, tokens and
    every cache leaf (pools, int8 rows and scales, mamba state)."""
    jm, jp, tm, tp = pair
    max_seq, page, num_blocks = 32, 4, 16
    prompt = np.random.default_rng(3).integers(
        1, tm.cfg.vocab_size, 10).astype(np.int32)
    jcache = jm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    tcache = tm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    bt = np.full((2, 8), num_blocks, np.int32)
    bt[0, :4] = [5, 2, 9, 1]
    bt[1, :4] = [5, 11, 7, 13]
    wt1 = bt[1:2].copy()
    wt1[0, 0] = num_blocks
    cur = []
    for slot, offset, suffix, btab, wtab in ((0, 0, prompt, bt[:1], bt[:1]),
                                             (1, 4, prompt[4:], bt[1:2],
                                              wt1)):
        toks = np.zeros((1, len(suffix) + 2), np.int32)
        toks[0, :len(suffix)] = suffix
        jl, jcache = jm.prefill_suffix_paged(
            jp, jcache, jnp.asarray(toks), slot, jnp.int32(offset),
            jnp.int32(len(suffix)), max_seq, jnp.asarray(btab),
            jnp.asarray(wtab))
        tl, tcache = tm.prefill_suffix_paged(
            tp, tcache, toks, slot, offset, len(suffix), max_seq, btab, wtab)
        _close(tl, jl)
        cur.append([int(tl[0, -1].argmax())])
    _assert_caches(tcache, jcache)
    cur = np.asarray(cur, np.int32)
    pos = np.array([10, 10], np.int32)
    for _ in range(2):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(cur),
                                    jnp.asarray(pos),
                                    block_tables=jnp.asarray(bt))
        tl, tcache = tm.decode_step(tp, tcache, cur, torch.from_numpy(pos),
                                    block_tables=bt)
        _close(tl, jl)
        cur = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), cur[:, 0])
        pos = pos + 1
    _assert_caches(tcache, jcache)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

# one prompt length (the JAX engine compiles once per length at exact
# lengths); the third request waits for a slot of two
SCHED = [(np.arange(1, 6, dtype=np.int32), 6, 0),
         (np.array([9, 3, 7, 3, 9], np.int32), 5, 0),
         (np.array([4, 4, 8, 2, 6], np.int32), 4, 2)]
ENGINES = {"dense": {}, "paged": {"paged": True, "page_size": 4}}


@pytest.fixture(scope="module")
def engine_pairs():
    return {}


def _engine_pair(engine_pairs, arch):
    if arch not in engine_pairs:
        jm, jp, tm, tp = build_pair(arch, seed=23)
        engine_pairs[arch] = (jm, jp, tm, tp, [
            gold_decode(tm, tp, p, mn, 64) for p, mn, _ in SCHED])
    return engine_pairs[arch]


@pytest.mark.parametrize("layout", sorted(ENGINES))
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "nemotron-4-15b"])
def test_engine_streams_match_jax_engine_and_gold(engine_pairs, arch,
                                                  layout):
    jm, jp, tm, tp, golds = _engine_pair(engine_pairs, arch)
    kw = ENGINES[layout]
    jeng, jgot = run_staggered(JEngine, JRequest, jm, jp, 2, sched=SCHED,
                               **kw)
    eng, got = run_staggered(ServingEngine, Request, tm, tp, 2, sched=SCHED,
                             **kw)
    moe = tm.cfg.moe is not None
    # MoE routing lets pad tokens compete for capacity: both engines
    # prefill MoE families at the exact prompt length, and neither reuses
    # a warm prefix's compute nor speculates
    assert eng.prefill_bucket == jeng.prefill_bucket == (1 if moe else 16)
    if moe:
        assert not eng._suffix_reuse and eng._spec_k == 0
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"{arch} {layout} uid={uid}"
        assert got[uid] == jgot[uid], f"{arch} {layout} uid={uid}"


def test_moe_engines_prefill_at_exact_length_even_when_asked_to_pad():
    """The MoE gate holds whatever bucket the caller passes; a dense
    family keeps it."""
    for arch, bucket in (("qwen2-moe-a2.7b", 1), ("granite-moe-1b-a400m", 1),
                         ("nemotron-4-15b", 8)):
        tm = t_build(t_reduced(T_REGISTRY[arch]), device="cpu")
        tp = tm.init(torch.Generator().manual_seed(0))
        for paged in (False, True):
            eng = ServingEngine(tm, tp, slots=2, max_seq=32, paged=paged,
                                page_size=4, prefill_bucket=8,
                                speculate=2)
            assert eng.prefill_bucket == bucket, (arch, paged)
            assert (eng._spec_k == 0) == (bucket == 1), (arch, paged)


def test_moe_plan_engine_matches_jax_plan_engine(engine_pairs):
    """Reduced qwen2-moe through a 2-stage plan with 2 decode replicas at
    chunk 4: each 5-token prompt prefills in one chunk (MoE capacity is
    per call), and the streams equal JAX's plan engine and the gold."""
    jm, jp, tm, tp, golds = _engine_pair(engine_pairs, "qwen2-moe-a2.7b")
    groups = tm.cfg.num_groups
    jeng, jgot = run_staggered(
        JEngine, JRequest, jm, jp, 2, sched=SCHED, paged=True, page_size=4,
        plan=JP.lower_serving(JP.uniform_plan(groups, 2, n_microbatches=2),
                              slots=2, chunk=4))
    eng, got = run_staggered(
        ServingEngine, Request, tm, tp, 2, sched=SCHED, paged=True,
        page_size=4,
        plan=TP.lower_serving(TP.uniform_plan(groups, 2, n_microbatches=2),
                              slots=2, chunk=4))
    assert eng.prefill_chunk_counts == jeng.prefill_chunk_counts \
        == [1] * len(SCHED)
    assert got == jgot
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"uid={uid}"
