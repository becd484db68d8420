"""gemma2 in the port against JAX.

Reduced gemma2-9b (``reduced``: two (attn_local, attn_global) periods, 4
layers, window 16, head_dim 16, d_model 64, vocab 256, attention softcap
50 and final softcap 30, post-block norms, GeGLU, tied head), weights
drawn with numpy in the JAX layout (``numpy_tree``) and bridged.

Caches: the port's dense and paged caches (fp and int8 pools) have JAX's
leaf structure, shapes and dtypes; a local ring holds min(max_seq,
window) rows in the activation dtype on every layout (the ring repair).
Layers: attention with a window and a softcap in every dense mode (no
cache, a prefill longer than the ring, the chunked continuation over a
wrapping ring, lock-step decode, per-slot decode that wraps the ring), a
windowed paged cache raising as JAX's does, a post-normed GeGLU block
and the softcapped tied head in f32 and bf16, and the ring-view decode
route (``dispatch_ring_decode``: the unfused paged decode over a view of
the ring, which CUDA tensors take) against ``_attend_block``, with an
empty slot.  Models: the parameter count (reduced and published),
forward logits, a dense prefill then lock-step and per-slot decode that
cross the window, and a cold then a block-sharing paged prefill then
decode on fp and int8 pools (int8 rows within one unit, see
``INT8_TOL``).  Engines: dense and paged greedy streams
equal the JAX engine's and the port's one-shot gold with prompts longer
than the window, the padding guard keeps a bucket from padding past the
ring, and a 2-stage plan engine equals JAX's plan engine, a prompt
longer than the ring prefilling in one chunk.

Tolerances: f32 at atol = rtol = 1e-4 (``test_torch_model.py``), greedy
tokens identical, int8 rows equal; bf16 within one bf16 ulp on at most
1% of the elements.  Each JAX engine sees one prompt length: it compiles
once per length.
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
from repro.models import build_model as j_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import plan as TP  # noqa: E402
from repro_torch.backend import dispatch as kops  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_families import numpy_tree, pair_configs  # noqa: E402
from test_torch_model import _assert_bf16_within_one_ulp  # noqa: E402
from test_torch_serving import gold_decode, run_staggered  # noqa: E402

ARCH = "gemma2-9b"
TOL = dict(atol=1e-4, rtol=1e-4)
W = 16                                  # the reduced window


def _close(t, a):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(a, np.float32), **TOL)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.fixture(scope="module")
def pair():
    jc, tc = pair_configs(ARCH)
    assert (tc.window_size, tc.head_dim, tc.num_layers) == (W, 16, 4)
    jm = j_build(jc)
    tree = numpy_tree(jm, 31)
    return (jm, jax.tree.map(jnp.asarray, tree), t_build(tc, device="cpu"),
            params_from_numpy(tree, tc, "cpu"))


# ---------------------------------------------------------------------------
# caches: the ring repair
# ---------------------------------------------------------------------------

def _layout(tree):
    """{path: (shape, dtype name)} of a cache's leaves."""
    out = {}
    for bk, sub in tree.items():
        for key, leaf in sub.items():
            for name, a in leaf.items():
                dt = (str(a.dtype).replace("torch.", "")
                      if torch.is_tensor(a) else np.dtype(a.dtype).name)
                out[bk, key, name] = (tuple(a.shape), dt)
    return out


@pytest.mark.parametrize("max_seq", [8, 64])
@pytest.mark.parametrize("layout", ["dense", "fp", "int8"])
def test_cache_layouts_match_jax(layout, max_seq):
    """Leaf structure, shapes and dtypes of the dense cache and the paged
    cache on fp and int8 pools equal JAX's; the local ring holds
    min(max_seq, window) rows in the activation dtype (f32 here) on int8
    pools too, the global layer's K/V pages."""
    jc, tc = pair_configs(ARCH)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    if layout == "dense":
        j, t = jm.init_cache(2, max_seq), tm.init_cache(2, max_seq)
    else:
        kw = dict(page_size=4, num_blocks=6, kv_dtype=layout)
        j = jm.init_paged_cache(2, max_seq, **kw)
        t = tm.init_paged_cache(2, max_seq, **kw)
    assert _layout(t) == _layout(j)
    ring = t["b0"]["kv"]["k"]
    assert ring.shape == (tc.num_groups, 2, min(max_seq, W),
                          tc.num_kv_heads, tc.head_dim)
    assert ring.dtype == torch.float32
    if layout != "dense":
        assert set(t["b1"]["kv"]) >= {"k_pages", "v_pages"}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _attn_pair(seed, **kw):
    """A reduced gemma2 config pair (a softcap that bites at head_dim 16)
    and one attention layer's weights in both layouts."""
    jc, tc = pair_configs(ARCH, attn_logit_softcap=1.5, **kw)
    r = np.random.default_rng(seed)
    d, qd, kvd = tc.d_model, tc.q_dim, tc.kv_dim
    w = {"wq": r.standard_normal((d, qd)) / np.sqrt(d) * 3,
         "wk": r.standard_normal((d, kvd)) / np.sqrt(d) * 3,
         "wv": r.standard_normal((d, kvd)) / np.sqrt(d),
         "wo": r.standard_normal((qd, d)) / np.sqrt(qd)}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
    tp = {k: _t(np.asarray(v, np.float32)) for k, v in w.items()}
    return jc, tc, jp, tp, r


def _ring(tc, b):
    shp = (b, W, tc.num_kv_heads, tc.head_dim)
    return ({"k": jnp.zeros(shp), "v": jnp.zeros(shp)},
            {"k": torch.zeros(shp), "v": torch.zeros(shp)})


def _run(jp, tp, jc, tc, x, jcache=None, tcache=None, **kw):
    """One attention call on both sides at window W; returns (jax out,
    port out, jax cache)."""
    jo, jn = JL.multi_head_attention(jp, jnp.asarray(x), jc, window=W,
                                     kv_cache=jcache, **{
                                         k: (jnp.asarray(v)
                                             if isinstance(v, np.ndarray)
                                             else v)
                                         for k, v in kw.items()})
    to, _ = TL.multi_head_attention(tp, _t(x), tc, window=W,
                                    kv_cache=tcache, **{
                                        k: (torch.from_numpy(v)
                                            if isinstance(v, np.ndarray)
                                            else v)
                                        for k, v in kw.items()})
    return jo, to, jn


def _assert_ring(tcache, jcache):
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])


@pytest.mark.parametrize("mode", ["no_cache", "prefill_past_ring",
                                  "continuation", "lockstep",
                                  "per_slot_wrap"])
def test_windowed_softcapped_attention_matches_jax_in_every_dense_mode(mode):
    jc, tc, jp, tp, r = _attn_pair(5)
    d = tc.d_model

    def x(b, s):
        return r.standard_normal((b, s, d)).astype(np.float32)

    if mode == "no_cache":
        jo, to, _ = _run(jp, tp, jc, tc, x(2, 40))
        _close(to, jo)
        return
    jr, tr = _ring(tc, 2)
    if mode == "prefill_past_ring":
        # 24 tokens into a 16-row ring: the window bites in the prefill,
        # and the ring keeps the last 16 rows, wrapped
        jo, to, jr = _run(jp, tp, jc, tc, x(2, 24), jr, tr, cache_index=0)
        _close(to, jo)
        _assert_ring(tr, jr)
        return
    if mode == "continuation":
        # a 10-token chunk, then a 12-token continuation that attends the
        # ring (positions 10..21) and wraps it
        jo, to, jr = _run(jp, tp, jc, tc, x(2, 10), jr, tr, cache_index=0)
        jo, to, jr = _run(jp, tp, jc, tc, x(2, 12), jr, tr, cache_index=10,
                          attend_cache=True)
        _close(to, jo)
        _assert_ring(tr, jr)
        return
    if mode == "lockstep":
        jo, to, jr = _run(jp, tp, jc, tc, x(2, 20), jr, tr, cache_index=0)
        for pos in (20, 21, 22):
            jo, to, jr = _run(jp, tp, jc, tc, x(2, 1), jr, tr,
                              cache_index=pos)
            _close(to, jo)
        _assert_ring(tr, jr)
        return
    # per-slot: slot 0 prefilled 20 tokens, slot 1 9, each batch-1 into
    # its row; then 8 per-slot steps (slot 0 at 20..27, slot 1 at 9..16:
    # both rings wrap)
    for b, n in ((0, 20), (1, 9)):
        j1, t1 = _ring(tc, 1)
        _, _, j1 = _run(jp, tp, jc, tc, x(1, n), j1, t1, cache_index=0)
        jr = {k: jr[k].at[b].set(j1[k][0]) for k in jr}
        for k in tr:
            tr[k][b] = t1[k][0]
    pos = np.array([20, 9], np.int32)
    for _ in range(8):
        jo, to, jr = _run(jp, tp, jc, tc, x(2, 1), jr, tr, cache_index=pos)
        _close(to, jo)
        pos = pos + 1
    _assert_ring(tr, jr)


def test_windowed_attention_on_a_paged_cache_raises_as_jax():
    jc, tc, jp, tp, r = _attn_pair(6)
    x = r.standard_normal((1, 4, tc.d_model)).astype(np.float32)
    shp = (3, 4, tc.num_kv_heads, tc.head_dim)
    bt = np.zeros((1, 2), np.int32)
    with pytest.raises(NotImplementedError):
        JL.multi_head_attention(
            jp, jnp.asarray(x), jc, window=W,
            kv_cache={"k_pages": jnp.zeros(shp), "v_pages": jnp.zeros(shp)},
            cache_index=0, block_tables=jnp.asarray(bt))
    with pytest.raises(NotImplementedError):
        TL.multi_head_attention(
            tp, _t(x), tc, window=W,
            kv_cache={"k_pages": torch.zeros(shp),
                      "v_pages": torch.zeros(shp)},
            cache_index=0, block_tables=torch.from_numpy(bt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_post_normed_geglu_block_and_softcapped_head_match_jax(dtype):
    """One global block (pre and post norms around attention and the
    GeGLU MLP, scales drawn near 1) without a cache, and the tied head
    with the final softcap at 30 (logits scaled so that it bites).  In
    bf16 the block is held to JAX from its second norm on (norm2, the
    GeGLU MLP with its f32 accumulators, post_norm2): on the CPU JAX's
    attention rounds its probabilities to bf16 where the port's flash
    front door keeps them in f32, as JAX's flash kernel does."""
    jc, tc = pair_configs(ARCH, dtype=dtype, param_dtype=dtype)
    assert tc.post_block_norm and tc.gated_mlp
    assert tc.mlp_activation == "gelu" and tc.final_logit_softcap == 30.0
    jm = j_build(jc)
    tree = numpy_tree(jm, 41)
    blk_j = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["stack"]["b1"])
    blk_t = TL_tree(tree["stack"]["b1"], 1)
    assert set(blk_t) == {"norm1", "mixer", "norm2", "ffn", "post_norm1",
                          "post_norm2"}
    assert set(TT.init_block(torch.Generator().manual_seed(0), tc,
                             tc.block_pattern[1], "cpu")) == set(blk_t)
    r = np.random.default_rng(8)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(r.standard_normal((2, 12, tc.d_model)), jdt)
    if dtype == "float32":
        jy, _, _ = JT.apply_block(blk_j, xj, jc, jc.block_pattern[1])
        ty, _, _ = TT.apply_block(blk_t, _t(xj), tc, tc.block_pattern[1])
    else:
        def tail(L, p, x, cfg):
            h = L.apply_mlp(p["ffn"], L.apply_norm(p["norm2"], x, cfg), cfg)
            return x + L.apply_norm(p["post_norm2"], h, cfg)
        jy = tail(JL, blk_j, xj, jc)
        ty = tail(TL, blk_t, _t(xj), tc)
    assert ty.dtype == getattr(torch, dtype)
    table = jnp.asarray(r.standard_normal((tc.vocab_size, tc.d_model)) * 2,
                        jdt)
    jl = JL.logits_head({"table": table}, None, jy, jc)
    tl = TL.logits_head({"table": _t(table)}, None, _t(jy), tc)
    assert tl.dtype == torch.float32
    assert float(tl.abs().max()) > 20.0     # the softcap bites
    assert float(tl.abs().max()) < 30.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if dtype == "float32":
        _close(ty, jy)
    else:
        _assert_bf16_within_one_ulp(ty, jy)


def TL_tree(tree, g):
    """Group ``g`` of a JAX-layout stack subtree as the port's tensors."""
    if isinstance(tree, dict):
        return {k: TL_tree(v, g) for k, v in tree.items()}
    return _t(np.asarray(tree)[g])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_decode_route_matches_attend_block_with_an_empty_slot(dtype):
    """``dispatch_ring_decode`` (the unfused paged decode over a view of
    the ring: one W-row page a slot, lengths min(pos + 1, W)) against the
    plain ``_attend_block`` over ``ring_k_positions``, at positions before
    the ring fills, at its last row, wrapped, and -1 (an empty slot: no
    valid row, the uniform mean of V)."""
    _, tc = pair_configs(ARCH)
    tc = dataclasses.replace(tc, attn_logit_softcap=1.5)
    g = torch.Generator().manual_seed(3)
    b, hk, hd = 5, tc.num_kv_heads, tc.head_dim
    h = tc.num_heads
    q = (torch.randn((b, 1, h, hd), generator=g) * 2).to(dtype)
    kc = (torch.randn((b, W, hk, hd), generator=g) * 2).to(dtype)
    vc = torch.randn((b, W, hk, hd), generator=g).to(dtype)
    pos = torch.tensor([3, 15, 16, 40, -1])
    got = kops.dispatch_ring_decode(q, kc, vc, pos,
                                    softcap=tc.attn_logit_softcap)
    k_pos, k_valid = TL.ring_k_positions(pos[:, None], W)
    ref = TL._attend_block(q.reshape(b, 1, hk, h // hk, hd), kc, vc, tc,
                           pos[:, None], k_pos, k_valid, True, W, dtype)
    assert got.shape == ref.shape == (b, 1, h * hd)
    tol = TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                               **tol)
    mean_v = vc[4].float().mean(0).reshape(-1)            # (Hkv * D)
    expect = mean_v.reshape(hk, 1, hd).expand(hk, h // hk, hd).reshape(-1)
    np.testing.assert_allclose(got[4, 0].float().numpy(), expect.numpy(),
                               **tol)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["flash", "paged_prefill", "fused_decode",
                                    "paged_decode"])
def test_attention_contracts_take_head_dim_256(kernel):
    """The four attention kernels' contracts accept gemma2's shapes
    (D=256, Hkv=8, G=2, page 16) and still raise at D=512."""
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import paged_attention as KP

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    for d in (256, 512):
        hk, g, s, n, p, nb = 8, 2, 8, 9, 16, 4
        i32 = dict(dtype=torch.int32)
        if kernel == "flash":
            pos = z(s, **i32)
            call = lambda: KF.check_flash_contract(  # noqa: E731
                z(1, hk * g, s, d), z(1, hk, s, d), z(1, hk, s, d), pos, pos,
                pos)
        elif kernel == "paged_prefill":
            call = lambda: KP.check_paged_prefill_contract(  # noqa: E731
                z(1, hk, g, s, d), z(n, p, hk, d), z(n, p, hk, d),
                z(1, nb, **i32), 16)
        elif kernel == "fused_decode":
            call = lambda: KP.check_fused_decode_contract(  # noqa: E731
                z(4, hk, g, d), z(4, hk, d), z(4, hk, d), z(n, p, hk, d),
                z(n, p, hk, d), z(4, nb, **i32), z(4, **i32))
        else:
            call = lambda: KP.check_paged_decode_contract(  # noqa: E731
                z(4, hk, g, d), z(n, p, hk, d), z(n, p, hk, d),
                z(4, nb, **i32), z(4, **i32))
        if d == 256:
            assert d in call()
        else:
            with pytest.raises(ValueError):
                call()


def test_published_and_reduced_param_counts_match_jax(pair):
    """9.242 B parameters at published size (shapes only), and the
    reduced model's count and tree."""
    shapes = jax.eval_shape(j_build(J_REGISTRY[ARCH]).init,
                            jax.random.key(0))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tm = t_build(T_REGISTRY[ARCH], device="meta")
    assert tm.param_count(tm.init(None)) == n
    assert round(n / 1e9, 3) == 9.242
    jm, jp, tm, tp = pair
    assert tm.param_count(tp) == jm.param_count(jp)
    assert "head" not in tp


def test_forward_logits_match_jax(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(
        1, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl)
    assert np.array_equal(tl.argmax(-1).numpy(),
                          np.asarray(jnp.argmax(jl, -1)))


def test_prefill_and_dense_decode_across_the_window_match_jax(pair):
    """A 20-token prompt (past the 16-row ring), then 3 lock-step and 3
    per-slot decode steps: logits, tokens and every cache leaf."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(2).integers(
        1, tm.cfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 48)
    tl, tc = tm.prefill(tp, {"tokens": toks}, 48)
    _close(tl, jl)
    pos = toks.shape[1]
    for step in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt[:, 0])
        if step < 3:
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
            tl, tc = tm.decode_step(tp, tc, nxt, pos)
        else:
            vec = np.full((2,), pos, np.int32)
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt),
                                    jnp.asarray(vec))
            tl, tc = tm.decode_step(tp, tc, nxt, torch.from_numpy(vec))
        _close(tl, jl)
        pos += 1
    _assert_caches(tc, jc)


# The two frameworks' f32 layers differ in their last bits (~1e-6 on the
# reduced gemma2's rings, after its sqrt(d_model)-scaled embedding and
# post-block norms), so a value that sits on a .5 boundary of its int8
# row's grid may round one unit apart: int8 rows are held to within one
# unit on at most 0.1% of the elements, and the logits that read them to
# INT8_TOL (one unit of a row's K moves its scores by scale * |q| / sqrt(D)).
INT8_TOL = dict(atol=1e-3, rtol=1e-3)


def _assert_caches(tcache, jcache):
    """Every leaf of every block: int8 rows within one unit (see above),
    the rest close."""
    assert _layout(tcache) == _layout(jcache)
    for bk, sub in tcache.items():
        for key, leaf in sub.items():
            for name, t in leaf.items():
                a = jcache[bk][key][name]
                if t.dtype == torch.int8:
                    d = np.abs(t.numpy().astype(np.int32)
                               - np.asarray(a).astype(np.int32))
                    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (
                        bk, name, d.max(), (d > 0).sum())
                else:
                    _close(t, a)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_prefill_and_decode_match_jax(pair, kv_dtype):
    """A cold 20-token admission into slot 0 and, into slot 1, a prompt
    that shares its first page (the write entry the sentinel: block
    sharing without compute reuse, as the engine admits gemma2), both
    right-padded by 2; then per-slot paged decode (the fused decode on
    the global layers, the dense ring on the local ones) across the
    window: logits, tokens and every cache leaf (pools, int8 rows and
    scales, the f32 rings)."""
    jm, jp, tm, tp = pair
    tol = TOL if kv_dtype == "fp" else INT8_TOL

    def close(t, a):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), **tol)

    max_seq, page, num_blocks = 32, 4, 16
    r = np.random.default_rng(3)
    prompts = [r.integers(1, tm.cfg.vocab_size, 20).astype(np.int32)]
    prompts.append(np.concatenate([prompts[0][:4], r.integers(
        1, tm.cfg.vocab_size, 14)]).astype(np.int32))
    jcache = jm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    tcache = tm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks, kv_dtype=kv_dtype)
    bt = np.full((2, 8), num_blocks, np.int32)
    bt[0, :6] = [5, 2, 9, 1, 3, 4]
    bt[1, :5] = [5, 11, 7, 13, 6]
    wt1 = bt[1:2].copy()
    wt1[0, 0] = num_blocks
    cur = []
    for slot, prompt, btab, wtab in ((0, prompts[0], bt[:1], bt[:1]),
                                     (1, prompts[1], bt[1:2], wt1)):
        toks = np.zeros((1, len(prompt) + 2), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, jcache = jm.prefill_suffix_paged(
            jp, jcache, jnp.asarray(toks), slot, jnp.int32(0),
            jnp.int32(len(prompt)), max_seq, jnp.asarray(btab),
            jnp.asarray(wtab))
        tl, tcache = tm.prefill_suffix_paged(
            tp, tcache, toks, slot, 0, len(prompt), max_seq, btab, wtab)
        close(tl, jl)
        cur.append([int(tl[0, -1].argmax())])
    _assert_caches(tcache, jcache)
    cur = np.asarray(cur, np.int32)
    pos = np.array([20, 18], np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(cur),
                                    jnp.asarray(pos),
                                    block_tables=jnp.asarray(bt))
        tl, tcache = tm.decode_step(tp, tcache, cur, torch.from_numpy(pos),
                                    block_tables=bt)
        close(tl, jl)
        cur = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), cur[:, 0])
        pos = pos + 1
    _assert_caches(tcache, jcache)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

# one prompt length, past the 16-row ring (the JAX engine compiles once
# per length); the third request waits for a slot of two
_rng = np.random.default_rng(5)
SCHED = [(_rng.integers(1, 256, 20).astype(np.int32), 6, 0),
         (_rng.integers(1, 256, 20).astype(np.int32), 5, 0),
         (_rng.integers(1, 256, 20).astype(np.int32), 4, 2)]
ENGINES = {"dense": {}, "paged": {"paged": True, "page_size": 4}}


@pytest.fixture(scope="module")
def golds(pair):
    _, _, tm, tp = pair
    return [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in SCHED]


@pytest.mark.parametrize("layout", sorted(ENGINES))
def test_engine_streams_match_jax_engine_and_gold(pair, golds, layout):
    """Prompts of 20 tokens (past the window) prefill at their exact
    length; decode wraps the rings.  Neither engine speculates or reuses
    a warm prefix's compute."""
    jm, jp, tm, tp = pair
    kw = ENGINES[layout]
    jeng, jgot = run_staggered(JEngine, JRequest, jm, jp, 2, sched=SCHED,
                               speculate=2, **kw)
    eng, got = run_staggered(ServingEngine, Request, tm, tp, 2, sched=SCHED,
                             speculate=2, **kw)
    assert eng.cache_stats()["layout"] == ("paged" if kw else "dense")
    assert not eng._suffix_reuse and eng._spec_k == 0
    assert eng._ring_min == jeng._ring_min == W
    for uid, gold in enumerate(golds):
        assert got[uid] == gold, f"{layout} uid={uid}"
        assert got[uid] == jgot[uid], f"{layout} uid={uid}"


@pytest.mark.parametrize("paged", [False, True])
def test_padding_never_spills_past_the_ring(pair, paged):
    """A bucket of 32 would pad a 12-token prompt to 32 and spill pad K/V
    past the 16-row ring: both engines pad it to 16; a 20-token prompt
    prefills at its exact length; max_seq smaller than the window makes
    the ring max_seq rows.  An all-local config pages nothing and runs
    dense, as JAX's does."""
    jm, jp, tm, tp = pair
    kw = {"paged": True, "page_size": 4} if paged else {}
    for max_seq, ring in ((64, W), (12, 12)):
        jeng = JEngine(jm, jp, slots=2, max_seq=max_seq, prefill_bucket=32,
                       **kw)
        eng = ServingEngine(tm, tp, slots=2, max_seq=max_seq,
                            prefill_bucket=32, **kw)
        assert eng._ring_min == jeng._ring_min == ring
        for n in (3, 8, 11, 12, 16, 20):
            if n < max_seq:
                assert eng._padded_len(n) == jeng._padded_len(n), n
        if max_seq == 64:
            assert [eng._padded_len(n) for n in (12, 20)] == [16, 20]
    from repro_torch.configs.base import BlockSpec
    local = dataclasses.replace(tm.cfg, block_pattern=(
        BlockSpec("attn_local", "dense"),), num_layers=2)
    lm = t_build(local, device="cpu")
    eng = ServingEngine(lm, lm.init(torch.Generator().manual_seed(0)),
                        slots=2, max_seq=32, paged=True, page_size=4)
    assert not eng.paged and eng.cache_stats()["layout"] == "dense"


def test_padded_prompts_stream_equal_to_the_gold(pair):
    """Prompts of 12 tokens under a bucket of 32: padded to the ring's 16
    rows (never past it), the dense and paged streams equal the gold's
    and the JAX engine's."""
    jm, jp, tm, tp = pair
    r = np.random.default_rng(9)
    sched = [(r.integers(1, 256, 12).astype(np.int32), 8, 0),
             (r.integers(1, 256, 12).astype(np.int32), 6, 1)]
    golds = [gold_decode(tm, tp, p, mn, 64) for p, mn, _ in sched]
    for kw in ENGINES.values():
        _, jgot = run_staggered(JEngine, JRequest, jm, jp, 2, sched=sched,
                                prefill_bucket=32, **kw)
        _, got = run_staggered(ServingEngine, Request, tm, tp, 2,
                               sched=sched, prefill_bucket=32, **kw)
        for uid, gold in enumerate(golds):
            assert got[uid] == gold == jgot[uid], f"{kw} uid={uid}"


def test_plan_engine_matches_jax_plan_engine(pair, golds):
    """A 2-stage plan with 2 decode replicas at chunk 4: each 20-token
    prompt wraps the 16-row ring, so it prefills in one chunk, as JAX's
    plan engine does; the streams equal JAX's and the gold."""
    jm, jp, tm, tp = pair
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
