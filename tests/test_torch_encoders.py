"""The paper's ViTs and whisper-base in the port against JAX.

Configs: the port's deit-t, deit-160, deit-256, lv-vit-t and whisper-base
equal the JAX package's field for field, ``PAPER_MODELS`` and
``vit_shape`` too.  Caches: ``make_cache(enc_len=)`` has JAX's leaves
(``cross_kv`` included) at JAX's shapes and dtypes.  Params: JAX's trees
bridged by ``params_from_numpy`` have the keys and shapes of the port's
own ``Model.init`` (``enc_stack`` split by group, ``cls``, ``pos_embed``,
``enc_norm``, ``norm_x`` and ``cross``).

Numerics, f32 throughout, JAX on its ref path (``REPRO_KERNELS`` unset
resolves to ``ref`` on the CPU) and the port on its plain versions, at
JAX's own tolerances (atol 2e-4, rtol 2e-3, ``tests/test_models.py``):
``run_stack(causal=False)``; each ViT's ``forward`` at published width
with 2 layers (head dims 64, 40, 64, 60) on B=3 images of 196 patches;
whisper reduced and at published width with 2 + 2 layers: ``encode``,
``forward``, ``prefill`` and K teacher-forced ``decode_step``s against
JAX's and against the forward, the greedy tokens of prefill + decode
equal to JAX's, and a different encoder input changing the prefill
logits.  The flash plain version, non-causal at D = 40 and 60 (Sq = 197,
and Sq = 1 against 1500 keys), against ``repro.kernels.ref``'s; its
contract takes D = 40 and 60 and no other width outside (64, 128, 256).
The encoders reach the flash front door with ``causal=False``, the
decoder's self-attention with ``causal=True``, its cross-attention with
``causal=False``; a cross-attention layer's K/V from ``kv_source`` and
from ``cross_kv`` give JAX's output.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.backend import dispatch as kops  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
F32 = dict(dtype="float32", param_dtype="float32")
VITS = ("deit-t", "deit-160", "deit-256", "lv-vit-t")
NAMES = VITS + ("whisper-base",)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


def _pair(name, **kw):
    """(JAX model, JAX params, port model, bridged params) of ``name``
    with ``kw`` replaced on both configs, in f32."""
    jc = dataclasses.replace(JC.REGISTRY[name], **F32, **kw)
    tc = dataclasses.replace(TC.REGISTRY[name], **F32, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm = j_build(jc)
    jp = jm.init(jax.random.key(3))
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _shapes(tree):
    """Leaf shapes and dtypes by path, a port stack's group list as JAX's
    leading group axis."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for k, shape in _shapes(t[0]).items():
                out[path + k] = ((len(t),) + shape[0], shape[1])
        else:
            out[path] = (tuple(t.shape), str(t.dtype).split(".")[-1])
    walk(tree, ())
    return out


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_jax(name):
    assert dataclasses.asdict(TC.REGISTRY[name]) == \
        dataclasses.asdict(JC.REGISTRY[name])
    assert sorted(TC.PAPER_MODELS) == sorted(JC.PAPER_MODELS)
    assert TC.VIT_SEQ == JC.deit.VIT_SEQ == 197
    for b in (1, 3, 6):
        assert dataclasses.asdict(TC.vit_shape(b)) == \
            dataclasses.asdict(JC.vit_shape(b))
    TT.check_supported(TC.REGISTRY[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_cache_with_enc_len_matches_jax(dtype):
    jc = dataclasses.replace(JC.reduced(JC.REGISTRY["whisper-base"]),
                             dtype=dtype)
    tc = dataclasses.replace(TC.reduced(TC.REGISTRY["whisper-base"]),
                             dtype=dtype)
    jcache = JT.make_cache(jc, 3, 40, enc_len=24)
    tcache = TT.make_cache(tc, 3, 40, enc_len=24, device="cpu")
    assert _shapes(tcache) == _shapes(jax.tree.map(np.asarray, jcache))
    assert tcache["b0"]["cross_kv"]["k"].dtype == getattr(torch, dtype)
    assert "cross_kv" not in TT.make_cache(tc, 3, 40, device="cpu")["b0"]


@pytest.mark.parametrize("name", ["deit-160", "whisper-base"])
def test_bridged_param_trees_have_jax_keys_and_shapes(name):
    jm, jp, tm, tp = _pair(name, num_layers=2)
    mine = tm.init(torch.Generator().manual_seed(0))
    jshapes = _shapes(jax.tree.map(np.asarray, jp))
    assert _shapes(tp) == jshapes
    assert _shapes(mine) == jshapes
    want = ({"enc_stack", "enc_norm", "embed", "stack", "final_norm"}
            if name == "whisper-base"
            else {"pos_embed", "cls", "stack", "final_norm", "head"})
    assert set(tp) == want
    if name == "whisper-base":
        assert {"norm_x", "cross"} <= set(tp["stack"][0]["b0"])
        assert "cross" not in tp["enc_stack"][0]["b0"]
    assert tm.param_count(tp) == jm.param_count(jp)


def test_run_stack_non_causal_matches_jax():
    jm, jp, tm, tp = _pair("deit-160", num_layers=2)
    cfg = tm.cfg
    x = np.random.default_rng(1).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    for causal in (False, True):
        jy, _, _ = JT.run_stack(jp["stack"], jnp.asarray(x), jm.cfg,
                                causal=causal)
        ty, _, _ = TT.run_stack(tp["stack"], torch.from_numpy(x), cfg,
                                causal=causal)
        _close(ty, jy)
        if causal:
            assert not np.allclose(np.asarray(jy), ncausal, **TOL)
        ncausal = np.asarray(jy)


@pytest.mark.parametrize("name", VITS)
def test_vit_forward_matches_jax(name):
    """Published width, 2 layers, B=3 images of 196 patch embeddings."""
    jm, jp, tm, tp = _pair(name, num_layers=2)
    assert tm.cfg.head_dim == {"deit-t": 64, "deit-160": 40, "deit-256": 64,
                               "lv-vit-t": 60}[name]
    emb = np.random.default_rng(2).standard_normal(
        (3, 196, tm.cfg.d_model)).astype(np.float32)
    jl, _ = jm.forward(jp, {"embeds": jnp.asarray(emb)})
    tl, aux = tm.forward(tp, {"embeds": emb})
    assert tl.shape == (3, 1000) and tl.dtype == torch.float32
    _close(tl, jl)
    assert float(aux) == 0.0
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))


WHISPER = {"reduced": lambda c: c.reduced(c.REGISTRY["whisper-base"]),
           "published": lambda c: dataclasses.replace(
               c.REGISTRY["whisper-base"], num_layers=2, encoder_layers=2)}


@pytest.fixture(scope="module", params=sorted(WHISPER))
def whisper(request):
    jc = dataclasses.replace(WHISPER[request.param](JC), **F32)
    tc = dataclasses.replace(WHISPER[request.param](TC), **F32)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm = j_build(jc)
    jp = jm.init(jax.random.key(7))
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    r = np.random.default_rng(7)
    enc = r.standard_normal((2, 24, tc.d_model)).astype(np.float32)
    dec = r.integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    return jm, jp, tm, tp, enc, dec


def test_whisper_encode_and_forward_match_jax(whisper):
    jm, jp, tm, tp, enc, dec = whisper
    _close(tm.encode(tp, enc), jm.encode(jp, jnp.asarray(enc)))
    jl, _ = jm.forward(jp, {"enc_embeds": jnp.asarray(enc),
                            "dec_tokens": jnp.asarray(dec)})
    tl, _ = tm.forward(tp, {"enc_embeds": enc, "dec_tokens": dec})
    assert tl.shape == (2, 16, tm.cfg.vocab_size)
    _close(tl, jl)


def test_whisper_prefill_and_decode_match_jax_and_forward(whisper):
    """Prefill 12 tokens, then 4 teacher-forced decode steps: each
    against JAX's step and the forward at the same position, the cached
    cross K/V equal to JAX's; then greedy: prefill + 6 steps feeding each
    argmax back, the same tokens as JAX's."""
    jm, jp, tm, tp, enc, dec = whisper
    td, max_seq = 12, 24
    full, _ = tm.forward(tp, {"enc_embeds": enc, "dec_tokens": dec})
    batch = {"enc_embeds": enc, "dec_tokens": dec[:, :td]}
    jl, jcache = jm.prefill(jp, jax.tree.map(jnp.asarray, batch), max_seq)
    tl, tcache = tm.prefill(tp, batch, max_seq)
    _close(tl, jl)
    _close(tl[:, 0], full[:, td - 1])
    _close(tcache["b0"]["cross_kv"]["k"], jcache["b0"]["cross_kv"]["k"])
    _close(tcache["b0"]["cross_kv"]["v"], jcache["b0"]["cross_kv"]["v"])
    for t in range(td, dec.shape[1]):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(dec[:, t:t + 1]),
                                    jnp.int32(t))
        tl, tcache = tm.decode_step(tp, tcache, dec[:, t:t + 1], t)
        _close(tl, jl)
        _close(tl[:, 0], full[:, t])

    jl, jcache = jm.prefill(jp, jax.tree.map(jnp.asarray, batch), max_seq)
    tl, tcache = tm.prefill(tp, batch, max_seq)
    for t in range(td, td + 6):
        jtok = np.asarray(jl[:, -1]).argmax(-1)
        ttok = tl[:, -1].argmax(-1).numpy()
        assert np.array_equal(ttok, jtok)
        cur = jtok.astype(np.int32)[:, None]
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(cur),
                                    jnp.int32(t))
        tl, tcache = tm.decode_step(tp, tcache, cur, t)
        _close(tl, jl)


def test_whisper_encoder_input_moves_the_prefill_logits(whisper):
    _, _, tm, tp, enc, dec = whisper
    batch = {"enc_embeds": enc, "dec_tokens": dec[:, :12]}
    a, _ = tm.prefill(tp, batch, 24)
    b, _ = tm.prefill(tp, dict(batch, enc_embeds=enc * 2.0 + 1.0), 24)
    assert float((a - b).abs().max()) > 1e-4


def test_cross_attention_kv_source_and_cached_kv_match_jax(whisper):
    """One decoder block's cross-attention: K/V projected from
    ``kv_source`` and K/V from ``cross_kv`` (the cached route) give JAX's
    output, and ``cross_kv`` gives JAX's K/V."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jm, jp, tm, tp, enc, _ = whisper
    jx = jax.tree.map(lambda a: a[0], jp["stack"])["b0"]["cross"]
    tx = tp["stack"][0]["b0"]["cross"]
    r = np.random.default_rng(5)
    h = r.standard_normal((2, 3, tm.cfg.d_model)).astype(np.float32)
    kw = dict(causal=False, use_rope=False)
    jo, _ = JL.multi_head_attention(jx, jnp.asarray(h), jm.cfg,
                                    kv_source=jnp.asarray(enc), **kw)
    to, _ = TL.multi_head_attention(tx, torch.from_numpy(h), tm.cfg,
                                    kv_source=torch.from_numpy(enc), **kw)
    _close(to, jo)
    ck, cv = TL.cross_kv(tx, torch.from_numpy(enc), tm.cfg)
    jk, jv = JL.cross_kv(jx, jnp.asarray(enc), jm.cfg)
    _close(ck, jk)
    _close(cv, jv)
    to2, _ = TL.multi_head_attention(tx, torch.from_numpy(h), tm.cfg,
                                     precomputed_kv=(ck, cv), **kw)
    _close(to2, jo)


def test_whisper_decode_without_cross_kv_raises(whisper):
    _, _, tm, tp, _, dec = whisper
    cache = tm.init_cache(2, 24)
    with pytest.raises(ValueError, match="cross-attention"):
        tm.decode_step(tp, cache, dec[:, :1], 0)


def test_encoders_reach_flash_non_causal(monkeypatch, whisper):
    """Every attention call of a ViT forward reaches the flash front door
    with causal=False; whisper's encoder too, its decoder's self-attention
    with causal=True and its cross-attention with causal=False (one of
    each a layer)."""
    calls = []
    real = kops.dispatch_flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(kops, "dispatch_flash_attention", spy)
    _, _, tm, tp, enc, dec = whisper
    tm.forward(tp, {"enc_embeds": enc, "dec_tokens": dec})
    n = tm.cfg.num_layers
    assert sorted(calls) == sorted([(False, 24, 24)] * n
                                   + [(True, 16, 16)] * n
                                   + [(False, 16, 24)] * n)
    calls.clear()
    vit = t_build(dataclasses.replace(TC.REGISTRY["lv-vit-t"], num_layers=2,
                                      **F32), device="cpu")
    params = vit.init(torch.Generator().manual_seed(0))
    vit.forward(params, {"embeds": np.zeros((1, 196, 240), np.float32)})
    assert calls == [(False, 197, 197)] * 2


@pytest.mark.parametrize("d", [40, 60])
@pytest.mark.parametrize("sq,skv", [(197, 197), (1, 1500)])
def test_flash_plain_version_non_causal_matches_jax(d, sq, skv):
    r = np.random.default_rng(d + sq)
    b, h = 2, 4
    q = (4 * r.standard_normal((b, h, sq, d))).astype(np.float32)
    k = r.standard_normal((b, h, skv, d)).astype(np.float32)
    v = r.standard_normal((b, h, skv, d)).astype(np.float32)
    qp = np.arange(sq, dtype=np.int32) + (20 if sq == 1 else 0)
    kp = np.arange(skv, dtype=np.int32)
    kv = (kp % 9 != 4).astype(np.int32)
    jo = JR.flash_attention_ref(*map(jnp.asarray, (q, k, v, qp, kp, kv)),
                                causal=False)
    args = tuple(map(torch.from_numpy, (q, k, v, qp, kp, kv)))
    to = TR.flash_attention_ref(*args, causal=False)
    _close(to, jo, atol=1e-5, rtol=1e-5)
    assert torch.equal(TF.flash_attention_bhsd(*args, causal=False), to)


@pytest.mark.parametrize("d", [32, 40, 48, 60, 64, 72, 128, 256])
def test_flash_contract_takes_head_dims_40_and_60(d):
    q = torch.zeros((1, 4, 8, d))
    k = torch.zeros((1, 2, 8, d))
    pos = torch.zeros((8,), dtype=torch.int32)
    if d in (40, 60, 64, 128, 256):
        assert TF.check_flash_contract(q, k, k, pos, pos, pos) == \
            (1, 4, 2, 8, 8, d)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            TF.check_flash_contract(q, k, k, pos, pos, pos)
