"""The port's model against the JAX model on the same (bridged) weights.

JAX draws the weights; ``repro_torch.bridge.params_from_numpy`` carries
them across.  Then the same tokens go through both: the full forward, a
dense prefill followed by lock-step and per-slot dense decode, and a
paged suffix prefill (cold and warm) followed by paged decode through the
fused kernel's front door.  Two shapes: ``reduced(yi-6b, layers=2)``
(head_dim 16) and a head_dim-128 variant.

Tolerance: f32 logits at atol = rtol = 1e-4 (random weights give logits
of order 1-10; the frameworks sum in different orders through two layers
of matmuls), and greedy tokens must be identical.
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


def test_paged_suffix_prefill_and_fused_decode_match_jax(pair):
    """Cold admission into slot 0, warm admission (offset > 0, shared
    first page, sentinel write entry) into slot 1, then batched paged
    decode at per-slot positions -- logits, tokens and pools."""
    jm, jp, tm, tp = pair
    page, nb, max_seq = 4, 8, 32
    num_blocks = 16
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, tm.cfg.vocab_size, 10).astype(np.int32)
    jcache = jm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks)
    tcache = tm.init_paged_cache(2, max_seq, page_size=page,
                                 num_blocks=num_blocks)
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
    assert first[0] == first[1]        # same prompt, cold and warm
    _close(tcache["b0"]["kv"]["k_pages"], jcache["b0"]["kv"]["k_pages"])
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
    for name in ("k_pages", "v_pages"):
        _close(tcache["b0"]["kv"][name], jcache["b0"]["kv"][name])
