"""qwen2-vl's M-RoPE embeds path and qk-norm of the port against JAX.

Weights are drawn with numpy in the JAX layout and carried across by
``repro_torch.bridge.params_from_numpy``; embeddings and positions come
from a numpy seed.  Positions follow Qwen2-VL's layout
(``mrope_positions``): text tokens at t = h = w = index, an image grid
at t = start, h = start + row, w = start + col, the text after it
resuming at the largest position + 1, so the three streams are
**distinct** (JAX's data pipeline makes them equal, which would hide a
section error).  Held, in f32: ``apply_rope`` with sections at reduced
(2, 3, 3) and published (16, 24, 24) width against JAX's, and with
equal streams against plain RoPE; the reduced qwen2-vl's ``forward`` on
``embeds`` + positions, ``prefill`` and ``decode_step(positions=)``
against JAX's; positions x 3 moving the logits; per-slot serving
refused with NotImplementedError as JAX refuses it (``prefill_one``,
the dense, paged and plan engines, the launcher); a qk-norm config
(reduced yi-6b with ``qk_norm=True``): forward and paged engine streams
against JAX's, the fused decode still taken, and never with explicit
positions or M-RoPE.

Tolerances: atol 2e-4 / rtol 2e-3 for models (``tests/test_models.py``),
1e-5 for RoPE alone, greedy tokens identical.
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
from repro_torch.backend import dispatch  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from test_torch_serving import gold_decode, run_staggered  # noqa: E402
from test_torch_xlstm import numpy_tree  # noqa: E402

VLM = "qwen2-vl-72b"
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
ROPE_TOL = dict(atol=1e-5, rtol=1e-5)
PER_SLOT = "token-LM families"   # both packages' refusals name them


def mrope_positions(before, grid_h, grid_w, after, batch=1):
    """(3, B, S) M-RoPE positions of ``before`` text tokens, a grid_h x
    grid_w image and ``after`` text tokens, Qwen2-VL's layout."""
    t = list(range(before))
    h, w = list(t), list(t)
    start = before
    for row in range(grid_h):
        for col in range(grid_w):
            t.append(start)
            h.append(start + row)
            w.append(start + col)
    nxt = max(t + h + w) + 1
    for i in range(after):
        for s in (t, h, w):
            s.append(nxt + i)
    pos = np.asarray([t, h, w], np.int32)[:, None]
    return np.broadcast_to(pos, (3, batch, pos.shape[-1])).copy()


def _close(t, a, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), **tol)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,sections", [(16, (2, 3, 3)),
                                        (128, (16, 24, 24))])
def test_mrope_matches_jax_on_distinct_streams(d, sections):
    pos = mrope_positions(5, 3, 4, 6, batch=2)
    assert not np.array_equal(pos[1], pos[2])
    assert not np.array_equal(pos[0], pos[1])
    x = np.random.default_rng(0).standard_normal(
        (2, pos.shape[-1], 3, d)).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    _close(got, want, ROPE_TOL)
    # a section error shows: the same input with h and w swapped differs
    swapped = pos[[0, 2, 1]]
    other = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(swapped),
                          1e6, sections)
    assert float((other - got).abs().max()) > 1e-3


def test_mrope_with_equal_streams_is_plain_rope():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, 2, 16)).astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9)
    plain = TL.apply_rope(x, pos, 1e4)
    mrope = TL.apply_rope(x, pos[None].expand(3, 2, 9), 1e4, (2, 3, 3))
    _close(mrope, plain.numpy(), ROPE_TOL)
    # a (3, B, S) input to a config without sections rotates by stream 0,
    # on both sides
    pos3 = torch.from_numpy(mrope_positions(2, 2, 2, 3, batch=2))
    got = TL.apply_rope(x, pos3, 1e4)
    _close(got, TL.apply_rope(x, pos3[0], 1e4).numpy(), ROPE_TOL)
    _close(got, JL.apply_rope(jnp.asarray(x.numpy()),
                              jnp.asarray(pos3.numpy()), 1e4), ROPE_TOL)
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.apply_rope(x, pos, 1e4, (2, 3, 3))
    with pytest.raises(ValueError, match="sum"):
        TL.apply_rope(x, pos[None].expand(3, 2, 9), 1e4, (2, 3, 4))


# ---------------------------------------------------------------------------
# qwen2-vl, reduced
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    jc, tc = j_reduced(J_REGISTRY[VLM]), t_reduced(T_REGISTRY[VLM])
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.mrope_sections == (2, 3, 3) and tc.family == "vlm"
    jm = j_build(jc)
    tree = numpy_tree(jax.eval_shape(jm.init, jax.random.key(0)), 3)
    tm = t_build(tc, device="cpu")
    tp = params_from_numpy(tree, tc, "cpu")
    assert tm.param_count(tp) == jm.param_count(
        jax.tree.map(jnp.asarray, tree))
    assert "head" in tp and "table" in tp["embed"]       # untied
    return jm, jax.tree.map(jnp.asarray, tree), tm, tp


def _vlm_batch(cfg, seed=4):
    """2 x (4 text, a 2 x 3 image, 3 text) = 13 positions: embeds drawn
    with numpy (the text rows from the embedding table's scale)."""
    r = np.random.default_rng(seed)
    pos = mrope_positions(4, 2, 3, 3, batch=2)
    emb = r.standard_normal((2, pos.shape[-1], cfg.d_model)).astype(
        np.float32) / np.sqrt(cfg.d_model)
    return emb, pos


def test_vlm_forward_matches_jax(vlm):
    jm, jp, tm, tp = vlm
    emb, pos = _vlm_batch(tm.cfg)
    jl, _ = jm.forward(jp, {"embeds": jnp.asarray(emb),
                            "positions": jnp.asarray(pos)})
    tl, _ = tm.forward(tp, {"embeds": emb, "positions": pos})
    _close(tl, jl, MODEL_TOL)
    # positions x 3 move the logits (tests/test_models.py:157), and so
    # does swapping the h and w streams
    l3, _ = tm.forward(tp, {"embeds": emb, "positions": pos * 3})
    assert float((l3 - tl).abs().max()) > 1e-6
    lsw, _ = tm.forward(tp, {"embeds": emb, "positions": pos[[0, 2, 1]]})
    assert float((lsw - tl).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="M-RoPE"):
        tm.forward(tp, {"embeds": emb})


def test_vlm_prefill_and_decode_match_jax(vlm):
    """``prefill`` on embeds + positions, then greedy ``decode_step``s of
    text tokens at (3, B, 1) positions (all three streams at the next
    text position), lock-step: logits within the model tolerance of
    JAX's; the last step against the full forward over the same
    sequence."""
    jm, jp, tm, tp = vlm
    emb, pos = _vlm_batch(tm.cfg, seed=5)
    jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                             "positions": jnp.asarray(pos)}, 32)
    tl, tc = tm.prefill(tp, {"embeds": emb, "positions": pos}, 32)
    _close(tl, jl, MODEL_TOL)
    step = jax.jit(jm.decode_step)
    nxt_pos = int(pos.max()) + 1
    seq_emb, seq_pos = emb, pos
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        p3 = np.full((3, 2, 1), nxt_pos + i, np.int32)
        idx = pos.shape[-1] + i
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(idx),
                      jnp.asarray(p3))
        tl, tc = tm.decode_step(tp, tc, tok, idx, positions=p3)
        _close(tl, jl, MODEL_TOL)
        row = tp["embed"]["table"][torch.from_numpy(tok[:, 0].copy())]
        seq_emb = np.concatenate([seq_emb, row.numpy()[:, None]], axis=1)
        seq_pos = np.concatenate([seq_pos, p3], axis=-1)
    full, _ = tm.forward(tp, {"embeds": seq_emb, "positions": seq_pos})
    _close(tl[:, -1], full[:, -1], MODEL_TOL)


def test_vlm_per_slot_serving_refused_as_in_jax(vlm):
    """``prefill_one``, ``prefill_suffix_paged``, the dense and paged
    engines and the plan engine raise NotImplementedError, as JAX's
    ``prefill_one``, engine and plan runtime do."""
    jm, jp, tm, tp = vlm
    prompt = np.arange(1, 6, dtype=np.int32)
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        tm.prefill_one(tp, prompt[None], 5, 16)
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        jm.prefill_one(jp, jnp.asarray(prompt[None]), 5, 16)
    cache = tm.init_paged_cache(1, 16, page_size=4, num_blocks=4)
    bt = np.arange(4, dtype=np.int32)[None]
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        tm.prefill_suffix_paged(tp, cache, prompt[None], 0, 0, 5, 16, bt, bt)
    for paged in (False, True):
        eng = ServingEngine(tm, tp, slots=2, max_seq=16, paged=paged,
                            page_size=4)
        eng.submit(Request(0, prompt, 2))
        with pytest.raises(NotImplementedError, match=PER_SLOT):
            eng.run()
    jeng = JEngine(jm, jp, slots=2, max_seq=16)
    jeng.submit(JRequest(0, prompt, 2))
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        jeng.run()
    groups = tm.cfg.num_groups
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        ServingEngine(tm, tp, slots=2, max_seq=16, plan=TP.lower_serving(
            TP.uniform_plan(groups, 2, n_microbatches=1), slots=2, chunk=4))
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        JEngine(jm, jp, slots=2, max_seq=16, plan=JP.lower_serving(
            JP.uniform_plan(groups, 2, n_microbatches=1), slots=2, chunk=4))


def test_launcher_refuses_vlm_per_slot(monkeypatch):
    """``repro_torch.launch.serve --arch qwen2-vl-72b`` (the registry
    entry swapped for the reduced config, on the CPU) fails with the
    per-slot NotImplementedError, not with an unrelated error."""
    from repro_torch.launch import serve
    monkeypatch.setitem(serve.REGISTRY, VLM, t_reduced(T_REGISTRY[VLM]))
    with pytest.raises(NotImplementedError, match=PER_SLOT):
        serve.main(["--arch", VLM, "--device", "cpu", "--requests", "1",
                    "--slots", "1", "--new-tokens", "2", "--max-seq", "16"])


# ---------------------------------------------------------------------------
# qk-norm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qk():
    jc = dataclasses.replace(j_reduced(J_REGISTRY["yi-6b"], layers=2),
                             qk_norm=True)
    tc = dataclasses.replace(t_reduced(T_REGISTRY["yi-6b"], layers=2),
                             qk_norm=True)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jm = j_build(jc)
    tree = numpy_tree(jax.eval_shape(jm.init, jax.random.key(0)), 6)
    tm = t_build(tc, device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm, params_from_numpy(
        tree, tc, "cpu")


def test_qk_norm_params_and_forward_match_jax(qk):
    jm, jp, tm, tp = qk
    mixer = tp["stack"][0]["b0"]["mixer"]
    assert mixer["q_norm"]["scale"].shape == (tm.cfg.head_dim,)
    assert mixer["k_norm"]["scale"].dtype == torch.float32
    init = tm.init(torch.Generator().manual_seed(0))
    assert {k: (v.shape, v.dtype) for k, v in
            init["stack"][0]["b0"]["mixer"]["q_norm"].items()} == \
        {k: (v.shape, v.dtype) for k, v in mixer["q_norm"].items()}
    toks = np.random.default_rng(1).integers(
        1, tm.cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": toks})
    _close(tl, jl, MODEL_TOL)


SCHED = [(np.arange(1, 6, dtype=np.int32), 6, 0),
         (np.array([9, 3, 7, 3, 9], np.int32), 5, 0),
         (np.array([4, 4, 8, 2, 6], np.int32), 4, 2)]


def test_qk_norm_paged_streams_match_jax_on_the_fused_decode(qk,
                                                             monkeypatch):
    """The paged engine's per-slot decode still fuses RoPE into the
    decode (q and k reach it normed, un-roped, as in JAX): every decode
    tick goes through ``dispatch_fused_paged_decode``, and the streams
    equal the JAX paged engine's and the gold."""
    jm, jp, tm, tp = qk
    calls = []
    fused = dispatch.dispatch_fused_paged_decode

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return fused(*a, **kw)
    monkeypatch.setattr(dispatch, "dispatch_fused_paged_decode", spy)
    kw = dict(paged=True, page_size=4)
    _, jgot = run_staggered(JEngine, JRequest, jm, jp, 2, sched=SCHED, **kw)
    eng, got = run_staggered(ServingEngine, Request, tm, tp, 2, sched=SCHED,
                             **kw)
    assert eng.paged and calls
    assert len(calls) == tm.cfg.num_layers * eng.stats()["decode_steps"]
    for uid, (p, mn, _) in enumerate(SCHED):
        assert got[uid] == jgot[uid], f"uid={uid}"
        assert got[uid] == gold_decode(tm, tp, p, mn, 64), f"uid={uid}"


def test_explicit_positions_never_take_the_fused_decode(qk, monkeypatch):
    """A paged per-slot decode step given explicit positions runs the
    unfused decode (write, then ``dispatch_paged_attention``), as JAX's
    does, and gives the fused step's logits when the positions are the
    cache offsets."""
    jm, jp, tm, tp = qk
    fused = []
    real = dispatch.dispatch_fused_paged_decode
    monkeypatch.setattr(dispatch, "dispatch_fused_paged_decode",
                        lambda *a, **kw: fused.append(1) or real(*a, **kw))
    prompt = np.arange(1, 8, dtype=np.int32)
    outs = []
    for explicit in (False, True):
        cache = tm.init_paged_cache(1, 16, page_size=4, num_blocks=4)
        bt = np.arange(4, dtype=np.int32)[None]
        _, cache = tm.prefill_suffix_paged(tp, cache, prompt[None], 0, 0, 7,
                                           16, bt, bt)
        n = len(fused)
        pos = np.array([7], np.int32)
        logits, _ = tm.decode_step(
            tp, cache, np.array([[3]], np.int32), torch.from_numpy(pos),
            block_tables=bt,
            positions=pos[:, None] if explicit else None)
        assert (len(fused) > n) == (not explicit)
        outs.append(logits)
    _close(outs[1], outs[0].numpy(), dict(atol=1e-5, rtol=1e-5))
