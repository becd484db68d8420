"""The port's training loss and its gradients against the JAX package's.

JAX draws the weights of a reduced f32 config of every family;
``repro_torch.bridge.params_from_numpy`` carries them across, and the
same numpy batch (seeded, with some labels < 0 on the token families)
goes through ``Model.loss`` in both.  The port's gradients come from
autograd (``training.trainer.value_and_grad``), JAX's from
``jax.value_and_grad``; ``bridge.params_to_numpy`` restacks the port's
groups so that the two trees compare leaf by leaf.  Families: yi-6b
(dense), qwen2-moe (MoE), jamba (attention + mamba, MoE layers),
xlstm-125m (mLSTM + sLSTM), gemma2-9b (windows, softcaps, post-norms),
nemotron-4-15b (LayerNorm, squared ReLU), deit-t (vision), whisper-base
(encoder-decoder) and qwen2-vl on distinct M-RoPE streams (with remat:
``test_torch_training.py``).  Then the fused head + cross-entropy:
``chunked_softmax_xent`` over several chunks (with and without the
final softcap, labels < 0) and ``loss``'s chunked branch with
``REPRO_CHUNKED_CE`` lowered for both packages.

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 of that leaf's largest JAX magnitude, every family.  xlstm-125m is
held at one pattern period (three mLSTM layers and an sLSTM layer): at
two (eight layers) its f32 gradients are ill-conditioned -- weights
times 1 + 1e-7 noise moved the port's own gradients by up to 8.6e-3 of
a leaf's largest (seeds 0-2), as much as the two frameworks differ
(9.7e-3).  At one period that noise moved them by at most 2.1e-4 and
the frameworks differed by at most 5.1e-5 (seeds 0-5).
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
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.training.trainer import value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4      # of the leaf's largest JAX magnitude

# one reduced config per family (layers: one pattern period or two;
# xlstm-125m one, see the module docstring)
FAMILIES = {"yi-6b": 2, "qwen2-moe-a2.7b": 2,
            "jamba-1.5-large-398b": 8, "xlstm-125m": 4, "gemma2-9b": 2,
            "nemotron-4-15b": 2, "deit-t": 2, "whisper-base": 2,
            "qwen2-vl-72b": 2}


def configs(name, **kw):
    layers = FAMILIES.get(name, 2)
    jc = j_reduced(J_REGISTRY[name], layers=layers, **kw)
    tc = t_reduced(T_REGISTRY[name], layers=layers, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def make_batch(cfg, b=2, s=20, seed=0):
    """A numpy batch of ``cfg``'s family: tokens or embeddings, labels
    (two masked on the token families), M-RoPE positions on three
    distinct streams for qwen2-vl."""
    r = np.random.default_rng(seed)
    d, v = cfg.d_model, cfg.vocab_size

    def emb(*shape):
        return r.standard_normal(shape).astype(np.float32)

    if cfg.family == "vision":
        return {"embeds": emb(b, s, d),
                "labels": r.integers(0, v, (b,)).astype(np.int32)}
    labels = r.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :2] = -1
    if cfg.family == "audio":
        return {"enc_embeds": emb(b, 2 * s, d),
                "dec_tokens": r.integers(0, v, (b, s)).astype(np.int32),
                "labels": labels}
    if cfg.family == "vlm":
        pos = np.stack([np.broadcast_to(np.arange(s), (b, s)),
                        r.integers(0, 2 * s, (b, s)),
                        r.integers(0, 3 * s, (b, s))]).astype(np.int32)
        return {"embeds": emb(b, s, d), "labels": labels, "positions": pos}
    return {"tokens": r.integers(0, v, (b, s)).astype(np.int32),
            "labels": labels}


def flat(tree):
    """key -> numpy array of a JAX-layout tree."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def jax_loss_and_grads(jm, jp, batch, remat):
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=remat))(jp)
    return float(loss), flat(grads)


def port_loss_and_grads(tm, tp, batch, remat):
    loss, grads = value_and_grad(tm, tp, batch, remat=remat)
    return float(loss), flat(params_to_numpy(grads))


def hold(jl, jg, tl, tg, grad_tol=GRAD_TOL):
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    bad = {}
    for key, j in jg.items():
        scale = float(np.abs(j).max())
        err = float(np.abs(tg[key].astype(np.float64) - j).max())
        if err > grad_tol * scale:
            bad[key] = (err, scale)
    assert not bad, bad


def pair(name, seed=0, **kw):
    jc, tc = configs(name, **kw)
    jm, tm = j_build(jc), t_build(tc, device="cpu")
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp, tc


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_grads_match_jax(name):
    jm, jp, tm, tp, cfg = pair(name)
    batch = make_batch(cfg)
    jl, jg = jax_loss_and_grads(jm, jp, batch, False)
    tl, tg = port_loss_and_grads(tm, tp, batch, False)
    assert np.isfinite(tl)
    hold(jl, jg, tl, tg)


def test_remat_changes_nothing_in_the_port():
    """remat recomputes the same forward: loss and gradients equal."""
    _, _, tm, tp, cfg = pair("jamba-1.5-large-398b")
    batch = make_batch(cfg, seed=3)
    la, ga = port_loss_and_grads(tm, tp, batch, False)
    lb, gb = port_loss_and_grads(tm, tp, batch, True)
    assert la == lb
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k])


@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["nocap", "softcap"])
def test_chunked_softmax_xent_matches_jax(cap):
    """Four 64-column chunks, labels < 0 among them: the per-token nll
    and its gradients for x and w against JAX's, and against the full
    log-softmax."""
    r = np.random.default_rng(1)
    n, d, v = 24, 32, 256
    x = r.standard_normal((n, d)).astype(np.float32)
    w = (r.standard_normal((d, v)) / np.sqrt(d) * 4).astype(np.float32)
    labels = r.integers(0, v, (n,)).astype(np.int32)
    labels[::5] = -1
    jc = dataclasses.replace(j_reduced(J_REGISTRY["yi-6b"]),
                             final_logit_softcap=cap)
    tc = dataclasses.replace(t_reduced(T_REGISTRY["yi-6b"]),
                             final_logit_softcap=cap)
    mask = (labels >= 0).astype(np.float32)

    def jf(x, w):
        return jnp.sum(JL.chunked_softmax_xent(x, w, jnp.asarray(labels), jc,
                                               chunk=64) * mask)
    jnll = np.asarray(JL.chunked_softmax_xent(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), jc, chunk=64))
    jgx, jgw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = torch.from_numpy(labels).long()
    tnll = TL.chunked_softmax_xent(tx, tw, tl, tc, chunk=64)
    (tnll * torch.from_numpy(mask)).sum().backward()
    np.testing.assert_allclose(tnll.detach().numpy(), jnll, rtol=1e-5,
                               atol=1e-5)
    for t, j in ((tx.grad, jgx), (tw.grad, jgw)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= GRAD_TOL * np.abs(j).max()
    # the online logsumexp is the full log-softmax's
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    if cap:
        logits = cap * torch.tanh(logits / cap)
    full = torch.logsumexp(logits, -1) - torch.gather(
        logits, 1, tl.clamp_min(0)[:, None])[:, 0]
    keep = labels >= 0
    np.testing.assert_allclose(tnll.detach().numpy()[keep],
                               full.numpy()[keep], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["yi-6b", "gemma2-9b", "whisper-base"])
def test_chunked_loss_branch_matches_jax(name, monkeypatch):
    """``REPRO_CHUNKED_CE`` lowered to 8192 for both packages: a 16,384
    vocabulary takes the fused branch in two 8,192-column chunks (gemma2
    with its final softcap and tied head, whisper's audio decoder)."""
    monkeypatch.setenv("REPRO_CHUNKED_CE", "8192")
    jm, jp, tm, tp, cfg = pair(name, vocab=16384)
    assert tm._use_chunked_ce() and jm._use_chunked_ce()
    batch = make_batch(cfg, s=12)
    jl, jg = jax_loss_and_grads(jm, jp, batch, False)
    tl, tg = port_loss_and_grads(tm, tp, batch, False)
    hold(jl, jg, tl, tg)
    # the fused branch equals the full-logit branch it replaces
    monkeypatch.setenv("REPRO_CHUNKED_CE", "0")
    assert not tm._use_chunked_ce()
    ul = float(tm.loss(tp, batch))
    assert abs(ul - tl) <= LOSS_RTOL * abs(tl)
