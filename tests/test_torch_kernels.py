"""The port's plain kernel versions against the JAX package's.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held to its
twin in ``repro.kernels.ref`` on the same inputs (made with numpy from a
seed), and the three kernels on the serving path -- flash attention, the
fused paged decode and the paged prefill -- are also held to their Pallas
kernels run in interpret mode.  The CUDA kernels themselves run only on a
GPU (``tests/test_torch_cuda.py``); here their front doors take the plain
versions, and their shape contracts are checked on CPU tensors.

Tolerances: f32 at atol = rtol = 2e-5 (the JAX kernel tests' bound: the
two sides sum in different orders).  bf16 inputs are compared in f32 at
2e-2: the two frameworks round the bf16 softmax probabilities and the
bf16 P.V product at different points (one bf16 ulp is 2^-8 ~ 4e-3
relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.backend import dispatch as JD  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bhsd as pallas_flash)
from repro.kernels.paged_attention import (  # noqa: E402
    fused_paged_decode_grouped as pallas_fused,
    paged_prefill_attention_grouped as pallas_prefill)
from repro_torch.backend import dispatch as TD  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import paged_attention as TP  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"float32": (jnp.float32, F32), "bfloat16": (jnp.bfloat16, BF16)}


def both(x, dtype=jnp.float32):
    """The same values as a jax array and a CPU torch tensor (bf16 moves
    bit-exactly through the weight bridge's path)."""
    a = jnp.asarray(x, dtype)
    return a, tensor_from_numpy(np.asarray(a), "cpu")


def close(t, a, tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(a, np.float32), **tol)


def _pool_setup(seed, *, b=3, hk=2, g=2, d=128, page=16, nb=3, s=None,
                dtype=jnp.float32):
    """Random paged operands with DISJOINT per-slot tables plus the sink
    page, one slot's last table entry left as the sentinel (the sink)."""
    r = np.random.default_rng(seed)
    n = b * nb + 1                                   # + sink page
    qshape = (b, hk, g, d) if s is None else (b, hk, g, s, d)
    bt = r.permutation(b * nb).reshape(b, nb).astype(np.int32)
    bt[0, -1] = n - 1                                # sentinel -> sink
    return dict(
        q=both(r.standard_normal(qshape), dtype),
        kn=both(r.standard_normal((b, hk, d)), dtype),
        vn=both(r.standard_normal((b, hk, d)), dtype),
        kp=both(r.standard_normal((n, page, hk, d)), dtype),
        vp=both(r.standard_normal((n, page, hk, d)), dtype),
        bt=both(bt, jnp.int32))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_decode_rope_ref_matches_jax(d, theta):
    r = np.random.default_rng(d)
    xa, xt = both(r.standard_normal((3, 2, 4, d)))
    pos = np.array([[0, 1], [517, 518], [998, 999]], np.int32)
    out = TR.decode_rope_ref(xt, torch.from_numpy(pos), theta)
    close(out, JR.decode_rope_ref(xa, jnp.asarray(pos), theta), F32)


def test_gather_pages_matches_jax_exactly():
    o = _pool_setup(1)
    b, nb = o["bt"][1].shape
    n, p, hk, d = o["kp"][1].shape
    jk, jv = JR._gather_pages(o["kp"][0], o["vp"][0], o["bt"][0], None,
                              None, b, nb, p, hk, d)
    tk, tv = TR._gather_pages(o["kp"][1], o["vp"][1], o["bt"][1].long(),
                              None, None, b, nb, p, hk, d)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


FLASH_MASKS = [(True, 0, 0.0), (True, 48, 0.0), (False, 0, 0.0),
               (True, 0, 30.0)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
def test_flash_attention_ref_matches_jax(dtype, d, causal, window, softcap):
    jdt, tol = DTYPES[dtype]
    r = np.random.default_rng(d + window)
    b, h, hk, sq, skv = 2, 4, 2, 24, 40
    qa, qt = both(r.standard_normal((b, h, sq, d)), jdt)
    ka, kt = both(r.standard_normal((b, hk, skv, d)), jdt)
    va, vt = both(r.standard_normal((b, hk, skv, d)), jdt)
    qp = np.arange(sq, dtype=np.int32) + (skv - sq)
    kp = np.arange(skv, dtype=np.int32)
    kv = (np.arange(skv) % 7 != 3).astype(np.int32)   # ring holes
    kw = dict(causal=causal, window=window, softcap=softcap)
    ja = JR.flash_attention_ref(qa, ka, va, jnp.asarray(qp), jnp.asarray(kp),
                                jnp.asarray(kv), **kw)
    to = TR.flash_attention_ref(qt, kt, vt, torch.from_numpy(qp),
                                torch.from_numpy(kp), torch.from_numpy(kv),
                                **kw)
    close(to, ja, tol)


def test_flash_attention_ref_fully_masked_rows_are_zero():
    r = np.random.default_rng(5)
    qa, qt = both(r.standard_normal((1, 2, 4, 64)))
    ka, kt = both(r.standard_normal((1, 2, 8, 64)))
    qp = np.array([0, 1, 2, 3], np.int32)
    kp = np.arange(8, dtype=np.int32)
    kv = np.array([0, 0, 1, 1, 1, 1, 1, 1], np.int32)   # rows 0, 1 see none
    to = TR.flash_attention_ref(qt, kt, kt, torch.from_numpy(qp),
                                torch.from_numpy(kp), torch.from_numpy(kv))
    assert torch.all(to[:, :, :2] == 0)
    close(to, JR.flash_attention_ref(qa, ka, ka, jnp.asarray(qp),
                                     jnp.asarray(kp), jnp.asarray(kv)), F32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_ref_matches_jax(d, softcap):
    o = _pool_setup(2 + d, d=d)
    lengths = np.array([5, 16, 47], np.int32)        # ragged
    ja = JR.paged_attention_ref(o["q"][0], o["kp"][0], o["vp"][0],
                                o["bt"][0], jnp.asarray(lengths),
                                softcap=softcap)
    to = TR.paged_attention_ref(o["q"][1], o["kp"][1], o["vp"][1],
                                o["bt"][1], torch.from_numpy(lengths),
                                softcap=softcap)
    close(to, ja, F32)


POSITIONS = np.array([15, 21, 44], np.int32)        # page end, mid, last


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_fused_paged_decode_ref_matches_jax(dtype, d, softcap):
    jdt, tol = DTYPES[dtype]
    o = _pool_setup(3 + d, d=d, g=4, dtype=jdt)
    kw = dict(theta=5e6, softcap=softcap)
    ja, jkp, jvp, _, _ = JR.fused_paged_decode_ref(
        o["q"][0], o["kn"][0], o["vn"][0], o["kp"][0], o["vp"][0],
        o["bt"][0], jnp.asarray(POSITIONS), **kw)
    kp, vp = o["kp"][1].clone(), o["vp"][1].clone()
    to, tkp, tvp = TR.fused_paged_decode_ref(
        o["q"][1], o["kn"][1], o["vn"][1], kp, vp, o["bt"][1],
        torch.from_numpy(POSITIONS), **kw)
    assert tkp is kp and tvp is vp                   # written in place
    close(to, ja, tol)
    close(tkp, jkp, tol)
    close(tvp, jvp, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offset", [0, 19])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_prefill_attention_ref_matches_jax(dtype, d, offset, softcap):
    jdt, tol = DTYPES[dtype]
    o = _pool_setup(4 + d + offset, d=d, s=7, dtype=jdt)
    ja = JR.paged_prefill_attention_ref(o["q"][0], o["kp"][0], o["vp"][0],
                                        o["bt"][0], jnp.int32(offset),
                                        softcap=softcap)
    to = TR.paged_prefill_attention_ref(o["q"][1], o["kp"][1], o["vp"][1],
                                        o["bt"][1], offset, softcap=softcap)
    close(to, ja, tol)


# ---------------------------------------------------------------------------
# the three kernels on the path: plain versions against the Pallas kernels
# (interpret mode) on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
def test_flash_plain_matches_pallas_interpret(causal, window, softcap):
    r = np.random.default_rng(11 + window)
    b, h, hk, s, d = 1, 4, 2, 128, 128
    qa, qt = both(r.standard_normal((b, h, s, d)))
    ka, kt = both(r.standard_normal((b, hk, s, d)))
    va, vt = both(r.standard_normal((b, hk, s, d)))
    pos = np.arange(s, dtype=np.int32)
    kv = np.ones((s,), np.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    ja = pallas_flash(qa, ka, va, jnp.asarray(pos), jnp.asarray(pos),
                      jnp.asarray(kv), interpret=True, **kw)
    to = TF.flash_attention_bhsd(qt, kt, vt, torch.from_numpy(pos),
                                 torch.from_numpy(pos), torch.from_numpy(kv),
                                 **kw)
    close(to, ja, F32)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_fused_decode_plain_matches_pallas_interpret(softcap):
    o = _pool_setup(21, d=128, g=4, page=16)
    kw = dict(theta=5e6, softcap=softcap)
    ja, jkp, jvp, _, _ = pallas_fused(
        o["q"][0], o["kn"][0], o["vn"][0], o["kp"][0], o["vp"][0],
        o["bt"][0], jnp.asarray(POSITIONS), interpret=True, **kw)
    to, tkp, tvp = TP.fused_paged_decode_grouped(
        o["q"][1], o["kn"][1], o["vn"][1], o["kp"][1].clone(),
        o["vp"][1].clone(), o["bt"][1], torch.from_numpy(POSITIONS), **kw)
    close(to, ja, F32)
    # the sink page takes every sentinel write; compare the mapped pages
    close(tkp[:-1], jkp[:-1], F32)
    close(tvp[:-1], jvp[:-1], F32)


@pytest.mark.parametrize("offset", [0, 24])
def test_paged_prefill_plain_matches_pallas_interpret(offset):
    o = _pool_setup(31 + offset, d=128, g=2, s=8, page=16)
    ja = pallas_prefill(o["q"][0], o["kp"][0], o["vp"][0], o["bt"][0],
                        jnp.int32(offset), interpret=True)
    to = TP.paged_prefill_attention_grouped(o["q"][1], o["kp"][1],
                                            o["vp"][1], o["bt"][1], offset)
    close(to, ja, F32)


# ---------------------------------------------------------------------------
# front doors: the layout adapters against the JAX dispatch (ref path)
# ---------------------------------------------------------------------------

def test_dispatch_fused_paged_decode_matches_jax():
    r = np.random.default_rng(41)
    b, h, hk, d, page, nb = 2, 4, 2, 64, 8, 3
    n = b * nb + 1
    qa, qt = both(r.standard_normal((b, 1, h, d)))
    ka, kt = both(r.standard_normal((b, 1, hk, d)))
    va, vt = both(r.standard_normal((b, 1, hk, d)))
    kpa, kpt = both(r.standard_normal((n, page, hk, d)))
    vpa, vpt = both(r.standard_normal((n, page, hk, d)))
    bt = r.permutation(b * nb).reshape(b, nb).astype(np.int32)
    bt[1, 2] = n + 5                                 # out of range: clipped
    pos = np.array([3, 17], np.int32)
    ja, jkp, jvp, _, _ = JD.dispatch_fused_paged_decode(
        qa, ka, va, kpa, vpa, jnp.asarray(bt), jnp.asarray(pos), theta=1e4)
    to, tkp, tvp = TD.dispatch_fused_paged_decode(
        qt, kt, vt, kpt, vpt, torch.from_numpy(bt), torch.from_numpy(pos),
        theta=1e4)
    close(to, ja, F32)
    close(tkp, jkp, F32)
    close(tvp, jvp, F32)


def test_dispatch_paged_prefill_and_flash_match_jax():
    r = np.random.default_rng(43)
    b, s, h, hk, d, page, nb = 1, 6, 4, 2, 64, 4, 5
    n = nb + 1
    qa, qt = both(r.standard_normal((b, s, h, d)))
    kpa, kpt = both(r.standard_normal((n, page, hk, d)))
    vpa, vpt = both(r.standard_normal((n, page, hk, d)))
    bt = np.array([[2, 0, 4, 1, n - 1]], np.int32)
    ja = JD.dispatch_paged_prefill_attention(qa, kpa, vpa, jnp.asarray(bt),
                                             jnp.int32(9))
    to = TD.dispatch_paged_prefill_attention(qt, kpt, vpt,
                                             torch.from_numpy(bt), 9)
    close(to, ja, F32)
    ka, kt = both(r.standard_normal((b, s, hk, d)))
    pos = np.arange(s, dtype=np.int32)
    ja = JD.dispatch_flash_attention(qa, ka, ka, q_pos=jnp.asarray(pos),
                                     k_pos=jnp.asarray(pos))
    to = TD.dispatch_flash_attention(qt, kt, kt, q_pos=torch.from_numpy(pos),
                                     k_pos=torch.from_numpy(pos))
    close(to, ja, F32)


def test_kernel_path_is_decided_by_the_device():
    assert TD.kernel_path("cpu") == "cpu-plain"
    assert TD.kernel_path(torch.device("cuda", 0)) == "cuda"


# ---------------------------------------------------------------------------
# shape contracts of the CUDA kernels (checked before any launch)
# ---------------------------------------------------------------------------

def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_fused_decode_contract_accepts_main_path_shapes():
    b, hk, g, d, n, p, nb = 4, 4, 8, 128, 65, 16, 64
    dims = TP.check_fused_decode_contract(
        _t(b, hk, g, d, dtype=torch.bfloat16),
        _t(b, hk, d, dtype=torch.bfloat16), _t(b, hk, d, dtype=torch.bfloat16),
        _t(n, p, hk, d, dtype=torch.bfloat16),
        _t(n, p, hk, d, dtype=torch.bfloat16),
        _t(b, nb, dtype=torch.int32), _t(b, dtype=torch.int32))
    assert dims == (b, hk, g, d, p, nb)


@pytest.mark.parametrize("bad", ["head_dim", "groups", "dtype", "pool_dtype",
                                 "table_dtype", "noncontig", "positions"])
def test_fused_decode_contract_raises_outside_it(bad):
    b, hk, g, d, n, p, nb = 2, 2, 4, 128, 9, 16, 4
    q, kn, vn = _t(b, hk, g, d), _t(b, hk, d), _t(b, hk, d)
    kp, vp = _t(n, p, hk, d), _t(n, p, hk, d)
    bt, pos = _t(b, nb, dtype=torch.int32), _t(b, dtype=torch.int32)
    if bad == "head_dim":
        q, kn, vn = _t(b, hk, g, 16), _t(b, hk, 16), _t(b, hk, 16)
        kp, vp = _t(n, p, hk, 16), _t(n, p, hk, 16)
    elif bad == "groups":
        q = _t(b, hk, 3, d)
    elif bad == "dtype":
        q, kn, vn, kp, vp = (x.to(torch.float16) for x in (q, kn, vn, kp, vp))
    elif bad == "pool_dtype":
        kp = kp.to(torch.bfloat16)
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "noncontig":
        q = _t(b, hk, d, g).transpose(2, 3)
    elif bad == "positions":
        pos = _t(b + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        TP.check_fused_decode_contract(q, kn, vn, kp, vp, bt, pos)


def test_prefill_and_flash_contracts_raise_outside_them():
    q = _t(1, 2, 4, 8, 128)
    kp = _t(5, 16, 2, 128)
    bt = _t(1, 4, dtype=torch.int32)
    assert TP.check_paged_prefill_contract(q, kp, kp, bt, 16) == \
        (1, 2, 4, 8, 128, 16, 4)
    with pytest.raises(ValueError):
        TP.check_paged_prefill_contract(q, kp, kp, bt, -1)
    with pytest.raises(ValueError):
        TP.check_paged_prefill_contract(q, _t(5, 16, 3, 128), kp, bt, 0)
    qf, kf = _t(1, 4, 8, 128), _t(1, 2, 8, 128)
    pos = _t(8, dtype=torch.int32)
    assert TF.check_flash_contract(qf, kf, kf, pos, pos, pos) == \
        (1, 4, 2, 8, 8, 128)
    with pytest.raises(ValueError):
        TF.check_flash_contract(_t(1, 3, 8, 128), kf, kf, pos, pos, pos)
    with pytest.raises(ValueError):
        TF.check_flash_contract(qf, kf, kf, pos.long(), pos, pos)


def test_wrappers_raise_on_a_device_without_a_kernel():
    """No silent fallback: only CPU tensors take the plain version."""
    q = torch.zeros((1, 4, 8, 64), device="meta")
    k = torch.zeros((1, 2, 8, 64), device="meta")
    pos = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TF.flash_attention_bhsd(q, k, k, pos, pos, pos)
