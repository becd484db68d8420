"""The port's plain kernel versions against the JAX package's.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held to its
twin in ``repro.kernels.ref`` on the same inputs (made with numpy from a
seed), and the kernels on the serving path -- flash attention, the fused
paged decode, the paged prefill, and jamba's unfused paged decode and
linear scan -- are also held to their Pallas kernels run in interpret
mode.  The CUDA kernels themselves run only on a
GPU (``tests/test_torch_cuda.py``); here their front doors take the plain
versions, and their shape contracts are checked on CPU tensors.

Tolerances: f32 at atol = rtol = 2e-5 (the JAX kernel tests' bound: the
two sides sum in different orders).  bf16 inputs are compared in f32 at
2e-2: the two frameworks round the bf16 softmax probabilities and the
bf16 P.V product at different points (one bf16 ulp is 2^-8 ~ 4e-3
relative).  int8 rows must be equal; their f32 scales agree to rtol 1e-6
(the fused decode's scale is amax/127 of a roped row, and the two
frameworks' f32 sines may differ in the last bit).
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
from repro.kernels.linear_scan import linear_scan as pallas_scan  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    fused_paged_decode_grouped as pallas_fused,
    paged_attention_grouped as pallas_paged,
    paged_prefill_attention_grouped as pallas_prefill)
from repro_torch.backend import dispatch as TD  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import linear_scan as TS  # noqa: E402
from repro_torch.kernels import paged_attention as TP  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"float32": (jnp.float32, F32), "bfloat16": (jnp.bfloat16, BF16)}


SCALES = dict(rtol=1e-6, atol=0)


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
    to, tkp, tvp, _, _ = TR.fused_paged_decode_ref(
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
    to, tkp, tvp, _, _ = TP.fused_paged_decode_grouped(
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
    to, tkp, tvp, _, _ = TD.dispatch_fused_paged_decode(
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
        q = _t(b, hk, 9, d)
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


def _shifted(*shape, dtype=torch.bfloat16):
    """A contiguous tensor that starts 2 bytes past a 16-byte boundary."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("bad", ["q", "k_pages", "v_pages"])
def test_paged_prefill_contract_raises_on_misaligned_operands(bad):
    ops = dict(q=_t(1, 2, 4, 8, 64, dtype=torch.bfloat16),
               k_pages=_t(5, 16, 2, 64, dtype=torch.bfloat16),
               v_pages=_t(5, 16, 2, 64, dtype=torch.bfloat16))
    ops[bad] = _shifted(*ops[bad].shape)
    bt = _t(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        TP.check_paged_prefill_contract(ops["q"], ops["k_pages"],
                                        ops["v_pages"], bt, 0)


@pytest.mark.parametrize("bad", ["q", "k", "v"])
def test_flash_contract_raises_on_misaligned_operands(bad):
    ops = dict(q=_t(1, 4, 8, 64), k=_t(1, 2, 8, 64), v=_t(1, 2, 8, 64))
    ops[bad] = _shifted(*ops[bad].shape, dtype=torch.float32)
    pos = _t(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        TF.check_flash_contract(ops["q"], ops["k"], ops["v"], pos, pos, pos)


# (label, wrapper plan, expected (splits, keys per split)) at 132 SMs
SPLIT_PLANS = [
    # phase 3 and serve-int8-spec: 4 slots x 4 kv heads, one 40-row tile,
    # a 64-page table of 16 -> 8 splits of 128 keys, 128 blocks
    ("verify B=4 S=5", lambda: TP.prefill_split(4, 4, 8, 5, 16, 64), (8, 128)),
    # the verify window of a single live slot
    ("verify B=1 S=5", lambda: TP.prefill_split(1, 4, 8, 5, 16, 64), (16, 64)),
    # phase 3's prefill rows: 128 blocks and more fill the card
    ("prefill S=256 offset 0",
     lambda: TP.prefill_split(1, 4, 8, 256, 16, 64, 0), (1, 256)),
    ("prefill S=256 offset 256",
     lambda: TP.prefill_split(1, 4, 8, 256, 16, 64, 256), (1, 512)),
    ("prefill S=600 offset 0",
     lambda: TP.prefill_split(1, 4, 8, 600, 16, 64, 0), (1, 640)),
    # the serve's shortest prompt: 52 blocks over 100 keys
    ("prefill S=100 offset 0",
     lambda: TP.prefill_split(1, 4, 8, 100, 16, 64, 0), (2, 64)),
    # serve-hybrid's attention layers: 8 kv heads of 8
    ("hybrid prefill S=100",
     lambda: TP.prefill_split(1, 8, 8, 100, 16, 64, 0), (1, 128)),
    ("flash Sq=Skv=512 H=32", lambda: TF.flash_split(1, 32, 512, 512),
     (1, 512)),
    ("flash Sq=Skv=100 H=32", lambda: TF.flash_split(1, 32, 100, 100),
     (2, 64)),
    ("flash Sq=70 Skv=1000 H=4", lambda: TF.flash_split(1, 4, 70, 1000),
     (16, 64)),
]


@pytest.mark.parametrize("label,plan,want", SPLIT_PLANS,
                         ids=[c[0] for c in SPLIT_PLANS])
def test_split_plan_at_serve_and_phase3_shapes(label, plan, want):
    assert plan() == want


@pytest.mark.parametrize("blocks", [1, 3, 16, 52, 66, 131, 132, 300])
@pytest.mark.parametrize("keys", [1, 63, 64, 65, 100, 1000, 1024, 5000])
def test_split_plan_covers_every_key_once(blocks, keys):
    """Splits of whole 64-key tiles that cover [0, keys), none empty, at
    most 16, and one whenever the blocks alone fill 132 SMs."""
    from repro_torch.kernels import _build
    n, per = _build.split_plan(blocks, keys, 132)
    assert per % 64 == 0 and 1 <= n <= 16
    assert (n - 1) * per < keys <= n * per or (keys <= per and n == 1)
    assert n == 1 or blocks * 2 <= 132
    assert n <= -(-keys // 64)


def test_wrappers_raise_on_a_device_without_a_kernel():
    """No silent fallback: only CPU tensors take the plain version."""
    q = torch.zeros((1, 4, 8, 64), device="meta")
    k = torch.zeros((1, 2, 8, 64), device="meta")
    pos = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TF.flash_attention_bhsd(q, k, k, pos, pos, pos)


# ---------------------------------------------------------------------------
# int8 pools and the per-slot verify window
# ---------------------------------------------------------------------------

def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _int8_pools(seed, *, n, page, hk, d):
    """int8 pools and scales quantized once by the JAX helper, as a jax
    and a torch copy each: (kp, vp, ks, vs) pairs."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        q, sc = JR.quantize_int8_rows(
            jnp.asarray(r.standard_normal((n, page, hk, d)), jnp.float32))
        out.append(((q, torch.from_numpy(np.array(q))),
                    (sc, torch.from_numpy(np.array(sc)))))
    (kp, ks), (vp, vs) = out
    return kp, vp, ks, vs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_int8_rows_matches_jax(dtype):
    """Random rows, an all-zero row (scale 1) and exact .5 ties (a row
    with amax 127 has scale 1, so 2.5 -> 2, -3.5 -> -4, 0.5 -> 0: half to
    even, as jnp.round)."""
    jdt, _ = DTYPES[dtype]
    x = np.random.default_rng(3).standard_normal((40, 50, 64)) * 5
    x[1, 2] = 0.0
    x[2, 0] = 0.0
    x[2, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    xa, xt = both(x, jdt)
    jq, js = JR.quantize_int8_rows(xa)
    tq, ts = TR.quantize_int8_rows(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SCALES)
    assert tq[2, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert ts[1, 2] == 1.0 and not tq[1, 2].any()
    # the scale is the correctly rounded f32 quotient amax / 127, as the
    # kernels' __fdiv_rn gives it (not amax times a rounded 1/127)
    amax = np.abs(xt.float().numpy()).max(-1)
    np.testing.assert_array_equal(
        ts.numpy(), np.where(amax > 0, amax / np.float32(127.0),
                             np.float32(1.0)))
    np.testing.assert_allclose(TR.dequantize_int8(tq, ts).numpy(),
                               np.asarray(JR.dequantize_int8(jq, js)),
                               **SCALES)


def _fused_int8_case(seed, dtype, softcap):
    jdt, tol = DTYPES[dtype]
    o = _pool_setup(seed, d=128, g=4, page=16, dtype=jdt)
    n = o["kp"][1].shape[0]
    kp, vp, ks, vs = _int8_pools(seed, n=n, page=16, hk=2, d=128)
    kw = dict(theta=5e6, softcap=softcap)
    args_j = (o["q"][0], o["kn"][0], o["vn"][0], kp[0], vp[0], o["bt"][0],
              jnp.asarray(POSITIONS))
    args_t = (o["q"][1], o["kn"][1], o["vn"][1], kp[1].clone(),
              vp[1].clone(), o["bt"][1], torch.from_numpy(POSITIONS))
    scales_t = dict(k_scales=ks[1].clone(), v_scales=vs[1].clone())
    return args_j, (ks[0], vs[0]), args_t, scales_t, kw, tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_fused_paged_decode_ref_int8_matches_jax(dtype, softcap):
    """The int8 mode against the JAX ref: the fresh rows quantize after
    the roped key is cast to the activation dtype, on both sides."""
    aj, (ksj, vsj), at, st_, kw, tol = _fused_int8_case(51, dtype, softcap)
    ja, jkp, jvp, jks, jvs = JR.fused_paged_decode_ref(
        *aj, k_scales=ksj, v_scales=vsj, **kw)
    to, tkp, tvp, tks, tvs = TR.fused_paged_decode_ref(*at, **st_, **kw)
    assert tkp is at[3] and tks is st_["k_scales"]     # written in place
    close(to, ja, tol)
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), **SCALES)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **SCALES)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_fused_decode_int8_plain_matches_pallas_interpret(softcap):
    aj, (ksj, vsj), at, st_, kw, _ = _fused_int8_case(53, "float32",
                                                       softcap)
    ja, jkp, jvp, jks, jvs = pallas_fused(*aj, k_scales=ksj, v_scales=vsj,
                                          interpret=True, **kw)
    to, tkp, tvp, tks, tvs = TP.fused_paged_decode_grouped(*at, **st_,
                                                           **kw)
    close(to, ja, F32)
    # the sink page takes every sentinel write; compare the mapped pages
    np.testing.assert_array_equal(tkp[:-1].numpy(), np.asarray(jkp)[:-1])
    np.testing.assert_array_equal(tvp[:-1].numpy(), np.asarray(jvp)[:-1])
    np.testing.assert_allclose(tks[:-1].numpy(), np.asarray(jks)[:-1],
                               **SCALES)
    np.testing.assert_allclose(tvs[:-1].numpy(), np.asarray(jvs)[:-1],
                               **SCALES)


VERIFY_OFFSETS = np.array([15, 3, 40], np.int32)   # page end, early, deep


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("window", ["prefill", "verify"])
def test_paged_window_refs_with_scales_match_jax(dtype, pool, window):
    """Prefill (one offset) and verify (per-slot offsets, S = K+1 = 5)
    over fp and int8 pools, against the JAX refs."""
    jdt, tol = DTYPES[dtype]
    o = _pool_setup(61, d=64, s=5, dtype=jdt)
    kp, vp = o["kp"], o["vp"]
    kw_j, kw_t = {}, {}
    if pool == "int8":
        kp, vp, ks, vs = _int8_pools(62, n=kp[1].shape[0], page=16, hk=2,
                                     d=64)
        kw_j = dict(k_scales=ks[0], v_scales=vs[0])
        kw_t = dict(k_scales=ks[1], v_scales=vs[1])
    if window == "prefill":
        jf, tf, off_j, off_t = (JR.paged_prefill_attention_ref,
                                TR.paged_prefill_attention_ref,
                                jnp.int32(19), 19)
    else:
        jf, tf = JR.paged_verify_attention_ref, TR.paged_verify_attention_ref
        off_j, off_t = jnp.asarray(VERIFY_OFFSETS), torch.from_numpy(
            VERIFY_OFFSETS)
    ja = jf(o["q"][0], kp[0], vp[0], o["bt"][0], off_j, softcap=30.0,
            **kw_j)
    to = tf(o["q"][1], kp[1], vp[1], o["bt"][1], off_t, softcap=30.0, **kw_t)
    close(to, ja, tol)


def test_verify_plain_matches_prefill_slot_by_slot():
    """The per-slot verify is the prefill run once per slot at that
    slot's offset: the wrapper's two doors agree on CPU tensors."""
    o = _pool_setup(63, d=128, s=5)
    kp, vp, ks, vs = _int8_pools(64, n=o["kp"][1].shape[0], page=16, hk=2,
                                 d=128)
    sc = dict(k_scales=ks[1], v_scales=vs[1])
    ver = TP.paged_verify_attention_grouped(
        o["q"][1], kp[1], vp[1], o["bt"][1],
        torch.from_numpy(VERIFY_OFFSETS), **sc)
    for b, off in enumerate(VERIFY_OFFSETS):
        pre = TP.paged_prefill_attention_grouped(
            o["q"][1][b:b + 1], kp[1], vp[1], o["bt"][1][b:b + 1],
            int(off), **sc)
        close(ver[b:b + 1], pre, F32)


def test_dispatch_int8_decode_and_verify_match_jax():
    """The int8 fused decode and the paged verify front doors (model
    layout in, sentinel tables clipped) against the JAX dispatch."""
    r = np.random.default_rng(71)
    b, h, hk, d, page, nb = 2, 4, 2, 64, 8, 3
    n = b * nb + 1
    qa, qt = both(r.standard_normal((b, 1, h, d)))
    ka, kt = both(r.standard_normal((b, 1, hk, d)))
    va, vt = both(r.standard_normal((b, 1, hk, d)))
    kp, vp, ks, vs = _int8_pools(72, n=n, page=page, hk=hk, d=d)
    bt = r.permutation(b * nb).reshape(b, nb).astype(np.int32)
    bt[1, 2] = n + 5                                 # out of range: clipped
    pos = np.array([3, 17], np.int32)
    ja, jkp, jvp, jks, jvs = JD.dispatch_fused_paged_decode(
        qa, ka, va, kp[0], vp[0], jnp.asarray(bt), jnp.asarray(pos),
        theta=1e4, k_scales=ks[0], v_scales=vs[0])
    to, tkp, tvp, tks, tvs = TD.dispatch_fused_paged_decode(
        qt, kt, vt, kp[1].clone(), vp[1].clone(), torch.from_numpy(bt),
        torch.from_numpy(pos), theta=1e4, k_scales=ks[1].clone(),
        v_scales=vs[1].clone())
    close(to, ja, F32)
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), **SCALES)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), **SCALES)
    s = 3
    qa, qt = both(r.standard_normal((b, s, h, d)))
    off = np.array([5, 12], np.int32)
    for scale_kw in ({}, "int8"):
        kw_j = kw_t = {}
        if scale_kw:
            kw_j = dict(k_scales=ks[0], v_scales=vs[0])
            kw_t = dict(k_scales=ks[1], v_scales=vs[1])
        pools_j = (kp[0], vp[0]) if scale_kw else (
            JR.dequantize_int8(kp[0], ks[0]), JR.dequantize_int8(vp[0],
                                                                  vs[0]))
        pools_t = (kp[1], vp[1]) if scale_kw else (
            TR.dequantize_int8(kp[1], ks[1]), TR.dequantize_int8(vp[1],
                                                                  vs[1]))
        ja = JD.dispatch_paged_verify_attention(
            qa, *pools_j, jnp.asarray(bt), jnp.asarray(off), **kw_j)
        to = TD.dispatch_paged_verify_attention(
            qt, *pools_t, torch.from_numpy(bt), torch.from_numpy(off),
            **kw_t)
        close(to, ja, F32)
        ja = JD.dispatch_paged_prefill_attention(
            qa[:1], *pools_j, jnp.asarray(bt[:1]), jnp.int32(9), **kw_j)
        to = TD.dispatch_paged_prefill_attention(
            qt[:1], *pools_t, torch.from_numpy(bt[:1]), 9, **kw_t)
        close(to, ja, F32)


def test_int8_contracts_accept_pools_with_scales():
    b, hk, g, d, n, p, nb = 4, 4, 8, 128, 65, 16, 64
    bf = dict(dtype=torch.bfloat16)
    i8 = dict(dtype=torch.int8)
    sc = _t(n, p, hk)
    assert TP.check_fused_decode_contract(
        _t(b, hk, g, d, **bf), _t(b, hk, d, **bf), _t(b, hk, d, **bf),
        _t(n, p, hk, d, **i8), _t(n, p, hk, d, **i8),
        _t(b, nb, dtype=torch.int32), _t(b, dtype=torch.int32), sc, sc) \
        == (b, hk, g, d, p, nb)
    offs = _t(b, dtype=torch.int32)
    assert TP.check_paged_prefill_contract(
        _t(b, hk, g, 5, d, **bf), _t(n, p, hk, d, **i8),
        _t(n, p, hk, d, **i8), _t(b, nb, dtype=torch.int32), offs, sc,
        sc) == (b, hk, g, 5, d, p, nb)


@pytest.mark.parametrize("bad", ["no_scales", "fp_with_scales",
                                 "scale_dtype", "scale_shape",
                                 "offsets_dtype", "offsets_shape",
                                 "int16_pool"])
def test_int8_contracts_raise_outside_them(bad):
    b, hk, g, s, d, n, p, nb = 2, 2, 4, 5, 64, 9, 16, 4
    q = _t(b, hk, g, s, d)
    kp = vp = _t(n, p, hk, d, dtype=torch.int8)
    ks = vs = _t(n, p, hk)
    bt, offs = _t(b, nb, dtype=torch.int32), _t(b, dtype=torch.int32)
    if bad == "no_scales":
        ks = vs = None
    elif bad == "fp_with_scales":
        kp = vp = _t(n, p, hk, d)
    elif bad == "scale_dtype":
        ks = _t(n, p, hk, dtype=torch.bfloat16)
    elif bad == "scale_shape":
        vs = _t(n, p, hk, 1)
    elif bad == "offsets_dtype":
        offs = offs.long()
    elif bad == "offsets_shape":
        offs = _t(b + 1, dtype=torch.int32)
    elif bad == "int16_pool":
        kp = vp = _t(n, p, hk, d, dtype=torch.int16)
    with pytest.raises(ValueError):
        TP.check_paged_prefill_contract(q, kp, vp, bt, offs, ks, vs)


# ---------------------------------------------------------------------------
# jamba's kernels: the unfused paged decode and the linear scan
# ---------------------------------------------------------------------------

SCAN_SHAPES = [(2, 128, 256), (4, 256, 128), (1, 1, 384)]


def _scan_inputs(seed, n, s, f):
    r = np.random.default_rng(seed)
    return (both(r.uniform(0.5, 0.999, (n, s, f))),
            both(r.standard_normal((n, s, f))),
            both(r.standard_normal((n, f))))


@pytest.mark.parametrize("n,s,f", SCAN_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_ref_matches_jax(n, s, f, with_h0):
    """The sequential f32 carry against the JAX ref's ``lax.scan``: both
    round the product and the sum separately, so they agree to the last
    bit up to XLA's choice to contract them (F32 tolerance)."""
    (aj, at), (bj, bt_), (hj, ht) = _scan_inputs(n * s + f, n, s, f)
    h0j, h0t = (hj, ht) if with_h0 else (None, None)
    out = TR.linear_scan_ref(at, bt_, h0t)
    assert out.dtype == torch.float32 and out.shape == (n, s, f)
    close(out, JR.linear_scan_ref(aj, bj, h0j), F32)


@pytest.mark.parametrize("n,s,f", SCAN_SHAPES[:2])
def test_linear_scan_plain_matches_pallas_interpret(n, s, f):
    """The wrapper's CPU path against the Pallas kernel in interpret mode
    (block sizes as in tests/test_kernels.py), with h0."""
    (aj, at), (bj, bt_), (hj, ht) = _scan_inputs(7 + s, n, s, f)
    ja = pallas_scan(aj, bj, hj, block_s=128, block_f=128, interpret=True)
    close(TS.linear_scan(at, bt_, ht), ja, F32)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_plain_matches_pallas_interpret(softcap):
    """The unfused paged decode's CPU path against the Pallas kernel in
    interpret mode: ragged lengths (one page, mid-page, the whole table
    ending on the sink page)."""
    o = _pool_setup(81, d=128, g=4, page=16)
    lengths = np.array([48, 16, 21], np.int32)
    ja = pallas_paged(o["q"][0], o["kp"][0], o["vp"][0], o["bt"][0],
                      jnp.asarray(lengths), softcap=softcap, interpret=True)
    to = TP.paged_attention_grouped(o["q"][1], o["kp"][1], o["vp"][1],
                                    o["bt"][1], torch.from_numpy(lengths),
                                    softcap=softcap)
    close(to, ja, F32)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_paged_attention_empty_and_overlong_slots_match_jax(pool, softcap):
    """A slot at length 0 and one past its NB * P table: the wrapper's CPU
    path against the Pallas kernel in interpret mode (fp pools; its int8
    pools go to the JAX reference) and JAX's ref.  Length 0 masks every
    key to the same -1e30, so every weight is equal: the uniform mean of V
    over the slot's table rows, which the CUDA kernel also gives."""
    o = _pool_setup(91, d=128, g=4, page=16)
    lengths = np.array([0, 3 * 16 + 5, 21], np.int32)
    if pool == "int8":
        kp, vp, ks, vs = _int8_pools(92, n=o["kp"][1].shape[0], page=16,
                                     hk=2, d=128)
        kw_j = dict(k_scales=ks[0], v_scales=vs[0])
        kw_t = dict(k_scales=ks[1], v_scales=vs[1])
    else:
        kp, vp = o["kp"], o["vp"]
        kw_j = kw_t = {}
    to = TP.paged_attention_grouped(o["q"][1], kp[1], vp[1], o["bt"][1],
                                    torch.from_numpy(lengths),
                                    softcap=softcap, **kw_t)
    ja = JR.paged_attention_ref(o["q"][0], kp[0], vp[0], o["bt"][0],
                                jnp.asarray(lengths), softcap=softcap,
                                **kw_j)
    close(to, ja, F32)
    if pool == "fp":
        pa = pallas_paged(o["q"][0], kp[0], vp[0], o["bt"][0],
                          jnp.asarray(lengths), softcap=softcap,
                          interpret=True)
        close(to, pa, F32)
    vt = vp[1].float()
    if pool == "int8":
        vt = vt * kw_t["v_scales"][..., None]
    mean = vt[o["bt"][1][0].long()].reshape(-1, 2, 128).mean(0)
    close(to[0], mean[:, None].expand(2, 4, 128), F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_attention_ref_with_scales_matches_jax(dtype):
    jdt, tol = DTYPES[dtype]
    o = _pool_setup(83, d=64, dtype=jdt)
    kp, vp, ks, vs = _int8_pools(84, n=o["kp"][1].shape[0], page=16, hk=2,
                                 d=64)
    lengths = np.array([5, 16, 47], np.int32)
    ja = JR.paged_attention_ref(o["q"][0], kp[0], vp[0], o["bt"][0],
                                jnp.asarray(lengths), softcap=30.0,
                                k_scales=ks[0], v_scales=vs[0])
    to = TR.paged_attention_ref(o["q"][1], kp[1], vp[1], o["bt"][1],
                                torch.from_numpy(lengths), softcap=30.0,
                                k_scales=ks[1], v_scales=vs[1])
    close(to, ja, tol)


@pytest.mark.parametrize("pool", ["fp", "int8"])
def test_dispatch_paged_attention_matches_jax(pool):
    """The unfused decode front door (model layout in, out-of-range table
    entries clipped) against the JAX dispatch, which sends int8 pools to
    its reference."""
    r = np.random.default_rng(85)
    b, h, hk, d, page, nb = 2, 4, 2, 64, 8, 3
    n = b * nb + 1
    qa, qt = both(r.standard_normal((b, 1, h, d)))
    bt = r.permutation(b * nb).reshape(b, nb).astype(np.int32)
    bt[1, 2] = n + 5                                 # out of range: clipped
    lengths = np.array([4, 17], np.int32)
    if pool == "int8":
        kp, vp, ks, vs = _int8_pools(86, n=n, page=page, hk=hk, d=d)
        kw_j = dict(k_scales=ks[0], v_scales=vs[0])
        kw_t = dict(k_scales=ks[1], v_scales=vs[1])
    else:
        kp, vp = (both(r.standard_normal((n, page, hk, d)))
                  for _ in range(2))
        kw_j = kw_t = {}
    ja = JD.dispatch_paged_attention(qa, kp[0], vp[0], jnp.asarray(bt),
                                     jnp.asarray(lengths), **kw_j)
    to = TD.dispatch_paged_attention(qt, kp[1], vp[1], torch.from_numpy(bt),
                                     torch.from_numpy(lengths), **kw_t)
    assert to.shape == (b, 1, h * d)
    close(to, ja, F32)


@pytest.mark.parametrize("with_h0", [False, True])
def test_dispatch_linear_scan_matches_jax(with_h0):
    """The scan front door against the JAX dispatch (its ref path) on
    non-contiguous inputs, as the mamba layer's reshapes can give them."""
    (aj, at), (bj, bt_), (hj, ht) = _scan_inputs(87, 3, 9, 40)
    h0j, h0t = (hj, ht) if with_h0 else (None, None)
    ja = JD.dispatch_linear_scan(aj, bj, h0j)
    to = TD.dispatch_linear_scan(at.transpose(0, 1).contiguous()
                                 .transpose(0, 1), bt_, h0t)
    close(to, ja, F32)


def test_paged_decode_and_scan_contracts_accept_main_path_shapes():
    b, hk, g, d, n, p, nb = 4, 8, 8, 128, 257, 16, 64
    bf = dict(dtype=torch.bfloat16)
    lengths = _t(b, dtype=torch.int32)
    assert TP.check_paged_decode_contract(
        _t(b, hk, g, d, **bf), _t(n, p, hk, d, **bf), _t(n, p, hk, d, **bf),
        _t(b, nb, dtype=torch.int32), lengths) == (b, hk, g, d, p, nb)
    sc = _t(n, p, hk)
    i8 = dict(dtype=torch.int8)
    assert TP.check_paged_decode_contract(
        _t(b, hk, g, d, **bf), _t(n, p, hk, d, **i8), _t(n, p, hk, d, **i8),
        _t(b, nb, dtype=torch.int32), lengths, sc, sc) == (b, hk, g, d, p,
                                                           nb)
    f = 262_144
    assert TS.check_linear_scan_contract(_t(4, 1, f), _t(4, 1, f),
                                         _t(4, f)) == (4, 1, f)
    assert TS.check_linear_scan_contract(_t(1, 37, 1000),
                                         _t(1, 37, 1000)) == (1, 37, 1000)


@pytest.mark.parametrize("bad", ["groups", "head_dim", "lengths_dtype",
                                 "lengths_shape", "pool_dtype", "no_scales"])
def test_paged_decode_contract_raises_outside_it(bad):
    b, hk, g, d, n, p, nb = 2, 2, 4, 128, 9, 16, 4
    q, kp, vp = _t(b, hk, g, d), _t(n, p, hk, d), _t(n, p, hk, d)
    bt, ln = _t(b, nb, dtype=torch.int32), _t(b, dtype=torch.int32)
    sc = {}
    if bad == "groups":
        q = _t(b, hk, 9, d)
    elif bad == "head_dim":
        q, kp, vp = _t(b, hk, g, 32), _t(n, p, hk, 32), _t(n, p, hk, 32)
    elif bad == "lengths_dtype":
        ln = ln.long()
    elif bad == "lengths_shape":
        ln = _t(b + 1, dtype=torch.int32)
    elif bad == "pool_dtype":
        kp = vp = _t(n, p, hk, d, dtype=torch.bfloat16)
    elif bad == "no_scales":
        kp = vp = _t(n, p, hk, d, dtype=torch.int8)
    with pytest.raises(ValueError):
        TP.check_paged_decode_contract(q, kp, vp, bt, ln, **sc)


@pytest.mark.parametrize("bad", ["dtype", "shape", "h0_shape", "noncontig",
                                 "rows"])
def test_linear_scan_contract_raises_outside_it(bad):
    a, b, h0 = _t(2, 5, 64), _t(2, 5, 64), _t(2, 64)
    if bad == "dtype":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    elif bad == "shape":
        b = _t(2, 5, 65)
    elif bad == "h0_shape":
        h0 = _t(2, 65)
    elif bad == "noncontig":
        a = _t(2, 64, 5).transpose(1, 2)
    elif bad == "rows":
        a = b = torch.zeros((65_536, 1, 1))
        h0 = None
    with pytest.raises(ValueError):
        TS.check_linear_scan_contract(a, b, h0)


def test_new_wrappers_raise_on_a_device_without_a_kernel():
    q = torch.zeros((1, 2, 4, 64), device="meta")
    kp = torch.zeros((3, 16, 2, 64), device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TP.paged_attention_grouped(q, kp, kp, torch.zeros((1, 2), **i32),
                                   torch.zeros((1,), **i32))
    a = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        TS.linear_scan(a, a)
