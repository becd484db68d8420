"""The split-KV decodes, the fused matmul's paths and the norm's plan, on
the CPU.

The CUDA kernels run only on a GPU (``tests/test_torch_cuda.py``).  What
surrounds them is plain Python that runs here: the plans that pick the
decodes' key splits, the fused matmul's path and K splits and the norm's
launch shape from shapes alone, and the host-side caches of the wrappers.
The split walk's arithmetic, which both decodes share -- 64-key tiles,
one online-softmax update per tile and warp in the exp2 domain, per-split
(m, l, O) and the combine pass, empty splits included -- is written out
below in plain torch and held to the port's plain versions and to JAX's
``repro.kernels.ref.fused_paged_decode_ref`` and ``paged_attention_ref``
on the same numpy inputs, f32 at atol = rtol = 2e-5 (the JAX kernel
tests' bound: another order of summation).  The unfused decode's model
includes its empty slot (length 0: zero query rows over the whole table).
"""
import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_matmul as TM  # noqa: E402
from repro_torch.kernels import layernorm as TL  # noqa: E402
from repro_torch.kernels import paged_attention as TP  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

F32 = dict(atol=2e-5, rtol=2e-5)
NEG_INF = -1e30          # the kernels' -inf (kNegInf)
TILE = 64                # keys a tile (split::kKeys)


# -- plans ------------------------------------------------------------------

# (label, (B, Hkv, page, NB), expected (splits, keys per split)) at 132 SMs
DECODE_PLANS = [
    # the serve: 4 slots x 4 kv heads, a 1,024-key table -> 128 blocks
    ("serve 4 slots", (4, 4, 16, 64), (8, 128)),
    # phase 3's B=8 -> 128 blocks
    ("phase 3 B=8", (8, 4, 16, 64), (4, 256)),
    # one live slot: 16 splits of one tile
    ("one slot", (1, 4, 16, 64), (16, 64)),
    # the hybrid's 8 kv heads at 4 slots
    ("hybrid 4 slots", (4, 8, 16, 64), (4, 256)),
    # enough blocks to fill the card alone: one split over the table
    ("33 slots", (33, 4, 16, 64), (1, 1024)),
    # a 24-row page: the table (1,032 keys) is not whole tiles
    ("ragged pages", (3, 4, 24, 43), (9, 128)),
]


@pytest.mark.parametrize("label,shape,want", DECODE_PLANS,
                         ids=[c[0] for c in DECODE_PLANS])
def test_decode_split_at_serve_phase3_and_ragged_shapes(label, shape, want):
    assert TP.decode_split(*shape) == want


@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 33])
@pytest.mark.parametrize("page,nb", [(16, 1), (16, 64), (24, 43), (7, 5)])
def test_decode_split_covers_the_table_once(b, page, nb):
    """Whole 64-key tiles that cover the NB * P-key table, none starting
    past it, as the C entry point requires."""
    n, per = TP.decode_split(b, 4, page, nb)
    assert per % TILE == 0 and 1 <= n <= 16
    assert (n - 1) * per < nb * page <= n * per


# the unfused decode (jamba's rope-free attention, Hkv = 8): (label,
# (B, page, NB), expected plan) at 132 SMs
PAGED_PLANS = [
    # the serve-hybrid's 4 slots and phase 3's B=4: 32 blocks, 4 splits
    ("serve-hybrid and phase 3", (4, 16, 64), (4, 256)),
    # one live slot: 8 blocks, 16 splits of one tile
    ("one slot", (1, 16, 64), (16, 64)),
    # 17 slots fill the card alone
    ("17 slots", (17, 16, 64), (1, 1024)),
]


@pytest.mark.parametrize("label,shape,want", PAGED_PLANS,
                         ids=[c[0] for c in PAGED_PLANS])
def test_unfused_decode_split_at_serve_hybrid_and_phase3(label, shape, want):
    b, page, nb = shape
    n, per = TP.decode_split(b, 8, page, nb)
    assert (n, per) == want
    assert (n - 1) * per < nb * page <= n * per      # the table, once


# (label, (M, N, K, dtype, aligned), expected (path, splits, split_rows))
MATMUL_PLANS = [
    ("decode gate", (4, 11008, 4096, torch.bfloat16, True),
     ("split_k", 13, 320)),
    ("prefill gate", (512, 11008, 4096, torch.bfloat16, True),
     ("wgmma", 1, 4096)),
    ("prefill 4096 f32", (512, 4096, 4096, torch.float32, True),
     ("fma_tile", 1, 4096)),
    ("decode K=1000", (1, 11008, 1000, torch.bfloat16, True),
     ("split_k", 11, 96)),
    ("M=16 head", (16, 64000, 4096, torch.bfloat16, True),
     ("split_k", 3, 1376)),
    ("M=17", (17, 11008, 4096, torch.bfloat16, True), ("wgmma", 1, 4096)),
    ("ragged K bf16", (37, 11008, 1001, torch.bfloat16, True),
     ("wmma", 1, 1001)),
    ("ragged K decode", (3, 11008, 1001, torch.bfloat16, True),
     ("wmma", 1, 1001)),
    ("ragged N f32", (600, 4100, 4096, torch.float32, True),
     ("fma", 1, 4096)),
    ("misaligned bf16", (4, 11008, 4096, torch.bfloat16, False),
     ("wmma", 1, 4096)),
    ("misaligned f32", (512, 4096, 4096, torch.float32, False),
     ("fma", 1, 4096)),
]


@pytest.mark.parametrize("label,shape,want", MATMUL_PLANS,
                         ids=[c[0] for c in MATMUL_PLANS])
def test_matmul_plan_at_main_path_and_ragged_shapes(label, shape, want):
    m, n, k, dtype, aligned = shape
    assert TM.matmul_plan(m, n, k, dtype, aligned) == want


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n", [8, 256, 4096, 11008, 64000])
@pytest.mark.parametrize("k", [8, 32, 40, 1000, 4096, 16384])
def test_split_k_plan_covers_k_once(m, n, k):
    """Whole 32-row stages, at most 32 splits, none starting past K (the
    C entry point's checks)."""
    path, splits, rows = TM.matmul_plan(m, n, k, torch.bfloat16)
    assert path == "split_k"
    assert rows % TM.SPLIT_K_ROWS == 0 and 1 <= splits <= TM.MAX_K_SPLITS
    assert (splits - 1) * rows < k <= splits * rows


# -- the split-and-combine arithmetic ---------------------------------------

def split_decode_plain(q, k_new, v_new, k_pages, v_pages, block_tables,
                       positions, *, theta, splits, keys_per_split,
                       softcap=0.0, k_scales=None, v_scales=None):
    """The fused decode as the split kernel computes it, in plain torch:
    RoPE and the fresh row's write as the plain version does them, then
    per (slot, kv head) ``splits`` key ranges of ``keys_per_split`` keys,
    each walked in 64-key tiles of which warp w takes keys 8w .. 8w+7:
    one online-softmax update per tile and warp (exp2 domain, m starting
    at -1e30, a key past the range scoring -1e30 and weighing 0), the
    eight warps' (m, l, O) merged at the end of the split, and the
    combine pass over the splits, which skips a split that saw no key."""
    b, hk, g, d = q.shape
    page, nb = k_pages.shape[1], block_tables.shape[1]
    pos_bs = positions[:, None]
    qr = TR.decode_rope_ref(q.reshape(b, 1, hk * g, d), pos_bs,
                            theta).reshape(b, hk, g, d).float()
    kr = TR.decode_rope_ref(k_new[:, None], pos_bs, theta)[:, 0]
    blk = torch.clamp(positions.long() // page, 0, nb - 1)
    pages = torch.gather(block_tables.long(), 1, blk[:, None])[:, 0]
    rows = positions.long() % page
    if k_scales is not None:
        kq, ks = TR.quantize_int8_rows(kr)
        vq, vs = TR.quantize_int8_rows(v_new)
        k_pages[pages, rows], v_pages[pages, rows] = kq, vq
        k_scales[pages, rows], v_scales[pages, rows] = ks, vs
    else:
        k_pages[pages, rows] = kr.to(k_pages.dtype)
        v_pages[pages, rows] = v_new.to(v_pages.dtype)
    t_ends = [min(int(p) + 1, nb * page) for p in positions]
    out = split_walk_plain(qr, k_pages, v_pages, block_tables, t_ends,
                           splits=splits, keys_per_split=keys_per_split,
                           softcap=softcap, k_scales=k_scales,
                           v_scales=v_scales)
    return out.to(q.dtype), k_pages, v_pages, k_scales, v_scales


def split_walk_plain(q, k_pages, v_pages, block_tables, t_ends, *, splits,
                     keys_per_split, softcap=0.0, k_scales=None,
                     v_scales=None):
    """The split walk of both decodes (``decode_split.cuh``) in plain
    torch: per (slot, kv head) ``splits`` key ranges of ``keys_per_split``
    keys, slot b's keys ``t < t_ends[b]`` admissible, each range walked in
    64-key tiles of which warp w takes keys 8w .. 8w+7: one online-softmax
    update per tile and warp (exp2 domain, m starting at -1e30, a key past
    the range scoring -1e30 and weighing 0), the eight warps' (m, l, O)
    merged at the end of the split, and the combine pass over the splits,
    which skips a split that saw no key.  q (B, Hkv, G, D) f32; returns
    f32 (B, Hkv, G, D)."""
    b, hk, g, d = q.shape
    page, nb = k_pages.shape[1], block_tables.shape[1]
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, nb * page, hk, d).float()
    v = v_pages[bt].reshape(b, nb * page, hk, d).float()
    if k_scales is not None:
        k = k * k_scales[bt].reshape(b, nb * page, hk)[..., None]
        v = v * v_scales[bt].reshape(b, nb * page, hk)[..., None]
    # keys padded past the table, so that every warp's 8 keys exist
    pad = splits * keys_per_split - nb * page
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale, log2e = 1.0 / math.sqrt(d), 1.0 / math.log(2.0)
    warps = TILE // 8
    out = torch.empty((b, hk, g, d), dtype=torch.float32)
    for bi in range(b):
        t_end = t_ends[bi]
        for h in range(hk):
            parts = []
            for z in range(splits):
                t0 = z * keys_per_split
                t_hi = min(t0 + keys_per_split, t_end)
                m = torch.full((warps, g), NEG_INF)
                l, o = torch.zeros(warps, g), torch.zeros(warps, g, d)
                for a in range(t0, t_hi, TILE):
                    for w in range(warps):
                        keys = torch.arange(a + 8 * w, a + 8 * w + 8)
                        s = q[bi, h] @ k[bi, keys, h].T * scale
                        if softcap > 0:
                            s = softcap * torch.tanh(s / softcap)
                        s = torch.where(keys < t_hi, s * log2e, NEG_INF)
                        m_new = torch.maximum(m[w], s.max(-1).values)
                        p = torch.where(s == NEG_INF, 0.0,
                                        torch.exp2(s - m_new[:, None]))
                        alpha = torch.exp2(m[w] - m_new)
                        l[w] = l[w] * alpha + p.sum(-1)
                        o[w] = o[w] * alpha[:, None] + p @ v[bi, keys, h]
                        m[w] = m_new
                mz = m.max(0).values                  # merge the warps
                f = torch.exp2(m - mz)
                lz = (f * l).sum(0)
                parts.append((torch.where(lz > 0, mz, NEG_INF), lz,
                              (f[..., None] * o).sum(0)))
            mx = torch.stack([m for m, _, _ in parts]).max(0).values
            lsum, osum = torch.zeros(g), torch.zeros(g, d)
            for m, l, o in parts:
                if bool((m == NEG_INF).all()):
                    continue                     # an empty split
                f = torch.exp2(m - mx)
                lsum = lsum + f * l
                osum = osum + f[:, None] * o
            out[bi, h] = osum / lsum[:, None]
    return out


def paged_split_plain(q, k_pages, v_pages, block_tables, lengths, *, splits,
                      keys_per_split, softcap=0.0, k_scales=None,
                      v_scales=None):
    """The unfused decode as its kernel computes it: the split walk over
    each slot's ``min(lengths[b], NB * P)`` keys, and for a slot with
    ``lengths[b] <= 0`` zero query rows over the whole table (every score
    0, so the uniform mean of V, as the references give)."""
    nb, page = block_tables.shape[1], k_pages.shape[1]
    empty = lengths <= 0
    qz = torch.where(empty[:, None, None, None], 0.0, q.float())
    t_ends = [nb * page if int(n) <= 0 else min(int(n), nb * page)
              for n in lengths]
    return split_walk_plain(qz, k_pages, v_pages, block_tables, t_ends,
                            splits=splits, keys_per_split=keys_per_split,
                            softcap=softcap, k_scales=k_scales,
                            v_scales=v_scales).to(q.dtype)


def _decode_inputs(seed, *, b, hk, g, d, page, nb, int8):
    """numpy inputs: q, k_new, v_new, pools (+ scales), disjoint tables."""
    r = np.random.default_rng(seed)
    n = b * nb + 1
    ins = dict(q=r.standard_normal((b, hk, g, d)),
               kn=r.standard_normal((b, hk, d)),
               vn=r.standard_normal((b, hk, d)),
               kp=r.standard_normal((n, page, hk, d)),
               vp=r.standard_normal((n, page, hk, d)),
               bt=r.permutation(b * nb).reshape(b, nb).astype(np.int32))
    ins = {k: (v.astype(np.float32) if k != "bt" else v)
           for k, v in ins.items()}
    if int8:
        for name in ("kp", "vp"):
            q8, sc = TR.quantize_int8_rows(torch.from_numpy(ins[name]))
            ins[name], ins[name[0] + "s"] = q8.numpy(), sc.numpy()
    return ins


# (positions, NB, page): a slot at 0, one at 3 (7 of 8 splits empty) and
# one at the table's last row; the same at a 24-row page (tiles straddle
# pages and the table is not whole tiles)
SPLIT_CASES = {
    "page16": ([0, 3, 511], 32, 16),
    "page24": ([0, 3, 24 * 22 - 1], 22, 24),
}


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_and_combine_match_plain_and_jax(case, d, int8, softcap):
    positions, nb, page = SPLIT_CASES[case]
    b, hk, g = 3, 2, 4
    ins = _decode_inputs(7 + d + nb, b=b, hk=hk, g=g, d=d, page=page, nb=nb,
                         int8=int8)
    splits, per = TP.decode_split(b, hk, page, nb)
    assert splits == 8 if case == "page16" else splits > 1
    pos = np.asarray(positions, np.int32)

    def torch_args():
        t = {k: tensor_from_numpy(v, "cpu") for k, v in ins.items()}
        sc = dict(k_scales=t["ks"], v_scales=t["vs"]) if int8 else {}
        return (t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["bt"],
                torch.from_numpy(pos)), sc

    args, sc = torch_args()
    got = split_decode_plain(*args, theta=5e6, splits=splits,
                             keys_per_split=per, softcap=softcap, **sc)
    args, sc = torch_args()
    plain = TR.fused_paged_decode_ref(*args, theta=5e6, softcap=softcap,
                                      **sc)
    jsc = dict(k_scales=jnp.asarray(ins["ks"]),
               v_scales=jnp.asarray(ins["vs"])) if int8 else {}
    jax_out = JR.fused_paged_decode_ref(
        *(jnp.asarray(ins[k]) for k in ("q", "kn", "vn", "kp", "vp", "bt")),
        jnp.asarray(pos), theta=5e6, softcap=softcap, **jsc)
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(), **F32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_out[0]), **F32)
    for a, p in zip(got[1:], plain[1:]):         # the written pools
        assert a is None or torch.equal(a, p)


# (lengths, NB, page): an empty slot, one of 3 keys (3 of 4 splits
# empty), one past the table; the same at a 24-row page
PAGED_SPLIT_CASES = {
    "page16": ([0, 3, 32 * 16 + 9], 32, 16),
    "page24": ([0, 3, 24 * 22 - 1], 22, 24),
}


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(PAGED_SPLIT_CASES))
def test_unfused_split_and_combine_match_plain_and_jax(case, d, int8,
                                                       softcap):
    lengths, nb, page = PAGED_SPLIT_CASES[case]
    b, hk, g = 3, 8, 4
    ins = _decode_inputs(11 + d + nb, b=b, hk=hk, g=g, d=d, page=page,
                         nb=nb, int8=int8)
    splits, per = TP.decode_split(b, hk, page, nb)
    assert splits > 1
    n = np.asarray(lengths, np.int32)
    t = {k: tensor_from_numpy(v, "cpu") for k, v in ins.items()}
    sc = dict(k_scales=t["ks"], v_scales=t["vs"]) if int8 else {}
    args = (t["q"], t["kp"], t["vp"], t["bt"], torch.from_numpy(n))
    got = paged_split_plain(*args, splits=splits, keys_per_split=per,
                            softcap=softcap, **sc)
    plain = TR.paged_attention_ref(*args, softcap=softcap, **sc)
    jsc = dict(k_scales=jnp.asarray(ins["ks"]),
               v_scales=jnp.asarray(ins["vs"])) if int8 else {}
    jax_out = JR.paged_attention_ref(
        *(jnp.asarray(ins[k]) for k in ("q", "kp", "vp", "bt")),
        jnp.asarray(n), softcap=softcap, **jsc)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **F32)
    # the empty slot: the uniform mean of V over its table rows
    v = t["vp"][t["bt"][0].long()].float()
    if int8:
        v = v * t["vs"][t["bt"][0].long()][..., None]
    mean = v.reshape(nb * page, hk, d).mean(0)
    np.testing.assert_allclose(got[0].numpy(),
                               mean[:, None].expand(hk, g, d).numpy(), **F32)


def test_one_split_walks_the_whole_table():
    """With one split the walk is the plain online softmax over every
    tile: the same output."""
    ins = _decode_inputs(3, b=2, hk=2, g=8, d=64, page=16, nb=9, int8=False)
    t = {k: tensor_from_numpy(v, "cpu") for k, v in ins.items()}
    pos = torch.tensor([100, 143], dtype=torch.int32)
    got = split_decode_plain(t["q"], t["kn"], t["vn"], t["kp"].clone(),
                             t["vp"].clone(), t["bt"], pos, theta=1e4,
                             splits=1, keys_per_split=192)
    ref = TR.fused_paged_decode_ref(t["q"], t["kn"], t["vn"], t["kp"].clone(),
                                    t["vp"].clone(), t["bt"], pos, theta=1e4)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **F32)


# -- the wrappers' host work ------------------------------------------------

def test_rope_table_is_built_once_per_d_theta_device():
    a = TP._rope_table(128, 5e6, torch.device("cpu"))
    assert TP._rope_table(128, 5e6, torch.device("cpu")) is a
    assert TP._rope_table(64, 5e6, torch.device("cpu")) is not a
    assert torch.equal(a, TR.rope_inv_freq(128, 5e6, "cpu"))


def test_sm_count_asks_the_driver_once_per_device(monkeypatch):
    calls = []

    class Props:
        multi_processor_count = 132

    def props(idx):
        calls.append(idx)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(_build, "_sms", {})
    for _ in range(3):
        assert _build.sm_count("cuda:0") == 132
    assert _build.sm_count(torch.device("cuda", 1)) == 132
    assert calls == [0, 1]


def test_fused_decode_contract_raises_on_misaligned_pools():
    """The split walk copies pool rows with 16-byte cp.async."""
    b, hk, g, d, page, nb = 1, 2, 4, 64, 16, 4
    q = torch.zeros((b, hk, g, d))
    kn = torch.zeros((b, hk, d))
    kp = torch.zeros((5, page, hk, d))
    bad = torch.zeros(5 * page * hk * d + 1)[1:].view(5, page, hk, d)
    bt = torch.zeros((b, nb), dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int32)
    assert TP.check_fused_decode_contract(q, kn, kn, kp, kp, bt, pos) == \
        (b, hk, g, d, page, nb)
    for pools in ((bad, kp), (kp, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            TP.check_fused_decode_contract(q, kn, kn, *pools, bt, pos)


def test_paged_decode_contract_raises_on_misaligned_pools():
    """The unfused decode now copies pool rows with the split walk's
    16-byte cp.async too."""
    b, hk, g, d, page, nb = 2, 8, 8, 128, 16, 4
    q = torch.zeros((b, hk, g, d))
    kp = torch.zeros((9, page, hk, d))
    bad = torch.zeros(9 * page * hk * d + 1)[1:].view(9, page, hk, d)
    bt = torch.zeros((b, nb), dtype=torch.int32)
    n = torch.zeros((b,), dtype=torch.int32)
    assert TP.check_paged_decode_contract(q, kp, kp, bt, n) == \
        (b, hk, g, d, page, nb)
    for pools in ((bad, kp), (kp, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            TP.check_paged_decode_contract(q, *pools, bt, n)
    k8 = torch.zeros((9, page, hk, d), dtype=torch.int8)
    bad8 = torch.zeros(9 * page * hk * d + 1, dtype=torch.int8)[1:].view(
        9, page, hk, d)
    sc = torch.ones((9, page, hk))
    with pytest.raises(ValueError, match="16-byte"):
        TP.check_paged_decode_contract(q, bad8, k8, bt, n, sc, sc)


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry point's parameter count equals its ctypes argtypes
    (ctypes passes extra arguments unconverted, so a missing entry would
    cut the stream pointer to 32 bits instead of raising)."""
    import re
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    found = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        found[name] = len(params.split(","))
    assert set(found) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert found[name] == len(argtypes), name


@pytest.mark.parametrize("name,params", [
    ("repro_paged_attention", ("ws_o", "ws_ml", "nsplit", "split_keys")),
    ("repro_norm_onepass", ("nv", "tpr", "rpb", "blocks")),
])
def test_entry_points_take_their_plans(name, params):
    """The unfused decode's entry point takes the split workspace and
    plan, the norm's its launch plan, each as the ctypes argtypes say."""
    import re
    src = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    found = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', src)
    names = [p.split()[-1].lstrip("*") for p in found.group(1).split(",")]
    assert all(p in names for p in params)
    assert len(names) == len(_build.SIGNATURES[name])
    types = dict(zip(names, _build.SIGNATURES[name]))
    assert all(types[p] is (ctypes.c_void_p if p.startswith("ws")
                            else ctypes.c_int) for p in params)


# -- the one-pass norm's plan -----------------------------------------------

# (label, (R, D, dtype, aligned), expected plan) at 132 SMs: the front
# door's rows, a narrow D, the widest, and the shapes the scalar path takes
NORM_PLANS = [
    ("bf16 R=512 D=4096", (512, 4096, torch.bfloat16, True),
     ("vector", 2, 256, 1, 512)),
    ("bf16 R=4 D=8192", (4, 8192, torch.bfloat16, True),
     ("vector", 2, 512, 1, 4)),
    ("f32 R=512 D=8192", (512, 8192, torch.float32, True),
     ("vector", 4, 512, 1, 512)),
    ("f32 R=512 D=4096", (512, 4096, torch.float32, True),
     ("vector", 4, 256, 1, 512)),
    ("bf16 D=1024", (512, 1024, torch.bfloat16, True),
     ("vector", 2, 64, 4, 128)),
    ("bf16 D=32768", (513, 32768, torch.bfloat16, True),
     ("vector", 4, 1024, 1, 264)),
    ("f32 D=32768", (4, 32768, torch.float32, True),
     ("vector", 8, 1024, 1, 4)),
    ("odd D", (512, 4095, torch.bfloat16, True), ("scalar", 0, 256, 1, 512)),
    ("f32 D=4098", (4, 4098, torch.float32, True), ("scalar", 0, 256, 1, 4)),
    ("misaligned", (512, 4096, torch.bfloat16, False),
     ("scalar", 0, 256, 1, 512)),
]


@pytest.mark.parametrize("label,shape,want", NORM_PLANS,
                         ids=[c[0] for c in NORM_PLANS])
def test_norm_plan_at_front_door_and_odd_shapes(label, shape, want):
    assert TL.norm_plan(*shape) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r", [1, 4, 512, 513, 100_000])
@pytest.mark.parametrize("d", [8, 64, 1000, 4096, 8192, 12_288, 32_768])
def test_norm_plan_vector_path_covers_each_row_once(dtype, r, d):
    """The C entry point's checks: whole 16-byte vectors, 16 values a
    thread or 32 for the widest rows, threads a multiple of 32 that cover
    the row, a
    block of at most 256 threads unless one row needs more (then one row
    a block), at most 8 rows a block, and at least one block a row
    group, at most a full card's worth."""
    path, nv, tpr, rpb, blocks = TL.norm_plan(r, d, dtype)
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    assert path == "vector" and nv * vec in ((16, 32) if d > 16_384
                                             else (16,))
    assert tpr % 32 == 0 and 32 <= tpr <= 1024
    assert nv * vec * (tpr - 32) < d <= nv * vec * tpr
    assert 1 <= rpb <= 8 and (tpr * rpb <= 256 or rpb == 1)
    assert 1 <= blocks <= -(-r // rpb)
    assert blocks == -(-r // rpb) or blocks * tpr * rpb >= 132 * 2048 // 2
