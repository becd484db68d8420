"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: without a CUDA device every test here skips (the check
runs inside the ``cuda_device`` fixture, never at import).  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 at 2e-5 (order of summation); bf16 at 2e-2 (one bf16
ulp is 2^-8 relative: the paged prefill and verify kernels round the
softmax probabilities to bf16 for the tensor cores' P V product, and the
paged plain versions round them to the activation dtype).  bf16 flash
keeps P in f32 (as bf16 hi + lo): it must lie within one bf16 ulp of
its plain version everywhere (the ulp at no less than 2^-8 of the row's
largest output), with a mean error against an f64 evaluation at most
1.1 times the plain version's.
The int8 rows and scales the fused decode writes must equal the plain
version's, and the linear scan's states must equal the plain version's
bit for bit on both its paths (both round the product and the sum
separately in f32).  The fused selective scan is held at 1e-5: it rounds
as its plain version does, but its expf and its order of the C sum may
differ.  The
fused matmul and the one-pass norm are held at the JAX kernel tests'
tolerances, by output dtype: matmul 1e-4 (f32) / 2e-2 (bf16, one bf16
ulp is at most 2^-7 relative), norm 1e-5 / 3e-2.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import paged_attention as TP  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

pytestmark = pytest.mark.cuda
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    tol = TOLS[dtype]
    torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 60, 64, 128, 256])
def test_flash_kernel_matches_plain(cuda_device, dtype, d):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    b, h, hk, sq, skv = 2, 8, 2, 100, 130
    q = torch.randn((b, h, sq, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((b, hk, skv, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((b, hk, skv, d), generator=g, device=cuda_device).to(dtype)
    qp = torch.arange(sq, device=cuda_device, dtype=torch.int32) + 30
    kp = torch.arange(skv, device=cuda_device, dtype=torch.int32)
    kv = (kp % 5 != 2).to(torch.int32)
    for kw in (dict(causal=True), dict(causal=True, window=40, softcap=20.0)):
        out = TF.flash_attention_bhsd(q, k, v, qp, kp, kv, **kw)
        _close(out, TR.flash_attention_ref(q, k, v, qp, kp, kv, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_match_plain(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, hk, grp, d, page, nb = 3, 2, 8, 128, 16, 6
    n = b * nb + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
        b, nb).to(torch.int32)
    kp, vp = rnd(n, page, hk, d), rnd(n, page, hk, d)
    pos = torch.tensor([0, 37, 95], dtype=torch.int32, device=cuda_device)
    q, kn, vn = rnd(b, hk, grp, d), rnd(b, hk, d), rnd(b, hk, d)
    out, kp1, vp1, _, _ = TP.fused_paged_decode_grouped(
        q, kn, vn, kp.clone(), vp.clone(), bt, pos, theta=5e6)
    ro, kp2, vp2, _, _ = TR.fused_paged_decode_ref(
        q, kn, vn, kp.clone(), vp.clone(), bt, pos, theta=5e6)
    torch.cuda.synchronize()
    _close(out, ro, dtype)
    _close(kp1, kp2, dtype)
    _close(vp1, vp2, dtype)
    qs = rnd(b, hk, grp, 20, d)
    for offset in (0, 50):
        out = TP.paged_prefill_attention_grouped(qs, kp, vp, bt, offset)
        ref = TR.paged_prefill_attention_ref(qs, kp, vp, bt, offset)
        _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_paged_kernels_match_plain(cuda_device, dtype):
    """The fused decode's int8 mode (rows and scales bit-equal), and the
    paged prefill kernel over int8 pools with one offset and with
    per-slot offsets (the verify window)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, hk, grp, d, page, nb = 3, 2, 8, 128, 16, 6
    n = b * nb + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
        b, nb).to(torch.int32)
    kp, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
    vp, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
    pos = torch.tensor([0, 37, 95], dtype=torch.int32, device=cuda_device)
    q, kn, vn = (rnd(b, hk, grp, d).to(dtype), rnd(b, hk, d).to(dtype),
                 rnd(b, hk, d).to(dtype))
    got = TP.fused_paged_decode_grouped(
        q, kn, vn, kp.clone(), vp.clone(), bt, pos, theta=5e6,
        k_scales=ks.clone(), v_scales=vs.clone())
    ref = TR.fused_paged_decode_ref(
        q, kn, vn, kp.clone(), vp.clone(), bt, pos, theta=5e6,
        k_scales=ks.clone(), v_scales=vs.clone())
    torch.cuda.synchronize()
    _close(got[0], ref[0], dtype)
    for a, r in zip(got[1:], ref[1:]):
        assert torch.equal(a, r)
    sc = dict(k_scales=ks, v_scales=vs)
    qs = rnd(b, hk, grp, 20, d).to(dtype)
    out = TP.paged_prefill_attention_grouped(qs, kp, vp, bt, 50, **sc)
    _close(out, TR.paged_prefill_attention_ref(qs, kp, vp, bt, 50, **sc),
           dtype)
    qv = rnd(b, hk, grp, 5, d).to(dtype)
    offs = torch.tensor([3, 47, 90], dtype=torch.int32, device=cuda_device)
    for kw in ({}, sc):
        pools = (kp, vp) if kw else (TR.dequantize_int8(kp, ks).to(dtype),
                                     TR.dequantize_int8(vp, vs).to(dtype))
        out = TP.paged_verify_attention_grouped(qv, *pools, bt, offs, **kw)
        _close(out, TR.paged_verify_attention_ref(qv, *pools, bt, offs,
                                                  **kw), dtype)


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("page", [16, 24])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_windows_that_split_match_plain(cuda_device, dtype, d, page,
                                              pool):
    """Verify windows at per-slot offsets up to 1000 with B*Hkv = 16 (the
    bf16 launch splits the keys), ragged key counts (not multiples of the
    64-key tile), a page size that does not divide 64, softcap; then one
    offset deep in the table for a prefill whose bf16 launch splits."""
    g = torch.Generator(device=cuda_device).manual_seed(d + page)
    b, hk, grp, s = 4, 4, 8, 5
    nb = -(-1010 // page)
    n = b * nb + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
        b, nb).to(torch.int32)
    kq, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
    vq, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
    if pool == "int8":
        pools, sc = (kq, vq), dict(k_scales=ks, v_scales=vs)
    else:
        pools, sc = (TR.dequantize_int8(kq, ks).to(dtype),
                     TR.dequantize_int8(vq, vs).to(dtype)), {}
    offs = torch.tensor([0, 77, 640, 1000], dtype=torch.int32,
                        device=cuda_device)
    assert TP.prefill_split(b, hk, grp, s, page, nb)[0] > 1
    q = rnd(b, hk, grp, s, d).to(dtype)
    for softcap in (0.0, 30.0):
        out = TP.paged_verify_attention_grouped(q, *pools, bt, offs,
                                                softcap=softcap, **sc)
        ref = TR.paged_verify_attention_ref(q, *pools, bt, offs,
                                            softcap=softcap, **sc)
        torch.cuda.synchronize()
        _close(out, ref, dtype)
    qs = rnd(1, hk, grp, 20, d).to(dtype)
    assert TP.prefill_split(1, hk, grp, 20, page, nb, 950)[0] > 1
    out = TP.paged_prefill_attention_grouped(qs, *pools, bt[:1], 950,
                                             softcap=30.0, **sc)
    ref = TR.paged_prefill_attention_ref(qs, *pools, bt[:1], 950,
                                         softcap=30.0, **sc)
    torch.cuda.synchronize()
    _close(out, ref, dtype)


@pytest.mark.parametrize("d", [40, 60, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_splits_and_fully_masked_rows(cuda_device, dtype, d):
    """Few query tiles over 1000 keys (the bf16 launch splits them), keys
    invalid in holes, and a run of 21 invalid keys that empties the
    16-key window of the queries at 955-960: those rows are 0."""
    g = torch.Generator(device=cuda_device).manual_seed(7 * d)
    b, h, hk, sq, skv = 1, 4, 2, 70, 1000
    q = torch.randn((b, h, sq, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((b, hk, skv, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((b, hk, skv, d), generator=g, device=cuda_device).to(dtype)
    qp = torch.arange(sq, device=cuda_device, dtype=torch.int32) + 900
    kp = torch.arange(skv, device=cuda_device, dtype=torch.int32)
    kv = ((kp % 7 != 3) & ((kp < 940) | (kp > 960))).to(torch.int32)
    assert TF.flash_split(b, h, sq, skv)[0] > 1
    empty = (qp >= 955) & (qp <= 960)
    for kw in (dict(causal=True), dict(causal=False, softcap=20.0),
               dict(causal=True, window=16, softcap=20.0)):
        out = TF.flash_attention_bhsd(q, k, v, qp, kp, kv, **kw)
        ref = TR.flash_attention_ref(q, k, v, qp, kp, kv, **kw)
        torch.cuda.synchronize()
        _close(out, ref, dtype)
        if kw.get("window"):
            assert not out[:, :, empty].any()


# (name, B, H, Sq, Skv, causal, keys valid): the encoders' shapes, H = Hkv
ENCODER_CASES = {
    # a ViT layer: 197 positions, every key valid
    "vit": (3, 4, 197, 197, False, "all"),
    # whisper's cross decode: one query against 1500 cached frames (split)
    "cross_decode": (4, 8, 1, 1500, False, "all"),
    # whisper's dense self-decode: one query at position 20 against a
    # 448-row cache, rows past 20 invalid
    "self_decode": (4, 8, 1, 448, True, "prefix"),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
@pytest.mark.parametrize("d", [40, 60])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_encoder_shapes_at_head_dims_40_and_60(cuda_device, dtype, d,
                                                     case):
    """DeiT-160's and LV-ViT-T's head dims at the encoders' shapes,
    queries at std 4 (outputs of order 1, not the tolerance's size): the
    bf16 tile pads 40 to 48 and 60 to 64 columns, and D=60's bf16 rows
    of 120 bytes start 8 bytes off a 16-byte boundary every other row."""
    b, h, sq, skv, causal, valid = ENCODER_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(d + sq)
    q = (4 * torch.randn((b, h, sq, d), generator=g,
                         device=cuda_device)).to(dtype)
    k = torch.randn((b, h, skv, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((b, h, skv, d), generator=g, device=cuda_device).to(dtype)
    qp = torch.arange(sq, device=cuda_device, dtype=torch.int32)
    if sq == 1:
        qp = qp + 20
    kp = torch.arange(skv, device=cuda_device, dtype=torch.int32)
    kv = torch.ones((skv,), dtype=torch.int32, device=cuda_device)
    if valid == "prefix":
        kv = (kp <= 20).to(torch.int32)
    if dtype == torch.bfloat16 and sq == 1 and skv == 1500:
        assert TF.flash_split(b, h, sq, skv)[0] > 1
    out = TF.flash_attention_bhsd(q, k, v, qp, kp, kv, causal=causal)
    ref = TR.flash_attention_ref(q, k, v, qp, kp, kv, causal=causal)
    torch.cuda.synchronize()
    _close(out, ref, dtype)
    assert float(ref.abs().max()) > 0.5


@pytest.mark.parametrize("d", [32, 48, 72, 96])
def test_flash_kernel_raises_outside_its_head_dims(cuda_device, d):
    z = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16, device=cuda_device)
    pos = torch.zeros((8,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        TF.flash_attention_bhsd(z, z, z, pos, pos, pos)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (x in f32)."""
    a = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("d", [40, 60, 64, 128, 256])
def test_flash_bf16_keeps_p_in_f32(cuda_device, d):
    """Phase 3's flash shape in bf16: the kernel within one bf16 ulp of
    the plain version (which keeps P in f32, as JAX's kernel and ref do)
    at every element, and no further from an f64 evaluation of the same
    function on average than 1.1 times the plain version (whose only
    error is its final rounding to bf16).  The ulp is taken at the
    element's magnitude, but at no less than 2^-8 of its row's largest:
    below that, an output is a near-cancelling sum of 512 products, the
    two f32 sums' rounding exceeds the bf16 ulp, and the plain version is
    itself up to 58 ulps from the correctly rounded f64 value (NVIDIA
    H100, PERF.md)."""
    import math
    g = torch.Generator(device=cuda_device).manual_seed(11 + d)
    b, h, hk, s = 1, 32, 4, 512
    bf = torch.bfloat16
    q = torch.randn((b, h, s, d), generator=g, device=cuda_device).to(bf)
    k = torch.randn((b, hk, s, d), generator=g, device=cuda_device).to(bf)
    v = torch.randn((b, hk, s, d), generator=g, device=cuda_device).to(bf)
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)
    ones = torch.ones((s,), dtype=torch.int32, device=cuda_device)
    out = TF.flash_attention_bhsd(q, k, v, pos, pos, ones).float()
    plain = TR.flash_attention_ref(q, k, v, pos, pos, ones).float()
    kr = k.double().repeat_interleave(h // hk, 1)
    vr = v.double().repeat_interleave(h // hk, 1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) / math.sqrt(d)
    sc = sc.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1), vr)
    floor = plain.abs().amax(-1, keepdim=True) * 2.0 ** -8
    ulp = _bf16_ulp(torch.maximum(torch.maximum(out.abs(), plain.abs()),
                                  floor))
    assert float(((out - plain).abs() / ulp).max()) <= 1.0
    err = (out.double() - ref).abs().mean()
    plain_err = (plain.double() - ref).abs().mean()
    assert err <= 1.1 * plain_err


# (name, B, positions, NB): the serve's 4 slots, phase 3's B=8, and one
# live slot whose 16 splits are all empty but the first
DECODE_SPLIT_CASES = {
    "serve": (4, [100, 371, 640, 700], 64),
    "phase3": (8, [999, 15, 16, 511, 256, 3, 640, 1000], 64),
    "one_slot": (1, [37], 64),
    "ragged": (3, [0, 3, 24 * 43 - 1], 43),
}


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_SPLIT_CASES))
def test_fused_decode_splits_match_plain(cuda_device, case, dtype, d, pool):
    """The split-KV fused decode (every case splits its keys) against its
    plain version, with and without softcap; the written rows, and on
    int8 pools their scales, bit-equal.  "ragged" has a 24-row page (a
    tile straddles pages), a slot at 0, one at 3 (all but the first split
    empty) and one at the table's last row."""
    b, positions, nb = DECODE_SPLIT_CASES[case]
    hk, grp = 4, 8
    page = 24 if case == "ragged" else 16
    g = torch.Generator(device=cuda_device).manual_seed(d + nb + b)
    n = b * nb + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    assert TP.decode_split(b, hk, page, nb)[0] > 1
    bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
        b, nb).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    q, kn, vn = (rnd(b, hk, grp, d).to(dtype), rnd(b, hk, d).to(dtype),
                 rnd(b, hk, d).to(dtype))
    if pool == "int8":
        kq, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
        vq, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
        pools = [kq, vq, ks, vs]
    else:
        pools = [rnd(n, page, hk, d).to(dtype), rnd(n, page, hk, d).to(dtype),
                 None, None]
    mine = [None if t is None else t.clone() for t in pools]
    plain = [None if t is None else t.clone() for t in pools]
    for softcap in (0.0, 30.0):
        out = TP.fused_paged_decode_grouped(
            q, kn, vn, mine[0], mine[1], bt, pos, theta=5e6,
            softcap=softcap, k_scales=mine[2], v_scales=mine[3])[0]
        ref = TR.fused_paged_decode_ref(
            q, kn, vn, plain[0], plain[1], bt, pos, theta=5e6,
            softcap=softcap, k_scales=plain[2], v_scales=plain[3])[0]
        torch.cuda.synchronize()
        assert TP.fused_paged_decode_grouped.last_split == TP.decode_split(
            b, hk, page, nb, torch.cuda.get_device_properties(
                cuda_device).multi_processor_count)
        _close(out, ref, dtype)
    for a, r in zip(mine, plain):
        assert a is None or torch.equal(a, r)


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grp", range(1, 9))
def test_fused_decode_every_group_matches_plain(cuda_device, grp, dtype, d,
                                                pool):
    """The fused decode at every G from 1 to 8 (the split walk pads 3 to 4
    and 5-7 to 8 rows) against its plain version at the serve's split
    case, the written rows (and int8 scales) bit-equal; G = 9 raises."""
    b, positions, nb = DECODE_SPLIT_CASES["serve"]
    hk, page = 2, 16
    g = torch.Generator(device=cuda_device).manual_seed(grp * 10 + d)
    n = b * nb + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
        b, nb).to(torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    q, kn, vn = (rnd(b, hk, grp, d).to(dtype), rnd(b, hk, d).to(dtype),
                 rnd(b, hk, d).to(dtype))
    if pool == "int8":
        kq, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
        vq, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
        pools = [kq, vq, ks, vs]
    else:
        pools = [rnd(n, page, hk, d).to(dtype), rnd(n, page, hk, d).to(dtype),
                 None, None]
    mine = [None if t is None else t.clone() for t in pools]
    plain = [None if t is None else t.clone() for t in pools]
    out = TP.fused_paged_decode_grouped(
        q, kn, vn, mine[0], mine[1], bt, pos, theta=1e4, k_scales=mine[2],
        v_scales=mine[3])[0]
    ref = TR.fused_paged_decode_ref(
        q, kn, vn, plain[0], plain[1], bt, pos, theta=1e4,
        k_scales=plain[2], v_scales=plain[3])[0]
    torch.cuda.synchronize()
    _close(out, ref, dtype)
    for a, r in zip(mine, plain):
        assert a is None or torch.equal(a, r)
    if grp == 8:
        with pytest.raises(ValueError):
            TP.fused_paged_decode_grouped(
                rnd(b, hk, 9, d).to(dtype), kn, vn, mine[0], mine[1], bt,
                pos, theta=1e4, k_scales=mine[2], v_scales=mine[3])
        with pytest.raises(ValueError):
            TP.paged_attention_grouped(
                rnd(b, hk, 9, d).to(dtype), mine[0], mine[1], bt, pos + 1,
                k_scales=mine[2], v_scales=mine[3])


def test_attention_wrappers_raise_on_misaligned_operands(cuda_device):
    """The cp.async copies need 16-byte aligned q, K/V and pools: a
    contiguous view that starts 2 bytes in raises before any launch."""
    bf = dict(dtype=torch.bfloat16, device=cuda_device)

    def shifted(*shape):
        return torch.zeros(int(torch.tensor(shape).prod()) + 1,
                           **bf)[1:].view(shape)

    pos = torch.zeros((8,), dtype=torch.int32, device=cuda_device)
    k = torch.zeros((1, 2, 8, 64), **bf)
    with pytest.raises(ValueError):
        TF.flash_attention_bhsd(shifted(1, 4, 8, 64), k, k, pos, pos, pos)
    with pytest.raises(ValueError):
        TF.flash_attention_bhsd(torch.zeros((1, 4, 8, 64), **bf),
                                shifted(1, 2, 8, 64), k, pos, pos, pos)
    kp = torch.zeros((5, 16, 2, 64), **bf)
    bt = torch.zeros((1, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        TP.paged_prefill_attention_grouped(shifted(1, 2, 4, 8, 64), kp, kp,
                                           bt, 0)
    with pytest.raises(ValueError):
        TP.paged_verify_attention_grouped(
            torch.zeros((1, 2, 4, 8, 64), **bf), kp, shifted(5, 16, 2, 64),
            bt, pos[:1])
    with pytest.raises(ValueError):       # the fused decode's pools
        TP.fused_paged_decode_grouped(
            torch.zeros((1, 2, 4, 64), **bf), torch.zeros((1, 2, 64), **bf),
            torch.zeros((1, 2, 64), **bf), shifted(5, 16, 2, 64), kp, bt,
            pos[:1], theta=1e4)
    with pytest.raises(ValueError):       # the unfused decode's pools
        TP.paged_attention_grouped(torch.zeros((1, 2, 4, 64), **bf), kp,
                                   shifted(5, 16, 2, 64), bt, pos[:1])


# (B, Hkv, NB) at page 16: 16, 10, 4, 2 and 1 key splits on 132 SMs
PAGED_SHAPES = [(1, 2, 64), (5, 2, 40), (4, 8, 64), (3, 2, 6), (17, 8, 8)]


@pytest.mark.parametrize("grp", range(1, 9))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, d, grp):
    """The unfused paged decode on the split walk over fp and int8 pools,
    with and without softcap, at plans of 1 to 16 key splits (the plan
    recorded); lengths 0 (the uniform mean of V over the table, as the
    Pallas kernel and both references give), 1, a page end, mid-page and
    past the table."""
    from repro_torch.kernels import _build
    page = 16
    for b, hk, nb in PAGED_SHAPES:
        g = torch.Generator(device=cuda_device).manual_seed(
            b * 100 + nb + d + grp)
        n = b * nb + 1

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=cuda_device)

        bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
            b, nb).to(torch.int32)
        want = [0, 1, nb * page + 7, 16, 37][:b]
        want += [int(x) for x in torch.randint(
            0, nb * page + 1, (b - len(want),), generator=g,
            device=cuda_device)]
        lengths = torch.tensor(want, dtype=torch.int32, device=cuda_device)
        q = rnd(b, hk, grp, d).to(dtype)
        kq, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
        vq, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
        fp = (TR.dequantize_int8(kq, ks).to(dtype),
              TR.dequantize_int8(vq, vs).to(dtype))
        plan = TP.decode_split(b, hk, page, nb,
                               _build.sm_count(cuda_device))
        for pools, sc in ((fp, {}),
                          ((kq, vq), dict(k_scales=ks, v_scales=vs))):
            for softcap in (0.0, 30.0):
                out = TP.paged_attention_grouped(q, *pools, bt, lengths,
                                                 softcap=softcap, **sc)
                ref = TR.paged_attention_ref(q, *pools, bt, lengths,
                                             softcap=softcap, **sc)
                torch.cuda.synchronize()
                assert TP.paged_attention_grouped.last_split == plan
                _close(out, ref, dtype)
                v = TR.dequantize_int8(vq, vs) if sc else pools[1].float()
                mean = v[bt[0].long()].reshape(nb * page, hk, d).mean(0)
                _close(out[0], mean[:, None].expand(hk, grp, d), dtype)


@pytest.mark.parametrize("n,s", [(4, 1), (1, 512), (3, 37)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_kernel_equals_plain(cuda_device, n, s, with_h0):
    """Bit-equal to the plain version in f32: mamba's decode (S = 1) and
    prefill shapes at jamba's F = 262,144, and a ragged F."""
    from repro_torch.kernels import linear_scan as TS
    g = torch.Generator(device=cuda_device).manual_seed(n * 1000 + s)
    f = 262_144 if s != 37 else 1000
    a = torch.rand((n, s, f), generator=g, device=cuda_device) * 0.5 + 0.5
    b = torch.randn((n, s, f), generator=g, device=cuda_device)
    h0 = torch.randn((n, f), generator=g, device=cuda_device) \
        if with_h0 else None
    out = TS.linear_scan(a, b, h0)
    ref = TR.linear_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert TS.linear_scan.last_plan[0] == "vector"


@pytest.mark.parametrize("case", ["odd_f", "misaligned"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_scalar_path_equals_plain(cuda_device, case, with_h0):
    """An odd F (262,143) and operands one float past a 16-byte boundary
    take the scalar path, bit-equal to the plain version too."""
    from repro_torch.kernels import linear_scan as TS
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n, s = 4, 3
    f = 262_143 if case == "odd_f" else 4096

    def place(t):
        """The same values, one float past a 16-byte boundary when the
        case asks for it."""
        if case != "misaligned":
            return t
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        return buf[1:].view(t.shape).copy_(t)

    a = place(torch.rand((n, s, f), generator=g, device=cuda_device) * 0.5
              + 0.5)
    b = place(torch.randn((n, s, f), generator=g, device=cuda_device))
    h0 = place(torch.randn((n, f), generator=g, device=cuda_device)) \
        if with_h0 else None
    out = TS.linear_scan(a, b, h0)
    ref = TR.linear_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert TS.linear_scan.last_plan[0] == "scalar"
    assert torch.equal(out, ref)


# (N, S, D, d_state): serve-hybrid's longest admission, the batched one
# with h0, a ragged D (scalar copies), S = 1, padded states, D past one
# block
SCAN_SHAPES = [(1, 600, 16_384, 16), (4, 100, 16_384, 16), (4, 7, 1001, 16),
               (2, 1, 1000, 8), (3, 37, 96, 5), (2, 65, 40, 32)]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_fused_kernel_matches_plain(cuda_device, shape, with_h0):
    """y and h_last against the plain version at atol = rtol = 1e-5 (only
    expf and the order of the C sum differ)."""
    from repro_torch.kernels import selective_scan as SS
    n_, s, d, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(s * 100 + n)

    def rnd(*sh):
        return torch.randn(sh, generator=g, device=cuda_device)

    delta = torch.rand((n_, s, d), generator=g, device=cuda_device) \
        * 0.49 + 0.01
    a_mat = -(torch.rand((d, n), generator=g, device=cuda_device) * 0.9
              + 0.1)
    args = (delta, rnd(n_, s, d), rnd(n_, s, n), rnd(n_, s, n), a_mat,
            rnd(n_, d, n) if with_h0 else None)
    y, h = SS.mamba_scan_fused(*args)
    ry, rh = TR.mamba_scan_fused_ref(*args)
    torch.cuda.synchronize()
    assert SS.mamba_scan_fused.last_plan == SS.selective_scan_plan(d, n)
    torch.testing.assert_close(y, ry, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, rh, atol=1e-5, rtol=1e-5)


def test_mamba_scan_fused_raises_on_device_mixes(cuda_device):
    from repro_torch.kernels import selective_scan as SS
    b, s, d, n = 1, 4, 64, 16
    cpu = [torch.zeros(sh) for sh in ((b, s, d), (b, s, d), (b, s, n),
                                       (b, s, n), (d, n), (b, d, n))]
    for i in range(len(cpu)):
        for base, other in (("cpu", cuda_device), (cuda_device, "cpu")):
            ops = [t.to(base) for t in cpu]
            ops[i] = ops[i].to(other)
            with pytest.raises(ValueError):
                SS.mamba_scan_fused(*ops)


MM_TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
NORM_TOLS = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
MM_MODES = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
            "bf16_to_f32": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("act", ["none", "gelu", "silu", "relu2"])
@pytest.mark.parametrize("mode", sorted(MM_MODES))
@pytest.mark.parametrize("m,k", [(1, 1000), (3, 1000), (600, 1000),
                                 (1, 4096), (3, 4096), (600, 4096),
                                 (37, 1001)])
def test_matmul_fused_kernel_matches_plain(cuda_device, m, k, mode, act):
    """N = 11008 (yi-6b's d_ff), decode and prefill M, a K that is not a
    multiple of the tiles, and (K = 1001) the unvectorized loads; with and
    without a bias (f32 and x's dtype).  K = 1000 takes the fast paths
    (split_k at M <= 16, wgmma above, fma_tile in f32), K = 1001 the
    masked ones (wmma, fma)."""
    from repro_torch.kernels import fused_matmul as TM
    dtype, out_dtype = MM_MODES[mode]
    n = 11008
    if k % 8:
        path = "fma" if dtype == torch.float32 else "wmma"
    else:
        path = "fma_tile" if dtype == torch.float32 else \
            "split_k" if m <= 16 else "wgmma"
    g = torch.Generator(device=cuda_device).manual_seed(m * 7 + k)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda_device)
         / k ** 0.5).to(dtype)
    bias = torch.randn((n,), generator=g, device=cuda_device)
    tol = MM_TOLS[out_dtype or dtype]
    for b in (None, bias, bias.to(dtype)):
        out = TM.matmul_fused(x, w, b, activation=act, out_dtype=out_dtype)
        ref = TR.matmul_fused_ref(x, w, b, activation=act,
                                  out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert TM.matmul_fused.last_plan[0] == path
        assert out.dtype == ref.dtype and out.shape == (m, n)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("act", ["none", "gelu", "silu", "relu2"])
@pytest.mark.parametrize("mode", sorted(MM_MODES))
@pytest.mark.parametrize("m", [4, 512])
def test_matmul_fused_main_path_shapes(cuda_device, m, mode, act):
    """yi-6b's gate projection (K = 4096, N = 11008) at the serve's 4
    decode slots and a 512-token prefill chunk, every epilogue and output
    dtype, with and without a bias: split_k (13 K splits) and wgmma in
    bf16, fma_tile in f32."""
    from repro_torch.kernels import fused_matmul as TM
    dtype, out_dtype = MM_MODES[mode]
    k, n = 4096, 11008
    g = torch.Generator(device=cuda_device).manual_seed(m + 3)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(dtype)
    w = (torch.randn((k, n), generator=g, device=cuda_device)
         / k ** 0.5).to(dtype)
    bias = torch.randn((n,), generator=g, device=cuda_device)
    want = TM.matmul_plan(m, n, k, dtype)
    assert want[0] == ("fma_tile" if dtype == torch.float32 else
                       "split_k" if m == 4 else "wgmma")
    tol = MM_TOLS[out_dtype or dtype]
    for b in (None, bias, bias.to(dtype)):
        out = TM.matmul_fused(x, w, b, activation=act, out_dtype=out_dtype)
        ref = TR.matmul_fused_ref(x, w, b, activation=act,
                                  out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert TM.matmul_fused.last_plan == want
        assert out.dtype == ref.dtype and out.shape == (m, n)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 600])
def test_matmul_fused_misaligned_operands_take_the_masked_path(
        cuda_device, m, dtype):
    """x starting 8 bytes past a 16-byte boundary: K and N fit the fast
    paths, but the plan takes the masked kernels, which still match."""
    from repro_torch.kernels import fused_matmul as TM
    k, n = 1000, 2048
    g = torch.Generator(device=cuda_device).manual_seed(m)
    off = 8 // torch.tensor([], dtype=dtype).element_size()
    x = torch.randn((m * k + off,), generator=g, device=cuda_device).to(
        dtype)[off:].view(m, k)
    w = (torch.randn((k, n), generator=g, device=cuda_device)
         / k ** 0.5).to(dtype)
    out = TM.matmul_fused(x, w, None, activation="silu")
    ref = TR.matmul_fused_ref(x, w, None, activation="silu")
    torch.cuda.synchronize()
    assert TM.matmul_fused.last_plan[0] == (
        "fma" if dtype == torch.float32 else "wmma")
    torch.testing.assert_close(out.float(), ref.float(), atol=MM_TOLS[dtype],
                               rtol=MM_TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 100, 4095, 4096, 8192, 32768])
def test_norm_onepass_kernel_matches_plain(cuda_device, d, dtype):
    """Rows of one, decode (4), prefill (512) and ragged (513) batches,
    and more rows than the vector path's grid holds (2113: its blocks
    walk several rows each, scale and bias kept across them);
    f32 and x-dtype scales; rmsnorm, and layernorm with and without a
    bias (f32 and x-dtype); then x, and then the scale, viewed one
    element past a 16-byte boundary.  D a multiple of the vector width
    with every operand aligned takes the vector path, every other shape
    the scalar one (the plan recorded)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import layernorm as TL
    g = torch.Generator(device=cuda_device).manual_seed(d)
    tol = NORM_TOLS[dtype]
    sms = _build.sm_count(cuda_device)

    def shifted(n, dt):
        return torch.randn((n + 1,), generator=g, device=cuda_device).to(
            dt)[1:]

    for r in (1, 4, 512, 513, 2113):
        x = (torch.randn((r, d), generator=g, device=cuda_device) * 3
             + 1).to(dtype)
        scale = torch.randn((d,), generator=g, device=cuda_device)
        bias = torch.randn((d,), generator=g, device=cuda_device)
        cases = [(x, dict(scale=scale)), (x, dict(scale=scale.to(dtype))),
                 (x, dict(scale=scale, bias=bias, kind="layernorm")),
                 (x, dict(scale=scale.to(dtype), bias=bias.to(dtype),
                          kind="layernorm")),
                 (x, dict(scale=scale.to(dtype), kind="layernorm"))]
        if r in (4, 513):
            xs = shifted(r * d, dtype).view(r, d)
            xs.copy_(x)
            cases += [(xs, dict(scale=scale)),
                      (xs, dict(scale=scale, bias=bias, kind="layernorm")),
                      (x, dict(scale=shifted(d, torch.float32),
                               bias=bias, kind="layernorm"))]
        for xi, kw in cases:
            out = TL.norm_onepass(xi, **kw)
            ref = TR.norm_onepass_ref(xi, **kw)
            torch.cuda.synchronize()
            ops = [xi, kw["scale"]] + ([kw["bias"]] if "bias" in kw else [])
            aligned = all(t.data_ptr() % 16 == 0 for t in ops)
            assert TL.norm_onepass.last_plan == TL.norm_plan(
                r, d, dtype, aligned, sms)
            assert out.dtype == dtype
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)


def test_matmul_f32_keeps_the_f32_accumulator_on_cuda(cuda_device):
    """The model's f32-accumulating product of bf16 operands (the MLP's
    hidden and gate products, mamba's x projection, the LM head) equals
    the product of the operands widened to f32, up to summation order."""
    from repro_torch.models.layers import matmul_f32
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, 7, 4096), generator=g, device=cuda_device).to(
        torch.bfloat16)
    w = (torch.randn((4096, 11008), generator=g, device=cuda_device)
         / 64).to(torch.bfloat16)
    out = matmul_f32(x, w)
    ref = torch.matmul(x.float(), w.float())
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (2, 7, 11008)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_matmul_and_norm_raise_outside_their_contracts_on_cuda(cuda_device):
    """No fallback: CUDA tensors outside either contract raise."""
    from repro_torch.kernels import fused_matmul as TM
    from repro_torch.kernels import layernorm as TL
    x = torch.randn((8, 64), device=cuda_device)
    w = torch.randn((64, 32), device=cuda_device)
    for bad in (dict(x=x.t().contiguous().t()), dict(w=w.to(torch.bfloat16)),
                dict(activation="tanh")):
        kw = dict(x=x, w=w, activation="none") | bad
        with pytest.raises(ValueError):
            TM.matmul_fused(kw.pop("x"), kw.pop("w"), **kw)
    with pytest.raises(ValueError):
        TL.norm_onepass(torch.randn((2, 40_000), device=cuda_device),
                        torch.ones((40_000,), device=cuda_device))
    with pytest.raises(ValueError):
        TL.norm_onepass(x.t(), torch.ones((8,), device=cuda_device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_decode_runs_the_unfused_decode_kernel(cuda_device, dtype):
    """gemma2's local-layer per-slot decode on the card: the unfused paged
    decode over a view of the ring (``dispatch_ring_decode``, one launch)
    at D=256, G=2, softcap 50, against the plain ``_attend_block`` over
    ``ring_k_positions``: a slot before the ring fills, one at its last
    row, one wrapped, and an empty one (position -1: the mean of V)."""
    from repro_torch.backend import dispatch as kops
    from repro_torch.configs import REGISTRY
    from repro_torch.models import layers as TL
    cfg = REGISTRY["gemma2-9b"]
    b, w, hk, h, d = 4, 320, cfg.num_kv_heads, cfg.num_heads, cfg.head_dim
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * 4).to(dtype)

    q, kc, vc = rnd(b, 1, h, d), rnd(b, w, hk, d), rnd(b, w, hk, d)
    pos = torch.tensor([5, w - 1, 3 * w + 17, -1], device=cuda_device)
    n0 = TP.paged_attention_grouped.launches
    got = kops.dispatch_ring_decode(q, kc, vc, pos,
                                    softcap=cfg.attn_logit_softcap)
    assert TP.paged_attention_grouped.launches == n0 + 1
    k_pos, k_valid = TL.ring_k_positions(pos[:, None], w)
    ref = TL._attend_block(q.reshape(b, 1, hk, h // hk, d), kc, vc, cfg,
                           pos[:, None], k_pos, k_valid, True,
                           cfg.window_size, dtype)
    torch.cuda.synchronize()
    _close(got, ref, dtype)


# ---------------------------------------------------------------------------
# gradient routes (training): flash and the selective scan run the kernel
# forward inside an autograd.Function whose backward recomputes through the
# plain version; the f32-output products have a backward of their own;
# every other kernel raises when asked for a gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,causal,window,softcap", [
    (128, True, 0, 0.0), (256, True, 40, 50.0), (64, False, 0, 0.0)])
def test_flash_gradient_route_matches_plain(cuda_device, dtype, d, causal,
                                            window, softcap):
    g = torch.Generator(device=cuda_device).manual_seed(d)
    b, h, hk, s = 2, 8, 2, 130
    q, k, v = (torch.randn((b, n, s, d), generator=g, device=cuda_device)
               .to(dtype).requires_grad_() for n in (h, hk, hk))
    go = torch.randn((b, h, s, d), generator=g, device=cuda_device).to(dtype)
    pos = torch.arange(s, device=cuda_device, dtype=torch.int32)
    ones = torch.ones((s,), device=cuda_device, dtype=torch.int32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = TF.flash_attention_bhsd.launches
    out = TF.flash_attention_bhsd(q, k, v, pos, pos, ones, **kw)
    assert TF.flash_attention_bhsd.launches == n0 + 1
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), go)
    ref = TR.flash_attention_ref(q, k, v, pos, pos, ones, **kw)
    rgrads = torch.autograd.grad(ref, (q, k, v), go)
    _close(out, ref, dtype)
    for a, r in zip(grads, rgrads):
        assert a.dtype == dtype
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    with torch.no_grad():
        assert TF.flash_attention_bhsd(q, k, v, pos, pos, ones,
                                       **kw).grad_fn is None


@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_gradient_route_matches_plain(cuda_device, with_h0):
    from repro_torch.kernels import selective_scan as TS
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n_, s, d, n = 2, 40, 256, 16

    def t(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=cuda_device)
    ins = [(0.1 * t(n_, s, d)).abs(), t(n_, s, d), t(n_, s, n), t(n_, s, n),
           -t(d, n).abs(), t(n_, d, n) if with_h0 else None]
    ins = [None if x is None else x.requires_grad_() for x in ins]
    live = [x for x in ins if x is not None]
    gy, gh = t(n_, s, d), t(n_, d, n)
    n0 = TS.mamba_scan_fused.launches
    y, hl = TS.mamba_scan_fused(*ins)
    assert TS.mamba_scan_fused.launches == n0 + 1
    grads = torch.autograd.grad((y, hl), live, (gy, gh))
    ry, rh = TR.mamba_scan_fused_ref(*ins)
    rgrads = torch.autograd.grad((ry, rh), live, (gy, gh))
    torch.testing.assert_close(y, ry, atol=1e-5, rtol=1e-5)
    for a, r in zip(grads, rgrads):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["matmul_f32", "bmm_f32"])
def test_f32_output_products_have_a_backward(cuda_device, name):
    from repro_torch.models import layers as TL
    g = torch.Generator(device=cuda_device).manual_seed(4)
    lead = (4,) if name == "bmm_f32" else ()
    x = torch.randn(lead + (96, 256), generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    w = torch.randn(lead + (256, 160), generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    go = torch.randn(lead + (96, 160), generator=g, device=cuda_device)
    out = getattr(TL, name)(x, w)
    assert out.dtype == torch.float32
    gx, gw = torch.autograd.grad(out, (x, w), go)
    assert gx.dtype == gw.dtype == torch.bfloat16
    xf, wf = (a.detach().float().requires_grad_() for a in (x, w))
    rx, rw = torch.autograd.grad(torch.matmul(xf, wf), (xf, wf), go)
    for a, r in ((gx, rx), (gw, rw)):
        assert float((a.float() - r).abs().max()) \
            <= 2e-2 * float(r.abs().max())


def test_kernels_without_a_backward_raise_on_cuda(cuda_device):
    from repro_torch.kernels import linear_scan as TLS
    a = torch.rand((1, 4, 64), device=cuda_device, requires_grad=True)
    b = torch.rand((1, 4, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="linear_scan has no backward"):
        TLS.linear_scan(a, b)
    with torch.no_grad():
        torch.testing.assert_close(TLS.linear_scan(a, b),
                                   TR.linear_scan_ref(a, b), rtol=0, atol=0)
