"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: without a CUDA device every test here skips (the check
runs inside the ``cuda_device`` fixture, never at import).  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 at 2e-5 (order of summation); bf16 at 2e-2 (the plain
version rounds its softmax probabilities to bf16, the kernels keep f32).
The int8 rows and scales the fused decode writes must equal the plain
version's, and the linear scan's states must equal the plain version's
bit for bit (both round the product and the sum separately in f32).
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
@pytest.mark.parametrize("d", [64, 128])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype):
    """The unfused paged decode over fp and int8 pools, ragged lengths
    (a page end, mid-page, the whole table), with and without softcap."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, hk, grp, d, page, nb = 3, 2, 8, 128, 16, 6
    n = b * nb + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    bt = torch.randperm(b * nb, generator=g, device=cuda_device).reshape(
        b, nb).to(torch.int32)
    lengths = torch.tensor([16, 37, nb * page], dtype=torch.int32,
                           device=cuda_device)
    q = rnd(b, hk, grp, d).to(dtype)
    kq, ks = TR.quantize_int8_rows(rnd(n, page, hk, d))
    vq, vs = TR.quantize_int8_rows(rnd(n, page, hk, d))
    fp = (TR.dequantize_int8(kq, ks).to(dtype),
          TR.dequantize_int8(vq, vs).to(dtype))
    for pools, sc in ((fp, {}), ((kq, vq), dict(k_scales=ks, v_scales=vs))):
        for softcap in (0.0, 30.0):
            out = TP.paged_attention_grouped(q, *pools, bt, lengths,
                                             softcap=softcap, **sc)
            ref = TR.paged_attention_ref(q, *pools, bt, lengths,
                                         softcap=softcap, **sc)
            torch.cuda.synchronize()
            _close(out, ref, dtype)


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
