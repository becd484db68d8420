"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: without a CUDA device every test here skips (the check
runs inside the ``cuda_device`` fixture, never at import).  On a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 at 2e-5 (order of summation); bf16 at 2e-2 (the plain
version rounds its softmax probabilities to bf16, the kernels keep f32).
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
    out, kp1, vp1 = TP.fused_paged_decode_grouped(
        q, kn, vn, kp.clone(), vp.clone(), bt, pos, theta=5e6)
    ro, kp2, vp2 = TR.fused_paged_decode_ref(
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
