"""The port's kernel front door (``repro_torch.kernels.ops``) against the
JAX package's (``repro.kernels.ops``), and its two kernels' plain versions.

``matmul_fused_ref`` and ``norm_onepass_ref`` are held to their twins in
``repro.kernels.ref`` on the same inputs (made with numpy from a seed) at
the JAX kernel tests' shapes and a ragged one, and to the Pallas kernels
run in interpret mode (block 128).  The front doors and the ``ops``
aliases are held to JAX's on 3-D inputs.  The CUDA kernels themselves run
only on a GPU (``tests/test_torch_cuda.py``); here the wrappers take the
plain versions, and the shape contracts are checked on CPU tensors.

Tolerances: against the JAX refs f32 at 1e-5 (summation order) and bf16
outputs at 1e-2, under three bf16 ulps (one is at most 2^-7 relative);
against the Pallas kernels the JAX kernel tests' own: matmul 1e-4 / 2e-2,
norm 1e-5 / 3e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.fused_matmul import matmul_fused as pallas_mm  # noqa: E402
from repro.kernels.layernorm import norm_onepass as pallas_norm  # noqa: E402
from repro_torch.backend import dispatch as TD  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import fused_matmul as TM  # noqa: E402
from repro_torch.kernels import layernorm as TL  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

REF_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ACTS = ["none", "gelu", "silu", "relu2"]
MM_SHAPES = [(128, 256, 128), (256, 512, 384), (512, 128, 256), (3, 100, 70)]
NORM_SHAPES = [(128, 256), (512, 384), (256, 1024), (5, 100)]
# (input dtype, out_dtype or None)
MM_MODES = {"f32": ("float32", None), "bf16": ("bfloat16", None),
            "bf16_to_f32": ("bfloat16", "float32"),
            "f32_to_bf16": ("float32", "bfloat16")}


def both(x, dtype="float32"):
    """The same values as a jax array and a CPU torch tensor (bf16 moves
    bit-exactly through the weight bridge's path)."""
    a = jnp.asarray(x, getattr(jnp, dtype))
    return a, tensor_from_numpy(np.asarray(a), "cpu")


def close(t, a, tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(a, np.float32), atol=tol, rtol=tol)


def mm_inputs(seed, m, k, n, dtype, scale=0.1):
    r = np.random.default_rng(seed)
    return (both(r.standard_normal((m, k)) * scale, dtype),
            both(r.standard_normal((k, n)) * scale, dtype),
            both(r.standard_normal((n,)) * scale, dtype))


# ---------------------------------------------------------------------------
# plain versions against the JAX refs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MM_MODES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
def test_matmul_fused_ref_matches_jax(m, k, n, act, with_bias, mode):
    dtype, out = MM_MODES[mode]
    (xj, xt), (wj, wt), (bj, bt) = mm_inputs(m * k + n, m, k, n, dtype)
    if not with_bias:
        bj = bt = None
    ja = JR.matmul_fused_ref(xj, wj, bj, activation=act,
                             out_dtype=out and getattr(jnp, out))
    to = TR.matmul_fused_ref(xt, wt, bt, activation=act,
                             out_dtype=out and getattr(torch, out))
    assert str(to.dtype)[6:] == str(ja.dtype)
    close(to, ja, REF_TOL[out or dtype])


def test_matmul_fused_ref_takes_an_f32_bias_on_bf16_operands():
    (xj, xt), (wj, wt), (bj, bt) = mm_inputs(3, 3, 100, 70, "bfloat16")
    bj32, bt32 = both(np.asarray(bj, np.float32))
    close(TR.matmul_fused_ref(xt, wt, bt32, activation="silu"),
          JR.matmul_fused_ref(xj, wj, bj32, activation="silu"),
          REF_TOL["bfloat16"])


@pytest.mark.parametrize("dtype", sorted(REF_TOL))
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "other"])
@pytest.mark.parametrize("r_,d", NORM_SHAPES)
def test_norm_onepass_ref_matches_jax(r_, d, kind, dtype):
    """Every kind but "layernorm" is rmsnorm on both sides; the scale in
    x's dtype and in f32 (the port's models keep norm scales in f32),
    layernorm with and without a bias."""
    r = np.random.default_rng(r_ * d)
    xj, xt = both(r.standard_normal((r_, d)) * 2 + 0.5, dtype)
    sj, st = both(r.standard_normal((d,)), dtype)
    bj, bt = both(r.standard_normal((d,)), dtype)
    s32j, s32t = both(np.asarray(sj, np.float32))
    for args_j, args_t in (((sj, bj), (st, bt)), ((s32j, None),
                                                  (s32t, None))):
        ja = JR.norm_onepass_ref(xj, *args_j, kind=kind)
        to = TR.norm_onepass_ref(xt, *args_t, kind=kind)
        assert str(to.dtype)[6:] == str(ja.dtype)
        close(to, ja, REF_TOL[dtype])


def test_unknown_activation_raises_where_the_jax_ref_returns_the_product():
    """The split the port settles as the Pallas epilogue does: JAX's ref
    returns the plain product for an unknown activation, its kernel (and
    the port's plain version, wrapper and front door) raise."""
    (xj, xt), (wj, wt), _ = mm_inputs(1, 4, 8, 6, "float32")
    close(TR.matmul_fused_ref(xt, wt),
          JR.matmul_fused_ref(xj, wj, activation="tanh"), 1e-5)
    for fn in (TR.matmul_fused_ref, TM.matmul_fused, TD.dispatch_matmul,
               TO.matmul_fused):
        with pytest.raises(ValueError):
            fn(xt, wt, activation="tanh")
    with pytest.raises(ValueError):
        pallas_mm(xj, wj, activation="tanh", interpret=True)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", MM_SHAPES[:3])
def test_matmul_fused_plain_matches_pallas_interpret(m, k, n, act, dtype):
    (xj, xt), (wj, wt), (bj, bt) = mm_inputs(m + k * n, m, k, n, dtype)
    pa = pallas_mm(xj, wj, bj, activation=act, block_m=128, block_n=128,
                   block_k=128, interpret=True)
    to = TM.matmul_fused(xt, wt, bt, activation=act)
    close(to, pa, 2e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("r_,d", NORM_SHAPES[:3])
def test_norm_onepass_plain_matches_pallas_interpret(r_, d, kind, dtype):
    r = np.random.default_rng(r_ + d)
    xj, xt = both(r.standard_normal((r_, d)), dtype)
    sj, st = both(r.standard_normal((d,)), dtype)
    bj, bt = both(r.standard_normal((d,)), dtype)
    pa = pallas_norm(xj, sj, bj, kind=kind, block_rows=128, interpret=True)
    to = TL.norm_onepass(xt, st, bt, kind=kind)
    close(to, pa, 3e-2 if dtype == "bfloat16" else 1e-5)


# ---------------------------------------------------------------------------
# the front doors and the ops aliases against JAX's, on 3-D inputs
# ---------------------------------------------------------------------------

def test_ops_names_mirror_the_jax_entry_point():
    """Every name of ``repro.kernels.ops`` but ``use_flash`` (the port has
    no q-chunked attention path to choose against)."""
    assert set(TO.__all__) == set(JO.__all__) - {"use_flash"}
    assert TO.matmul_fused is TD.dispatch_matmul
    assert TO.norm_onepass is TD.dispatch_layernorm
    assert TO.flash_attention is TD.dispatch_flash_attention
    assert TO.linear_scan is TD.dispatch_linear_scan
    assert TO.kernel_path("cpu") == "cpu-plain"
    import repro_torch.backend as TB
    assert TB.dispatch_matmul is TD.dispatch_matmul
    assert TB.dispatch_layernorm is TD.dispatch_layernorm


@pytest.mark.parametrize("dtype", sorted(REF_TOL))
@pytest.mark.parametrize("act", ACTS)
def test_ops_matmul_fused_matches_jax_on_3d_inputs(act, dtype):
    r = np.random.default_rng(11)
    xj, xt = both(r.standard_normal((2, 5, 96)) * 0.3, dtype)
    wj, wt = both(r.standard_normal((96, 40)) * 0.3, dtype)
    bj, bt = both(r.standard_normal((40,)) * 0.3)
    for args_j, args_t in (((wj, bj), (wt, bt)), ((wj,), (wt,))):
        ja = JO.matmul_fused(xj, *args_j, activation=act)
        for door in (TO.matmul_fused, TD.dispatch_matmul):
            to = door(xt, *args_t, activation=act)
            assert tuple(to.shape) == ja.shape == (2, 5, 40)
            close(to, ja, REF_TOL[dtype])
    ja = JO.matmul_fused(xj, wj, out_dtype=jnp.float32)
    to = TO.matmul_fused(xt, wt, out_dtype=torch.float32)
    assert to.dtype == torch.float32
    close(to, ja, 1e-5)


@pytest.mark.parametrize("dtype", sorted(REF_TOL))
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_ops_norm_onepass_matches_jax_on_3d_inputs(kind, dtype):
    r = np.random.default_rng(12)
    xj, xt = both(r.standard_normal((2, 5, 96)), dtype)
    sj, st = both(r.standard_normal((96,)))
    bj, bt = both(r.standard_normal((96,)))
    ja = JO.norm_onepass(xj, sj, bj, kind=kind, eps=1e-5)
    for door in (TO.norm_onepass, TD.dispatch_layernorm):
        to = door(xt, st, bt, kind=kind, eps=1e-5)
        assert tuple(to.shape) == ja.shape and str(to.dtype)[6:] == dtype
        close(to, ja, REF_TOL[dtype])


def test_ops_flash_attention_and_linear_scan_match_jax():
    r = np.random.default_rng(13)
    qj, qt = both(r.standard_normal((1, 8, 4, 64)))
    kj, kt = both(r.standard_normal((1, 8, 2, 64)))
    vj, vt = both(r.standard_normal((1, 8, 2, 64)))
    pos = np.arange(8, dtype=np.int32)
    ja = JO.flash_attention(qj, kj, vj, q_pos=jnp.asarray(pos),
                            k_pos=jnp.asarray(pos))
    to = TO.flash_attention(qt, kt, vt, q_pos=torch.from_numpy(pos),
                            k_pos=torch.from_numpy(pos))
    close(to, ja, 2e-5)
    aj, at = both(r.uniform(0.5, 1.0, (2, 6, 16)))
    bj, bt = both(r.standard_normal((2, 6, 16)))
    close(TO.linear_scan(at, bt), JO.linear_scan(aj, bj), 1e-5)


# ---------------------------------------------------------------------------
# the CUDA contracts, checked on CPU tensors
# ---------------------------------------------------------------------------

def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_contracts_accept_the_served_widths():
    bf = dict(dtype=torch.bfloat16)
    assert TM.check_matmul_contract(
        _t(4, 4096, **bf), _t(4096, 11008, **bf), activation="silu") == (
        4, 4096, 11008)
    assert TM.check_matmul_contract(
        _t(512, 4096, **bf), _t(4096, 4096, **bf), _t(4096),
        activation="gelu", out_dtype=torch.float32) == (512, 4096, 4096)
    assert TM.check_matmul_contract(_t(3, 1001), _t(1001, 70),
                                    _t(70)) == (3, 1001, 70)
    assert TL.check_norm_contract(_t(512, 8192, **bf), _t(8192)) == (512,
                                                                     8192)
    assert TL.check_norm_contract(_t(4, 24_576), _t(24_576),
                                  _t(24_576)) == (4, 24_576)


@pytest.mark.parametrize("bad", ["activation", "rank", "chain", "dtypes",
                                 "fp16", "bias_shape", "bias_dtype",
                                 "noncontig", "empty", "out_dtype"])
def test_matmul_contract_raises_outside_it(bad):
    kw = dict(x=_t(8, 16), w=_t(16, 12), bias=None, activation="none",
              out_dtype=None)
    if bad == "activation":
        kw["activation"] = "tanh"
    elif bad == "rank":
        kw["x"] = _t(2, 8, 16)
    elif bad == "chain":
        kw["w"] = _t(15, 12)
    elif bad == "dtypes":
        kw["w"] = _t(16, 12, dtype=torch.bfloat16)
    elif bad == "fp16":
        kw["x"], kw["w"] = _t(8, 16, dtype=torch.float16), _t(
            16, 12, dtype=torch.float16)
    elif bad == "bias_shape":
        kw["bias"] = _t(13)
    elif bad == "bias_dtype":
        kw["bias"] = _t(12, dtype=torch.bfloat16)
    elif bad == "noncontig":
        kw["w"] = _t(12, 16).t()
    elif bad == "empty":
        kw["x"] = _t(0, 16)
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    x, w, b = kw.pop("x"), kw.pop("w"), kw.pop("bias")
    with pytest.raises(ValueError):
        TM.check_matmul_contract(x, w, b, **kw)


@pytest.mark.parametrize("bad", ["rank", "wide", "empty", "fp16",
                                 "scale_shape", "scale_dtype", "bias_dtype",
                                 "noncontig"])
def test_norm_contract_raises_outside_it(bad):
    x, scale, bias = _t(4, 64), _t(64), None
    if bad == "rank":
        x = _t(2, 4, 64)
    elif bad == "wide":
        x, scale = _t(2, TL.MAX_D + 1), _t(TL.MAX_D + 1)
    elif bad == "empty":
        x = _t(0, 64)
    elif bad == "fp16":
        x = x.to(torch.float16)
    elif bad == "scale_shape":
        scale = _t(63)
    elif bad == "scale_dtype":
        x, scale = x.to(torch.bfloat16), scale.to(torch.float16)
    elif bad == "bias_dtype":
        bias = _t(64, dtype=torch.bfloat16)
    elif bad == "noncontig":
        x = _t(64, 4).t()
    with pytest.raises(ValueError):
        TL.check_norm_contract(x, scale, bias)


def test_wrappers_raise_on_a_device_without_a_kernel():
    x = torch.zeros((4, 8), device="meta")
    w = torch.zeros((8, 6), device="meta")
    with pytest.raises(ValueError):
        TM.matmul_fused(x, w)
    with pytest.raises(ValueError):
        TL.norm_onepass(x, torch.zeros((8,), device="meta"))
    with pytest.raises(ValueError):
        TO.norm_onepass(x[None], torch.zeros((8,), device="meta"))
