"""Mamba's scans in the port, on the CPU: the fused selective scan and the
linear scan's launch plans.

The plain ``mamba_scan_fused_ref`` is held to the JAX package's
``repro.models.ssm.mamba_scan_fused`` (its default mamba prefill) on the
same numpy inputs, over sequence lengths that take JAX's whole-chunk,
short-sequence and gcd branches, at JAX's own unit tolerance
(``tests/test_perf_paths.py::test_mamba_fused_scan_unit``: atol = rtol =
1e-5).  The port's door equals its plain version on CPU tensors, the
CUDA kernel's contract raises outside its limits, ``apply_mamba`` takes
the fused scan at S > 1 and the linear scan at S == 1 as JAX's does with
``REPRO_MAMBA`` unset, and its prefill forms no (B, S, d_inner, d_state)
tensor.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import linear_scan as TS  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import selective_scan as SS  # noqa: E402
from repro_torch.models import ssm as TSM  # noqa: E402

TIGHT = dict(atol=1e-5, rtol=1e-5)
HYBRID = "jamba-1.5-large-398b-dense-ffn"


def _scan_inputs(seed, b, s, di, n, with_h0):
    """delta, xi, B, C, A (and h0) as numpy f32, with the value ranges of
    JAX's unit test (delta 0.01-0.5, A in -1..-0.1)."""
    r = np.random.default_rng(seed)
    arrs = [r.uniform(0.01, 0.5, (b, s, di)), r.standard_normal((b, s, di)),
            r.standard_normal((b, s, n)), r.standard_normal((b, s, n)),
            -r.uniform(0.1, 1.0, (di, n)),
            r.standard_normal((b, di, n)) if with_h0 else None]
    return [None if a is None else a.astype(np.float32) for a in arrs]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("s", [2, 37, 64, 130])
def test_mamba_scan_fused_ref_matches_jax(s, chunk, with_h0):
    """S = 2 and 37 are shorter than JAX's chunk (one chunk of S), 64
    divides 16 and not 128, 130 takes the gcd branch (chunks of 2)."""
    arrs = _scan_inputs(s * 10 + chunk + with_h0, 2, s, 24, 16, with_h0)
    jy, jh = JS.mamba_scan_fused(
        *[None if a is None else jnp.asarray(a) for a in arrs], chunk=chunk)
    ty, th = TR.mamba_scan_fused_ref(*_torch(arrs))
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TIGHT)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TIGHT)


@pytest.mark.parametrize("door", ["kernel_wrapper", "model"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_fused_on_cpu_equals_plain(door, with_h0):
    """On CPU tensors both doors run the plain version, bit for bit; the
    model's door also takes B and C as views of the x projection."""
    delta, xi, bm, cm, a_mat, h0 = _torch(
        _scan_inputs(3 + with_h0, 2, 9, 40, 8, with_h0))
    ry, rh = TR.mamba_scan_fused_ref(delta, xi, bm, cm, a_mat, h0)
    if door == "model":
        proj = torch.cat([torch.zeros(2, 9, 3), bm, cm], dim=-1)
        bm, cm = proj[..., 3:11], proj[..., 11:]
        assert not bm.is_contiguous()
        y, h = TSM.mamba_scan_fused(delta, xi, bm, cm, a_mat, h0)
    else:
        y, h = SS.mamba_scan_fused(delta, xi, bm, cm, a_mat, h0)
    assert torch.equal(y, ry) and torch.equal(h, rh)


def _scan_operands(b=2, s=5, d=64, n=16, dev="cpu"):
    z = dict(dtype=torch.float32, device=dev)
    return dict(delta=torch.zeros((b, s, d), **z),
                xi=torch.zeros((b, s, d), **z),
                bm=torch.zeros((b, s, n), **z), cm=torch.zeros((b, s, n), **z),
                a_mat=torch.zeros((d, n), **z), h0=torch.zeros((b, d, n), **z))


def test_selective_scan_contract_accepts_main_path_shapes():
    """serve-hybrid's admissions (N = 1, S up to 600, jamba's d_inner and
    d_state), the reduced test model's d_state 8, and a ragged d_inner."""
    for (b, s, d, n) in ((1, 600, 16_384, 16), (4, 100, 16_384, 16),
                         (2, 12, 128, 8), (3, 7, 1001, 5), (1, 1, 1, 32)):
        ops = _scan_operands(b, s, d, n, dev="meta")
        assert SS.check_selective_scan_contract(**ops) == (b, s, d, n)
        ops["h0"] = None
        assert SS.check_selective_scan_contract(**ops) == (b, s, d, n)


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "xi_shape", "b_shape",
                                 "a_shape", "h0_shape", "state_zero",
                                 "state_wide", "empty_seq", "rows",
                                 "devices"])
def test_selective_scan_contract_raises_outside_it(bad):
    ops = _scan_operands()
    if bad == "dtype":
        ops["xi"] = ops["xi"].to(torch.bfloat16)
    elif bad == "noncontig":
        ops["delta"] = torch.zeros((2, 64, 5)).transpose(1, 2)
    elif bad == "xi_shape":
        ops["xi"] = torch.zeros((2, 5, 63))
    elif bad == "b_shape":
        ops["bm"] = torch.zeros((2, 5, 15))
    elif bad == "a_shape":
        ops["a_mat"] = torch.zeros((63, 16))
    elif bad == "h0_shape":
        ops["h0"] = torch.zeros((2, 64, 15))
    elif bad == "state_zero":
        ops = _scan_operands(n=0)
    elif bad == "state_wide":
        ops = _scan_operands(n=SS.MAX_STATE + 1)
    elif bad == "empty_seq":
        ops = _scan_operands(s=0)
    elif bad == "rows":
        ops = _scan_operands(b=SS.MAX_ROWS + 1, s=1, d=1, n=1, dev="meta")
    elif bad == "devices":
        ops["cm"] = ops["cm"].to("meta")
    with pytest.raises(ValueError):
        SS.check_selective_scan_contract(**ops)


@pytest.mark.parametrize("which", ["h0", "delta"])
def test_mamba_scan_fused_raises_on_mixed_devices(which):
    """The door raises before it picks a path: a CPU tensor beside one
    elsewhere goes to neither the plain version nor the kernel."""
    ops = _scan_operands()
    ops[which] = ops[which].to("meta")
    with pytest.raises(ValueError):
        SS.mamba_scan_fused(**ops)


@pytest.mark.parametrize("shape,aligned,plan", [
    ((16_384, 16), True, ("vector", 4, 4, 512)),     # jamba
    ((128, 8), True, ("vector", 2, 4, 2)),           # the reduced model
    ((16_384, 32), True, ("vector", 8, 4, 1024)),
    ((1000, 16), True, ("vector", 4, 4, 32)),
    ((1001, 16), True, ("scalar", 4, 4, 32)),        # ragged d_inner
    ((16_384, 16), False, ("scalar", 4, 4, 512)),    # misaligned operand
    ((96, 5), True, ("scalar", 2, 4, 2)),            # padded states
    ((64, 3), True, ("scalar", 1, 4, 1)),
    ((64, 2), True, ("scalar", 1, 2, 1)),
    ((64, 1), True, ("scalar", 1, 1, 1)),
])
def test_selective_scan_plan(shape, aligned, plan):
    """(copies, lanes, states, blocks): lanes x states covers d_state with
    at most 4 states a thread, a block of 128 threads takes 128 / lanes
    channels; 16-byte staging needs D and n multiples of 4."""
    got = SS.selective_scan_plan(*shape, aligned=aligned)
    assert got == plan
    _, lanes, states, blocks = got
    assert lanes * states >= shape[1] and lanes <= 32
    assert blocks * (SS.THREADS // lanes) >= shape[0]


@pytest.mark.parametrize("f,aligned,plan", [
    (262_144, True, ("vector", 128, 512)),           # jamba's d_inner x 16
    (262_143, True, ("scalar", 256, 1024)),          # odd F
    (262_144, False, ("scalar", 256, 1024)),         # misaligned operand
    (1000, True, ("vector", 128, 2)),
    (4, True, ("vector", 128, 1)),
])
def test_linear_scan_plan(f, aligned, plan):
    """(path, threads, blocks along F): the vector path's threads own 4
    features each."""
    assert TS.scan_plan(f, aligned) == plan
    path, threads, blocks = plan
    assert blocks * threads * (4 if path == "vector" else 1) >= f


def _mamba_params(seed=0):
    cfg = t_reduced(T_REGISTRY[HYBRID], layers=8)
    p = TSM.init_mamba(torch.Generator().manual_seed(seed), cfg, "cpu")
    return p, cfg


@pytest.mark.parametrize("s", [1, 2, 12])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mamba_routes_prefill_to_the_fused_scan(monkeypatch, s,
                                                      with_state):
    """S > 1 goes through ``mamba_scan_fused`` once and never the linear
    scan; S == 1 (decode) through the linear scan once, as JAX's
    ``apply_mamba`` with ``REPRO_MAMBA`` unset."""
    from repro_torch.kernels import linear_scan as LS
    calls = {"fused": 0, "linear": 0}
    fused, linear = SS.mamba_scan_fused, LS.linear_scan

    def spy_fused(*a, **k):
        calls["fused"] += 1
        return fused(*a, **k)

    def spy_linear(*a, **k):
        calls["linear"] += 1
        return linear(*a, **k)

    monkeypatch.setattr(SS, "mamba_scan_fused", spy_fused)
    monkeypatch.setattr(LS, "linear_scan", spy_linear)
    p, cfg = _mamba_params()
    x = torch.randn((2, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(s))
    state = None
    if with_state:
        state = {k: torch.randn(v, generator=torch.Generator().manual_seed(9))
                 for k, v in TSM.mamba_state_shape(cfg, 2).items()}
    out, new = TSM.apply_mamba(p, x, cfg, state)
    assert calls == ({"fused": 0, "linear": 1} if s == 1
                     else {"fused": 1, "linear": 0})
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert new["ssm"].dtype == torch.float32


def test_apply_mamba_prefill_forms_no_state_sequence_tensor():
    """No op of a 12-token prefill outputs as many elements as one
    (B, S, d_inner, d_state) tensor: the gate, the input and the states
    stay per step."""
    from torch.utils._python_dispatch import TorchDispatchMode
    p, cfg = _mamba_params(1)
    b, s = 2, 12
    d_inner, _ = TSM.mamba_dims(cfg)
    full = b * s * d_inner * cfg.ssm.d_state

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    with Largest():
        TSM.apply_mamba(p, x, cfg)
    assert 0 < Largest.numel < full, (Largest.numel, full)
