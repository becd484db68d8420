"""The port's MoE FFN against the JAX package's, on the same weights.

``repro_torch.models.layers.apply_moe`` against ``repro.models.layers.
apply_moe``: the same inputs and weights, drawn with numpy, go through
both, in f32 and in bf16, for a one-token step (drop-free capacity) and a
12-token prefill, with and without a router biased so that most tokens
choose one expert (capacity drops certain; the biases are distinct and
3 apart, so that top-k sees no ties), with the shared expert on and off,
at three expert layouts: the reduced qwen2-moe (4 experts, top-2),
qwen2-moe's own 60 experts top-4 and granite-moe's 32 experts top-8, at a
narrow d_model.

Tolerances: f32 ``y`` at the JAX MoE test's atol 2e-4, rtol 2e-3
(``tests/test_perf_paths.py``), the aux loss at rtol 1e-5 (a mean of
f32 probabilities).  bf16 ``y``: at most 1% of the elements differ from
JAX's, none by more than one bf16 ulp (the frameworks sum the f32
accumulators in different orders before the one rounding to bf16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from test_torch_model import _assert_bf16_within_one_ulp  # noqa: E402

D_MODEL = 64
LAYOUTS = {   # (arch, routed-expert overrides of the reduced config)
    "reduced-qwen2": ("qwen2-moe-a2.7b", {}),
    "qwen2-60x4": ("qwen2-moe-a2.7b", dict(num_experts=60,
                                           experts_per_token=4)),
    "granite-32x8": ("granite-moe-1b-a400m", dict(num_experts=32,
                                                  experts_per_token=8)),
}


def configs(layout, dtype, shared):
    arch, moe_kw = LAYOUTS[layout]
    out = []
    for reg, reduced in ((J_REGISTRY, j_reduced), (T_REGISTRY, t_reduced)):
        cfg = reduced(reg[arch], d_model=D_MODEL)
        moe = dataclasses.replace(cfg.moe, num_shared_experts=int(shared),
                                  **moe_kw)
        out.append(dataclasses.replace(cfg, moe=moe, dtype=dtype,
                                       param_dtype=dtype))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def moe_weights(cfg, seed, biased):
    """JAX-layout MoE params drawn with numpy (N(0, 1)/sqrt(fan_in)).
    ``biased``: the router gains 3 * (E - e) along a direction every
    input carries, so expert 0 leads, then 1, 2, ..."""
    r = np.random.default_rng(seed)
    m = cfg.moe
    e, d, f = m.num_experts, cfg.d_model, m.expert_d_ff

    def w(*shape):
        return r.standard_normal(shape) / np.sqrt(shape[-2])

    router = w(d, e)
    u = np.zeros(d)
    u[0] = 1.0
    if biased:
        router = router + np.outer(u, 3.0 * (e - np.arange(e)))
    p = {"router": router.astype(np.float32),
         "wi": w(e, d, f), "wg": w(e, d, f), "wo": w(e, f, d)}
    if m.num_shared_experts:
        sf = m.shared_expert_d_ff
        p["shared"] = {"wi": w(d, sf), "wg": w(d, sf), "wo": w(sf, d)}
    return p, u


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree, jnp.float32 if tree.dtype == np.float32
                       else dtype)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), "cpu")


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("shape", [(6, 1), (2, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_apply_moe_matches_jax(layout, dtype, shape, biased, shared):
    jc, tc = configs(layout, dtype, shared)
    b, s = shape
    jdt = jnp.dtype(dtype)
    p, u = moe_weights(jc, sorted(LAYOUTS).index(layout) * 8 + s
                       + 2 * biased + shared, biased)
    jp = _cast(p, jdt)
    tp = _to_torch(jp)
    assert tp["router"].dtype == torch.float32
    r = np.random.default_rng(s + 7 * biased)
    x = r.standard_normal((b, s, jc.d_model)) + 4.0 * biased * u
    xj = jnp.asarray(x, jdt)
    jy, jaux = JL.apply_moe(jp, xj, jc)
    ty, taux = TL.apply_moe(tp, tensor_from_numpy(np.asarray(xj), "cpu"),
                            tc)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (b, s, D_MODEL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4,
                                   rtol=2e-3)
    else:
        _assert_bf16_within_one_ulp(ty, jy)
    # the biased router drops rows at the prefill (the first round alone
    # sends every token to expert 0, past its capacity) and none at the
    # one-token step, whose capacity is the token count
    n = b * s
    cap = TL.moe_capacity(tc, n, s)
    xf = torch.from_numpy(np.array(xj, np.float32)).reshape(n, -1)
    first = torch.softmax(xf @ tp["router"], -1).argmax(-1)
    if biased:
        assert int((first == 0).sum()) > cap if s > 1 else cap == n


def test_moe_dispatch_sends_dropped_rows_to_the_sink():
    """Two rounds over 3 experts at capacity 1: the rows past it fall on
    the sink row (k * cap) of the stacked buffer, which the expert
    products never read, and contribute 0; the kept rows hold JAX's
    buffer.  A token whose choices are all dropped gets 0 from the routed
    experts (no shared expert here)."""
    jc, tc = configs("reduced-qwen2", "float32", False)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, num_experts=3, capacity_factor=0.5))
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, num_experts=3, capacity_factor=0.5))
    p, u = moe_weights(jc, 4, biased=True)
    jp = _cast(p, jnp.float32)
    x = np.random.default_rng(5).standard_normal((1, 6, D_MODEL)) + 4.0 * u
    jy, _ = JL.apply_moe(jp, jnp.asarray(x, jnp.float32), jc)
    ty, _ = TL.apply_moe(_to_torch(jp), torch.from_numpy(
        x.astype(np.float32)), tc)
    assert TL.moe_capacity(tc, 6, 6) == 1
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4,
                               rtol=2e-3)
    # tokens 1..5 chose expert 0 then 1 like token 0: all dropped
    assert float(ty[0, 1:].abs().max()) == 0.0
    assert float(ty[0, 0].abs().max()) > 0.0
