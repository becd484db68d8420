"""The port's sharding rules and ZeRO-1 specs against the JAX package's.

For every config of the port's registry at published size (the port's
two jamba cuts against the published jamba with the same cut), the
shapes come from ``meta`` tensors in the port and from
``jax.eval_shape`` in JAX (no weights are made), and on five meshes --
(16, 16) data x model, (2, 16, 16) pod x data x model, (1, 8) (one
8-card node), (4, 2) and (2, 4) (JAX's own tests) -- with FSDP and
expert parallelism each off and on:

* ``param_specs`` equals JAX's leaf for leaf, a stack's specs in JAX's
  stacked (G, ...) layout, group-axis entries included;
* ``zero1_specs`` equals JAX's;
* ``input_specs_tree`` equals JAX's on token, label, position, M-RoPE
  position and embed trees, and on dense, paged and int8-paged caches.

Then ``placements`` maps specs to DTensor placements, and the port's
``Mesh`` (256 ``meta`` devices) gives the duck-typed mesh's specs.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro import sharding as JS  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training.optimizer import zero1_specs as j_zero1  # noqa: E402
from repro_torch import sharding as TS  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.training import zero1_specs as t_zero1  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def duck_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def j_config(tc):
    """JAX's config of the port's ``tc``: the registry's, or the published
    jamba with the port's cut (dense FFNs, or 8 experts)."""
    if tc.name in JC.REGISTRY:
        return JC.REGISTRY[tc.name]
    jc = JC.REGISTRY["jamba-1.5-large-398b"]
    blocks = tuple(JC.BlockSpec(b.mixer, b.ffn) for b in tc.block_pattern)
    moe = None if tc.moe is None else dataclasses.replace(
        jc.moe, num_experts=tc.moe.num_experts)
    jc = dataclasses.replace(jc, name=tc.name, block_pattern=blocks, moe=moe)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc


@functools.lru_cache(maxsize=None)
def shapes(arch):
    """(JAX's ShapeDtypeStruct params, the port's meta params)."""
    tc = T_REGISTRY[arch]
    jp = jax.eval_shape(j_build(j_config(tc)).init, jax.random.key(0))
    tp = t_build(tc, device="meta").init(torch.Generator())
    return jp, tp


def as_tuples(tree):
    """A spec tree with each spec as a plain tuple, JAX's or the port's."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, (JP, P)), tree
    return tuple(tree)


def test_stacked_shapes_are_jax_shapes():
    for arch in ("yi-6b", "whisper-base", "jamba-1.5-large-398b"):
        jp, tp = shapes(arch)
        want = jax.tree.map(lambda s: tuple(s.shape), jp)
        assert TS.stacked_shapes(tp) == want, arch


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(T_REGISTRY))
def test_param_and_zero1_specs_equal_jax(arch, mesh_name):
    jp, tp = shapes(arch)
    mesh = duck_mesh(mesh_name)
    for fsdp in (False, True):
        for ep in (False, True):
            tag = f"{arch} {mesh_name} fsdp={fsdp} ep={ep}"
            js = JS.param_specs(jp, mesh, fsdp=fsdp, expert_parallel=ep)
            ts = TS.param_specs(tp, mesh, fsdp=fsdp, expert_parallel=ep)
            assert as_tuples(ts) == as_tuples(js), tag
            assert as_tuples(t_zero1(ts, tp, mesh)) == \
                as_tuples(j_zero1(js, jp, mesh)), tag


def _sds(shape, dtype=np.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _meta(shape):
    return torch.empty(shape, device="meta")


def input_trees(arch, b=16, s=4096):
    """(name, JAX tree, port tree) of model inputs at published width."""
    tc = T_REGISTRY[arch]
    jc = j_config(tc)
    d = tc.d_model
    out = []
    for name, shp in (("tokens", {"tokens": (b, s), "labels": (b, s),
                                  "positions": (b, s)}),
                      ("embeds", {"embeds": (b, s, d),
                                  "positions": (3, b, s)}),
                      ("one-row", {"tokens": (1, s), "labels": (1, 1)})):
        out.append((name, {k: _sds(v) for k, v in shp.items()},
                    {k: _meta(v) for k, v in shp.items()}))
    enc = s if tc.family == "audio" else 0
    dense = (JT.make_cache(jc, b, s, enc_len=enc, factory=_sds),
             TT.make_cache(tc, b, s, enc_len=enc, device="meta"))
    out.append(("dense-cache", {"cache": dense[0], "cache_index": _sds(())},
                {"cache": dense[1], "cache_index": _meta(())}))
    for kv in ("fp", "int8"):
        kw = dict(page_size=16, num_blocks=b * s // 16 - 1, kv_dtype=kv)
        out.append((f"paged-{kv}",
                    {"cache": JT.make_paged_cache(jc, b, s, factory=_sds,
                                                  **kw)},
                    {"cache": TT.make_paged_cache(tc, b, s, device="meta",
                                                  **kw)}))
    return out


INPUT_ARCHS = ("yi-6b", "gemma2-9b", "jamba-1.5-large-398b", "xlstm-125m",
               "whisper-base", "qwen2-vl-72b")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", INPUT_ARCHS)
def test_input_specs_equal_jax(arch, mesh_name):
    mesh = duck_mesh(mesh_name)
    for name, jt, tt in input_trees(arch):
        assert jax.tree.map(lambda x: tuple(x.shape), jt) == \
            jax.tree.map(lambda x: tuple(x.shape), tt), name
        got = as_tuples(TS.input_specs_tree(tt, mesh))
        assert got == as_tuples(JS.input_specs_tree(jt, mesh)), \
            f"{arch} {mesh_name} {name}"


def test_port_mesh_gives_the_duck_meshes_specs():
    _, tp = shapes("qwen2-moe-a2.7b")
    for multi_pod, name in ((False, "16x16"), (True, "2x16x16")):
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=["meta"] * n)
        for kw in ({}, {"fsdp": True, "expert_parallel": True}):
            assert as_tuples(TS.param_specs(tp, mesh, **kw)) == \
                as_tuples(TS.param_specs(tp, duck_mesh(name), **kw))
        shard = TS.param_shardings(tp, mesh)
        assert shard["embed"]["table"].mesh is mesh
        assert shard["embed"]["table"].spec == \
            TS.param_specs(tp, mesh)["embed"]["table"]


def test_group_axis_entries_appear_where_jax_sets_them():
    """The stacked layout matters: FSDP on a stack's 2-d (G, d) leaf and
    ZeRO-1 on a (G, ...) leaf shard the group axis when it divides."""
    from repro.sharding.rules import _fsdp_extend as j_fsdp
    from repro_torch.sharding.rules import _fsdp_extend as t_fsdp
    _, tp = shapes("yi-6b")               # 32 groups
    mesh = duck_mesh("16x16")
    for shp in ((32, 100), (32, 4096), (32, 100, 7)):
        got = t_fsdp(P(*([None] * len(shp))), shp, mesh)
        assert tuple(got) == tuple(j_fsdp(JP(*([None] * len(shp))),
                                          _sds(shp), mesh)), shp
    assert tuple(t_fsdp(P(None, None), (32, 100), mesh)) == ("data", None)
    z = t_zero1(TS.param_specs(tp, mesh), tp, mesh)
    assert tuple(z["stack"]["b0"]["norm1"]["scale"]) == ("data", None)
    assert tuple(z["stack"]["b0"]["mixer"]["wq"]) == ("data", None, "model")


def test_partition_spec_normalizes_as_jax():
    for entries in ((("data",), None), ((), "model"),
                    (("pod", "data"), None, "model"), ()):
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P("data", None) == ("data", None)
    assert repr(P("data")) == "PartitionSpec('data',)"


def test_input_shardings_tree_pairs_mesh_and_spec():
    mesh = duck_mesh("4x2")
    tree = {"tokens": _meta((8, 16))}
    sh = TS.input_shardings_tree(tree, mesh)
    assert sh["tokens"].mesh is mesh
    assert tuple(sh["tokens"].spec) == ("data", None)
    assert TS.batch_axes_for(duck_mesh("2x16x16"), 2) == ("pod",)
    assert TS.batch_axes_for(duck_mesh("2x16x16"), 1) is None


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    m3 = duck_mesh("2x16x16")
    m2 = duck_mesh("4x2")
    R = Replicate()
    cases = ((P(None, "model"), m2, [R, Shard(1)]),
             (P("data", None), m2, [Shard(0), R]),
             (P(None, None), m2, [R, R]),
             (P(), m3, [R, R, R]),
             (P(("pod", "data"), None, "model"), m3,
              [Shard(0), Shard(0), Shard(2)]),
             (P(None, ("data", "model")), m3, [R, Shard(1), Shard(1)]),
             (P("model", "pod"), m3, [Shard(1), R, Shard(0)]))
    for spec, mesh, want in cases:
        assert TS.placements(spec, mesh) == want, spec
    with pytest.raises(ValueError, match="not on the mesh"):
        TS.placements(P("pod"), m2)
    with pytest.raises(ValueError, match="twice"):
        TS.placements(P("data", "data"), m2)
