"""The port's copy of the SSR search (``repro_torch.core``) against the JAX
package's ``repro.core``.

Both copies build the layer graph of the same config (the reduced yi-6b,
the reduced jamba dense-FFN hybrid, and yi-6b at its published width) at a
prefill and a decode shape, and run the search at fixed seeds: the graphs
must be equal node by node, and ``evolutionary_search``, ``ssr_dse``,
``exhaustive_search`` (on a small graph), ``simulate``,
``strategy_points``, ``pareto_front`` and ``best_under_latency`` must give
the same layer-to-accelerator maps, the same accelerator configs, and
latency and throughput within 1e-12 relative.  The copies are the same
Python code, so anything less than equality is a copying fault (a changed
iteration order of a dict or a set, or a changed draw from
``random.Random``).  The port's H100 ``Chip`` must be in ``CHIPS`` with
every constant finite and positive.
"""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

from repro import core as J  # noqa: E402
from repro.configs import REGISTRY as J_REGISTRY  # noqa: E402
from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core.assignment import \
    contiguous_assignment as j_contiguous  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.assignment import \
    contiguous_assignment as t_contiguous  # noqa: E402
from repro_torch.core.hw import CHIPS, H100  # noqa: E402

REL = 1e-12


def _configs(name):
    if name == "yi-6b-reduced":
        return (j_reduced(J_REGISTRY["yi-6b"], layers=4),
                t_reduced(T_REGISTRY["yi-6b"], layers=4))
    if name == "yi-6b":
        return J_REGISTRY["yi-6b"], T_REGISTRY["yi-6b"]
    from test_torch_model import hybrid_configs
    return hybrid_configs(layers=16)


SHAPES = {"prefill": ("serve", 1024, 8, "prefill"),
          "decode": ("decode", 1024, 8, "decode")}
CASES = [(c, s) for c in ("yi-6b-reduced", "hybrid", "yi-6b")
         for s in SHAPES]


def graphs(cfg_name, shape):
    jc, tc = _configs(cfg_name)
    return (J.build_graph(jc, JShape(*SHAPES[shape])),
            P.build_graph(tc, TShape(*SHAPES[shape])))


def close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def same_assignment(ja, ta):
    assert ja.acc_of == ta.acc_of
    assert [dataclasses.astuple(a) for a in ja.accs] == \
        [dataclasses.astuple(a) for a in ta.accs]


def same_result(jr, tr):
    same_assignment(jr.assignment, tr.assignment)
    assert close(jr.latency, tr.latency)
    assert close(jr.throughput, tr.throughput)
    assert jr.evaluations == tr.evaluations
    assert [e for e, _ in jr.history] == [e for e, _ in tr.history]
    assert all(close(a, b) for (_, a), (_, b) in zip(jr.history,
                                                     tr.history))


@pytest.mark.parametrize("cfg_name,shape", CASES)
def test_graphs_equal(cfg_name, shape):
    jg, tg = graphs(cfg_name, shape)
    assert [dataclasses.asdict(n) for n in jg.nodes] == \
        [dataclasses.asdict(n) for n in tg.nodes]
    assert jg.train == tg.train
    assert close(jg.total_mm_flops, tg.total_mm_flops)


@pytest.mark.parametrize("cfg_name,shape", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_evolutionary_search_equal(cfg_name, shape, seed):
    jg, tg = graphs(cfg_name, shape)
    kw = dict(n_acc=2, n_batches=2, n_pop=6, n_child=6, n_iter=3,
              seed=seed)
    same_result(J.evolutionary_search(jg, 8, **kw),
                P.evolutionary_search(tg, 8, **kw))


@pytest.mark.parametrize("cfg_name,shape", CASES)
def test_ssr_dse_and_simulate_equal(cfg_name, shape):
    jg, tg = graphs(cfg_name, shape)
    for n_acc, n_batches in ((2, 2), (3, 4)):
        ja = j_contiguous(jg, n_acc, 8)
        ta = t_contiguous(tg, n_acc, 8)
        same_assignment(ja, ta)
        jl, jt, jass = J.ssr_dse(jg, ja.acc_of, 8, n_batches=n_batches)
        tl, tt, tass = P.ssr_dse(tg, ta.acc_of, 8, n_batches=n_batches)
        same_assignment(jass, tass)
        assert close(jl, tl) and close(jt, tt)
        jr = J.simulate(jg, jass, n_batches)
        tr = P.simulate(tg, tass, n_batches)
        assert close(jr.latency, tr.latency)
        assert close(jr.makespan, tr.makespan)
        assert close(jr.throughput_flops, tr.throughput_flops)
        assert all(close(a, b) for a, b in zip(jr.per_acc_busy,
                                               tr.per_acc_busy))


def test_exhaustive_search_equal_on_a_small_graph():
    jg, tg = graphs("yi-6b-reduced", "prefill")
    kw = dict(n_acc=3, n_batches=2)
    same_result(J.exhaustive_search(jg, 8, **kw),
                P.exhaustive_search(tg, 8, **kw))


@pytest.mark.parametrize("cfg_name", ["yi-6b-reduced", "hybrid", "yi-6b"])
def test_strategy_points_pareto_front_and_best_under_latency_equal(
        cfg_name):
    jg, tg = graphs(cfg_name, "prefill")
    kw = dict(batches=(1, 2), hybrid_accs=(2, 3), ea_iters=2, seed=0)
    jp = J.strategy_points(jg, 8, **kw)
    tp = P.strategy_points(tg, 8, **kw)

    def key(p):
        return (p.strategy, p.n_acc, p.n_batches, p.detail, p.source)
    assert [key(p) for p in jp] == [key(p) for p in tp]
    for a, b in zip(jp, tp):
        assert close(a.latency, b.latency)
        assert close(a.throughput_tops, b.throughput_tops)
    jf, tf = J.pareto_front(jp), P.pareto_front(tp)
    assert [key(p) for p in jf] == [key(p) for p in tf]
    lat = sorted(p.latency for p in jp)[len(jp) // 2]
    for strategy in (None, "sequential", "hybrid"):
        jb = J.best_under_latency(jp, lat, strategy)
        tb = P.best_under_latency(tp, lat, strategy)
        assert key(jb) == key(tb)
        assert close(jb.throughput_tops, tb.throughput_tops)


def test_h100_chip_is_in_chips_with_card_constants():
    assert CHIPS["h100-sxm"] is H100
    for f in dataclasses.fields(H100):
        v = getattr(H100, f.name)
        if isinstance(v, float):
            assert math.isfinite(v) and v > 0, f.name
    assert H100.peak_flops == 989e12 and H100.hbm_bw == 3.35e12
    assert H100.tile == 64 and 0.5 < H100.max_eff < 0.7
    # the JAX package's chips come across unchanged
    for name, chip in J.CHIPS.items():
        assert dataclasses.astuple(CHIPS[name]) == dataclasses.astuple(chip)


def test_search_on_the_h100_gives_a_different_finite_plan_cost():
    """The same search priced on the H100 instead of the default chip:
    finite, and not the TPU's numbers."""
    _, tg = graphs("yi-6b", "prefill")
    acc_of = t_contiguous(tg, 2, 8).acc_of
    tl, tt, _ = P.ssr_dse(tg, acc_of, 8, n_batches=2)
    hl, ht, _ = P.ssr_dse(tg, acc_of, 8, n_batches=2, hw=H100)
    assert math.isfinite(hl) and math.isfinite(ht) and hl > 0
    assert hl != tl and ht != tt


VIT_CASES = [(name, b, chip) for name in ("deit-t", "deit-160", "deit-256",
                                          "lv-vit-t")
             for b in (1, 3, 6) for chip in ("vck190", "h100-sxm")]


@pytest.mark.parametrize("name,batch,chip", VIT_CASES)
def test_paper_vit_graphs_simulate_and_strategy_points_equal(name, batch,
                                                             chip):
    """The paper's ViTs at ``vit_shape(1, 3, 6)`` on the VCK190 and the
    H100: block- and op-granularity graphs, ``simulate`` of the sequential
    (one accelerator of 1 and of 8 chips) and spatial assignments, and
    ``strategy_points``, equal to JAX's on JAX's configs."""
    from repro.configs import PAPER_MODELS as J_PAPER
    from repro.configs import vit_shape as j_vit_shape
    from repro_torch.configs import PAPER_MODELS as T_PAPER
    from repro_torch.configs import vit_shape as t_vit_shape
    from repro.core.hw import Chip as JChip
    jc, tc = J_PAPER[name], T_PAPER[name]
    # the H100 is the port's own chip: JAX prices it from the same fields
    thw = CHIPS[chip]
    jhw = J.CHIPS.get(chip) or JChip(**dataclasses.asdict(thw))
    for gran in ("block", "op"):
        jg = J.build_graph(jc, j_vit_shape(batch), granularity=gran)
        tg = P.build_graph(tc, t_vit_shape(batch), granularity=gran)
        assert [dataclasses.asdict(n) for n in jg.nodes] == \
            [dataclasses.asdict(n) for n in tg.nodes]
        for ja, ta in ((J.sequential_assignment(jg, 1),
                        P.sequential_assignment(tg, 1)),
                       (J.sequential_assignment(jg, 8),
                        P.sequential_assignment(tg, 8)),
                       (J.spatial_assignment(jg, 8),
                        P.spatial_assignment(tg, 8))):
            same_assignment(ja, ta)
            jr = J.simulate(jg, ja, batch, hw=jhw)
            tr = P.simulate(tg, ta, batch, hw=thw)
            assert close(jr.latency, tr.latency)
            assert close(jr.makespan, tr.makespan)
            assert close(jr.throughput_flops, tr.throughput_flops)
    kw = dict(hw=jhw, batches=(1, batch), hybrid_accs=(2, 3), ea_iters=2,
              seed=0)
    jp = J.strategy_points(jg, 8, **kw)
    tp = P.strategy_points(tg, 8, **dict(kw, hw=thw))
    assert [(p.strategy, p.n_acc, p.n_batches, p.detail, p.source)
            for p in jp] == [(p.strategy, p.n_acc, p.n_batches, p.detail,
                              p.source) for p in tp]
    for a, b in zip(jp, tp):
        assert close(a.latency, b.latency)
        assert close(a.throughput_tops, b.throughput_tops)
