"""The port's observability: ``repro_torch.obs`` against the JAX package's
``repro.obs`` on the same inputs, and the engine's tracer, metrics and
utilization views.

The copies must give what ``repro.obs`` gives for one scripted sequence
of spans, instants, counters and flows (equal ``to_perfetto`` objects,
``validate_perfetto`` findings and ``utilization_from_trace`` views),
for one sequence of metric observations (equal Prometheus text, also
after ``fold_engine_metrics``), and on a wrapping ring (equal retained
records and drop counts).  In the engine (monolithic and plan-driven,
dense and paged, sync and overlapped): traced streams equal untraced
ones, ``trace=None`` pushes no record, spans carry their stage, replica
and request tags, ``traffic_snapshot`` is None when idle and typed after,
``export_metrics`` is idempotent, and the launcher's ``--overlap
--trace --metrics-out`` write files that validate.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.obs as J  # noqa: E402
import repro_torch.obs as O  # noqa: E402
import repro_torch.obs.trace as trace_mod  # noqa: E402
from repro.obs.derive import utilization_from_trace as j_util  # noqa: E402
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs.derive import utilization_from_trace  # noqa: E402
from repro_torch.plan import lower_serving, uniform_plan  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


def script_trace(mod, capacity=1 << 16):
    """One fixed sequence of every record kind on every track kind."""
    tr = mod.Tracer(capacity)
    tr.t0 = 100.0
    tr.counter("tick", "engine", {"queue": 2, "active": 0}, t=100.001)
    tr.instant("requests", "submit", t=100.0005, args={"uid": 7})
    tr.span("tick", "admission", 100.001, 100.004, args={"queued": 2})
    tr.span(("stage", 0), "prefill_chunk", 100.002, 100.003,
            args={"tokens": 4, "chunk": 0})
    tr.span(("stage", 1), "prefill_chunk", 100.003, 100.0035)
    tr.span("requests", "admit", 100.004, 100.004, flow_out=7)
    tr.span(("replica", 0), "decode_dispatch", 100.005, 100.006)
    tr.span(("replica", 1), "decode", 100.005, 100.0075)
    tr.span("tick", "drain", 100.007, 100.008, args={"inflight": 1})
    tr.span("requests", "retire", 100.009, 100.009, flow_in=7)
    tr.span("custom-track", "misc", 100.0095, 100.0097)
    tr.flow("requests", "s", 9, t=100.0098)
    tr.flow(("replica", 1), "f", 9, t=100.0099)
    tr.instant(("stage", 1), "commit", t=100.0099, args={"slot": 1})
    return tr


def script_metrics(mod):
    reg = mod.MetricsRegistry()
    reg.counter("repro_requests_total", help="requests").inc(3)
    reg.gauge("repro_occ", stage="0").set(0.5)
    reg.gauge("repro_occ", stage="1").set(0.25)
    h = reg.histogram("repro_ttft_seconds", mod.TTFT_BUCKETS, help="ttft")
    for v in (0.0004, 0.003, 0.03, 0.3, 3.0, 30.0):
        h.observe(v)
    reg.histogram("repro_tpot_seconds", mod.TPOT_BUCKETS).observe(0.02)
    return reg


STATS = {"throughput_tok_s": 12.5, "slot_occupancy": 0.75,
         "tokens_per_step": 1.0, "ticks": 9,
         "phase_time_s": {"admission": 0.01, "prefill": 0.2, "decode": 0.5,
                          "idle": 0.0, "host_sync": 0.1},
         "utilization": {"stage_bubble_frac": {0: 0.25, 1: 0.5},
                         "replica_occupancy": {0: 0.5, 1: 0.75},
                         "replica_load_spread": 0.25,
                         "spec_acceptance_rate": 0.0,
                         "prefix_hit_rate": 0.5},
         "cache": {"blocks_in_use": 3, "peak_blocks_in_use": 7,
                   "kv_capacity_x": 1.0}}


def test_perfetto_export_and_validation_equal_jax():
    obj, jobj = O.to_perfetto(script_trace(O)), J.to_perfetto(
        script_trace(J))
    assert obj == jobj
    names = ("admission", "prefill_chunk", "decode", "admit", "retire",
             "submit", "drain", "decode_dispatch")
    assert O.validate_perfetto(obj, require_names=names) == \
        J.validate_perfetto(jobj, require_names=names) == []
    bad = {"traceEvents": [{"ph": "B", "ts": 1, "pid": 1, "tid": 2,
                            "name": "x"},
                           {"ph": "f", "ts": 2, "id": "4"}, {"ts": 3}]}
    assert O.validate_perfetto(bad, ("y",)) == \
        J.validate_perfetto(bad, ("y",))
    assert len(O.validate_perfetto(bad, ("y",))) == 4
    assert O.validate_perfetto([]) == J.validate_perfetto([])


def test_utilization_from_trace_equals_jax():
    got = utilization_from_trace(script_trace(O))
    assert got == j_util(script_trace(J))
    assert set(got["stage_busy_s"]) == {0, 1}
    assert set(got["replica_busy_frac"]) == {0, 1}
    assert O.utilization_from_trace(O.Tracer())["window_s"] == 0.0


def test_prometheus_text_equals_jax():
    reg, jreg = script_metrics(O), script_metrics(J)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    O.fold_engine_metrics(reg, STATS)
    J.fold_engine_metrics(jreg, STATS)
    txt = reg.to_prometheus()
    assert txt == jreg.to_prometheus()
    assert 'repro_ttft_seconds_bucket{le="+Inf"} 6' in txt
    assert 'repro_stage_bubble_frac{stage="1"} 0.5' in txt
    reg.reset()
    jreg.reset()
    assert reg.to_prometheus() == jreg.to_prometheus()
    with pytest.raises(ValueError):
        reg.gauge("repro_requests_total")
    with pytest.raises(ValueError):
        reg.counter("repro_requests_total").inc(-1)
    with pytest.raises(ValueError):
        O.Histogram((1.0, 0.5))


@pytest.mark.parametrize("capacity", [1, 4, 13, 64])
def test_ring_wrap_and_drops_equal_jax(capacity):
    tr, jtr = script_trace(O, capacity), script_trace(J, capacity)
    assert tr.records() == jtr.records()
    assert (tr.events, tr.dropped) == (jtr.events, jtr.dropped)
    assert tr.dropped == max(0, 14 - capacity)
    assert O.to_perfetto(tr) == J.to_perfetto(jtr)
    tr.clear()
    assert tr.events == 0 and tr.records() == []
    with pytest.raises(ValueError):
        tr.flow("tick", "x", 1)
    with pytest.raises(ValueError):
        O.Tracer(capacity=0)


def test_traffic_snapshot_type_matches_jax():
    kw = dict(lam=2.0, avg_prompt=5.0, avg_new=6.0, queued_tok=0.0,
              depth=3.0, queue_len=0, active=1, violated=False, window_s=1.0)
    import dataclasses
    assert dataclasses.asdict(O.TrafficSnapshot(**kw)) == \
        dataclasses.asdict(J.TrafficSnapshot(**kw))
    assert [f.name for f in dataclasses.fields(O.TrafficSnapshot)] == \
        [f.name for f in dataclasses.fields(J.TrafficSnapshot)]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = reduced(REGISTRY["yi-6b"], layers=2)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def _plan(cfg, slots=2, chunk=4):
    return lower_serving(uniform_plan(cfg.num_groups, 2, n_microbatches=2),
                         slots=slots, chunk=chunk)


def _drive(eng, n=3, new_tokens=4):
    for i in range(n):
        eng.submit(Request(i, np.arange(1, 7 + i, dtype=np.int32),
                           new_tokens))
    eng.run()
    return [list(r.out_tokens) for r in sorted(eng.done, key=lambda r: r.uid)]


MODES = ["mono-dense", "mono-paged", "plan-dense", "plan-paged"]


def _kw(cfg, mode):
    kw = {}
    if mode.startswith("plan"):
        kw["plan"] = _plan(cfg)
    if mode.endswith("paged"):
        kw.update(paged=True, page_size=4)
    return kw


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_tracing_is_noop_off_and_parity_preserving_on(setup, mode, overlap,
                                                      tmp_path):
    cfg, model, params = setup
    kw = dict(_kw(cfg, mode), overlap=overlap)
    before = trace_mod.RECORDS_TOTAL
    gold = _drive(ServingEngine(model, params, slots=2, max_seq=48, **kw))
    assert trace_mod.RECORDS_TOTAL == before, (
        "a trace=None engine pushed trace records")
    eng = ServingEngine(model, params, slots=2, max_seq=48,
                        trace=O.TraceConfig(), **kw)
    assert _drive(eng) == gold, f"{mode}: traced streams diverged"
    assert trace_mod.RECORDS_TOTAL > before and eng._tr.dropped == 0
    obj = O.to_perfetto(eng._tr)
    names = ("prefill_chunk" if "plan" in mode else "prefill", "admit",
             "retire", "submit", "admission")
    names += ("decode_dispatch", "drain") if overlap else ("decode",)
    assert not O.validate_perfetto(obj, require_names=names)
    path = tmp_path / "t.json"
    eng.write_trace(str(path))
    assert not O.validate_perfetto(json.loads(path.read_text()),
                                   require_names=names)


def test_trace_spans_carry_stage_replica_and_request_tags(setup):
    cfg, model, params = setup
    eng = ServingEngine(model, params, slots=2, max_seq=48,
                        plan=_plan(cfg), paged=True, page_size=4, trace=True)
    _drive(eng)
    recs = eng._tr.records()
    chunks = [r for r in recs if r[0] == "X" and r[2] == "prefill_chunk"]
    assert {r[1] for r in chunks} == {("stage", 0), ("stage", 1)}
    assert {r[5]["uid"] for r in chunks} == {0, 1, 2}
    assert all({"slot", "replica", "chunk", "tokens", "cont"} <= set(r[5])
               for r in chunks)
    dec = [r for r in recs if r[0] == "X" and r[2] == "decode"]
    assert {r[1] for r in dec} == {("replica", 0), ("replica", 1)}
    assert all(r[5]["plan"] == eng.plan.label for r in dec)
    admits = [r for r in recs if r[0] == "X" and r[2] == "admit"]
    retires = [r for r in recs if r[0] == "X" and r[2] == "retire"]
    assert sorted(r[6] for r in admits) == [0, 1, 2]      # flow out = uid
    assert sorted(r[7] for r in retires) == [0, 1, 2]     # flow in = uid
    assert all(r[6] == r[5]["uid"] for r in admits)
    commits = [r for r in recs if r[0] == "I" and r[2] == "commit"]
    assert commits and all(r[1] == "requests" for r in commits)
    util = O.utilization_from_trace(eng._tr)
    assert util["window_s"] > 0
    assert set(util["replica_busy_frac"]) == {0, 1}
    assert set(util["stage_busy_frac"]) == {0, 1}


def test_utilization_stats_present_and_bounded(setup):
    cfg, model, params = setup
    eng = ServingEngine(model, params, slots=2, max_seq=48,
                        plan=_plan(cfg), paged=True, page_size=4,
                        overlap=True)
    _drive(eng)
    u = eng.stats()["utilization"]
    assert u["pipeline_ticks"] > 0
    assert set(u["stage_bubble_frac"]) == {0, 1}
    assert all(0.0 <= v <= 1.0 for v in u["stage_bubble_frac"].values())
    assert set(u["replica_occupancy"]) == {0, 1}
    assert all(0.0 < v <= 1.0 for v in u["replica_occupancy"].values())
    assert 0.0 <= u["replica_load_spread"] <= 1.0
    assert 0.0 <= u["prefix_hit_rate"] <= 1.0
    assert eng.utilization_stats() == u              # a pure read
    mono = ServingEngine(model, params, slots=2, max_seq=48)
    _drive(mono)
    mu = mono.stats()["utilization"]
    assert mu["pipeline_ticks"] == 0 and mu["stage_bubble_frac"] == {}
    assert set(mu["replica_occupancy"]) == {0}
    mono.reset_stats()
    assert mono.utilization_stats()["replica_occupancy"] == {}


def test_traffic_snapshot_is_typed_and_none_when_idle(setup):
    cfg, model, params = setup
    eng = ServingEngine(model, params, slots=2, max_seq=48)
    assert eng.traffic_snapshot(1.0) is None
    eng.submit(Request(9, np.arange(1, 6, dtype=np.int32), 4))
    sig = eng.traffic_snapshot(60.0)
    assert sig.queue_len == 1 and sig.queued_tok == 5.0 and sig.lam > 0
    eng.run()
    _drive(eng)
    sig = eng.traffic_snapshot(60.0, slo_ttft_s=1e-9, slo_tpot_s=1.0)
    assert isinstance(sig, O.TrafficSnapshot)
    assert sig.lam > 0 and sig.avg_prompt > 0 and sig.avg_new == 4.0
    assert sig.window_s == 60.0 and sig.violated
    assert sig.queue_len == 0 and sig.active == 0
    with pytest.raises(Exception):
        sig.lam = 1.0                              # frozen dataclass


def test_export_metrics_and_write_paths(setup, tmp_path):
    cfg, model, params = setup
    eng = ServingEngine(model, params, slots=2, max_seq=48,
                        plan=_plan(cfg), paged=True, page_size=4)
    _drive(eng)
    reg = eng.export_metrics()
    assert {"repro_ttft_seconds", "repro_tpot_seconds",
            "repro_requests_total", "repro_tokens_generated_total",
            "repro_throughput_tok_s", "repro_phase_seconds",
            "repro_stage_bubble_frac", "repro_replica_occupancy",
            "repro_replans_total"} <= set(reg.names())
    a = eng.export_metrics().snapshot()
    assert a == eng.export_metrics().snapshot()       # gauges are set
    assert a["repro_requests_total"] == 3.0
    assert a["repro_tokens_generated_total"] == 12.0
    assert a["repro_ttft_seconds_count"] == 3.0
    assert a["repro_replans_total"] == 0.0
    p = tmp_path / "m.prom"
    O.write_metrics(reg, str(p))
    txt = p.read_text()
    assert txt.endswith("\n") and "repro_ttft_seconds_bucket" in txt
    with pytest.raises(ValueError):
        eng.write_trace(str(tmp_path / "t.json"))
    eng.reset_stats()
    assert eng.metrics.snapshot()["repro_requests_total"] == 0.0
    tr = eng.enable_trace()                   # mid-serve, on the pipeline
    assert eng._pf.tracer is tr
    _drive(eng, n=1)
    eng.write_trace(str(tmp_path / "t.json"))
    obj = json.loads((tmp_path / "t.json").read_text())
    assert not O.validate_perfetto(obj, require_names=("prefill_chunk",
                                                       "retire"))


@pytest.mark.parametrize("plan_args", [
    [], ["--strategy", "pipeline:2", "--replicas", "2", "--chunk", "4"]])
def test_launcher_overlap_trace_and_metrics(monkeypatch, capsys, tmp_path,
                                            plan_args):
    """The launcher's CPU run with ``--overlap --trace --metrics-out`` at
    a reduced width (the registry entry swapped for ``reduced``), then
    with ``--adapt``, which raised before re-planning was ported."""
    monkeypatch.setitem(REGISTRY, "yi-6b", reduced(REGISTRY["yi-6b"]))
    tj, tp = tmp_path / "serve.json", tmp_path / "serve.prom"
    launcher.main(["--device", "cpu", "--layers", "2", "--paged",
                   "--overlap", "--trace", str(tj), "--metrics-out",
                   str(tp), "--requests", "3", "--new-tokens", "4",
                   "--max-seq", "64", *plan_args])
    out = capsys.readouterr().out
    assert "overlap=on" in out and "[serve] 3 requests, 12 tokens" in out
    names = ("prefill_chunk" if plan_args else "prefill", "decode_dispatch",
             "drain", "admit", "retire", "submit")
    assert not O.validate_perfetto(json.loads(tj.read_text()),
                                   require_names=names)
    assert "repro_requests_total 3" in tp.read_text()
    launcher.main(["--device", "cpu", "--layers", "2", "--paged",
                   "--overlap", "--speculate", "4", "--requests", "1",
                   "--new-tokens", "2", "--max-seq", "64", *plan_args])
    assert "overlap=sync(spec)" in capsys.readouterr().out
    launcher.main(["--device", "cpu", "--layers", "2", "--paged", "--adapt",
                   "--requests", "2", "--new-tokens", "3", "--max-seq", "64",
                   "--chunk", "4", *plan_args])
    out = capsys.readouterr().out
    assert "[serve] 2 requests, 6 tokens" in out
    assert ", adapt: replans=" in out and "adapt decisions" in out
