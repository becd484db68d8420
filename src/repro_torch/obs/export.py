"""Exporters: Chrome/Perfetto trace-event JSON and Prometheus text files.

The Perfetto exporter maps tracer tracks onto one process with a named
thread per track — ``prefill stage j`` and ``decode replica r`` render
as parallel timelines in ui.perfetto.dev — and emits B/E pairs from the
tracer's *complete* span records, so every ``B`` has an ``E`` by
construction.  Request flows (admission → retirement) become ``s``/``f``
flow events keyed by request uid.

``validate_perfetto`` is the same check CI runs on the smoke artifact:
structural well-formedness, balanced B/E per thread, and flow-id
resolution.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

PID = 1
_TID_TICK = 1
_TID_REQUESTS = 2
_TID_STAGE0 = 10
_TID_REPLICA0 = 100
_TID_OTHER0 = 1000


def _track_tid(track: Any, other: Dict[str, int]) -> Tuple[int, str]:
    """Map a tracer track to a stable (tid, display name)."""
    if track == "tick":
        return _TID_TICK, "engine"
    if track == "requests":
        return _TID_REQUESTS, "requests"
    if isinstance(track, tuple) and len(track) == 2:
        kind, idx = track
        if kind == "stage":
            return _TID_STAGE0 + int(idx), f"prefill stage {idx}"
        if kind == "replica":
            return _TID_REPLICA0 + int(idx), f"decode replica {idx}"
    name = str(track)
    if name not in other:
        other[name] = _TID_OTHER0 + len(other)
    return other[name], name


def perfetto_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """Convert retained tracer records into trace_event dicts."""
    events: List[Dict[str, Any]] = []
    other: Dict[str, int] = {}
    seen_tids: Dict[int, str] = {}
    t0 = tracer.t0

    def us(t: float) -> float:
        return (t - t0) * 1e6

    for rec in tracer.records():
        kind = rec[0]
        if kind == "X":
            _, track, name, ts0, ts1, args, flow_out, flow_in = rec
            tid, tname = _track_tid(track, other)
            seen_tids.setdefault(tid, tname)
            base = {"pid": PID, "tid": tid, "name": name, "cat": "serving"}
            events.append({**base, "ph": "B", "ts": us(ts0), "args": args or {}})
            events.append({**base, "ph": "E", "ts": us(ts1)})
            mid = us((ts0 + ts1) / 2.0)
            if flow_out is not None:
                events.append({"ph": "s", "pid": PID, "tid": tid, "ts": mid,
                               "id": str(flow_out), "cat": "request", "name": "req"})
            if flow_in is not None:
                events.append({"ph": "f", "bp": "e", "pid": PID, "tid": tid,
                               "ts": mid, "id": str(flow_in), "cat": "request",
                               "name": "req"})
        elif kind == "I":
            _, track, name, ts, args = rec
            tid, tname = _track_tid(track, other)
            seen_tids.setdefault(tid, tname)
            events.append({"ph": "i", "pid": PID, "tid": tid, "ts": us(ts),
                           "name": name, "cat": "serving", "s": "t",
                           "args": args or {}})
        elif kind == "C":
            _, track, name, ts, values = rec
            tid, tname = _track_tid(track, other)
            seen_tids.setdefault(tid, tname)
            events.append({"ph": "C", "pid": PID, "tid": tid, "ts": us(ts),
                           "name": name, "args": dict(values)})
        elif kind == "F":
            _, track, phase, fid, ts = rec
            tid, tname = _track_tid(track, other)
            seen_tids.setdefault(tid, tname)
            ev = {"ph": phase, "pid": PID, "tid": tid, "ts": us(ts),
                  "id": str(fid), "cat": "request", "name": "req"}
            if phase == "f":
                ev["bp"] = "e"
            events.append(ev)

    events.sort(key=lambda e: e["ts"])
    meta: List[Dict[str, Any]] = [
        {"ph": "M", "pid": PID, "tid": 0, "name": "process_name",
         "args": {"name": "repro-serving"}},
    ]
    for tid in sorted(seen_tids):
        meta.append({"ph": "M", "pid": PID, "tid": tid, "name": "thread_name",
                     "args": {"name": seen_tids[tid]}})
        meta.append({"ph": "M", "pid": PID, "tid": tid, "name": "thread_sort_index",
                     "args": {"sort_index": tid}})
    return meta + events


def to_perfetto(tracer: Tracer) -> Dict[str, Any]:
    return {
        "traceEvents": perfetto_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": {"dropped_records": tracer.dropped,
                      "total_records": tracer.events},
    }


def write_trace(tracer: Tracer, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_perfetto(tracer), f)


def write_metrics(reg: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        f.write(reg.to_prometheus())


def validate_perfetto(obj: Any, require_names: Sequence[str] = ()) -> List[str]:
    """Structural validation of a Perfetto trace_event JSON object.

    Returns a list of problems (empty = valid): top-level shape, every
    ``B`` matched by an ``E`` on its thread (names must pair up), every
    flow-finish ``f`` id resolved by a flow-start ``s``, and — when
    ``require_names`` is given — presence of each required event name.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        return ["top-level object must be a dict with a traceEvents list"]
    events = obj["traceEvents"]
    stacks: Dict[Tuple[int, int], List[str]] = {}
    flow_s: set = set()
    flow_f: set = set()
    names: set = set()
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            problems.append(f"event {i}: not a dict with a ph field")
            continue
        ph = e["ph"]
        if ph != "M" and not isinstance(e.get("ts"), (int, float)):
            problems.append(f"event {i} ({ph}): missing numeric ts")
            continue
        names.add(e.get("name"))
        key = (e.get("pid", 0), e.get("tid", 0))
        if ph == "B":
            stacks.setdefault(key, []).append(e.get("name", ""))
        elif ph == "E":
            st = stacks.setdefault(key, [])
            if not st:
                problems.append(f"event {i}: E without open B on pid/tid {key}")
            else:
                top = st.pop()
                if e.get("name") and e["name"] != top:
                    problems.append(
                        f"event {i}: E name {e['name']!r} does not close B {top!r}")
        elif ph == "s":
            flow_s.add(e.get("id"))
        elif ph == "f":
            flow_f.add(e.get("id"))
    for key, st in stacks.items():
        if st:
            problems.append(f"unclosed B events on pid/tid {key}: {st}")
    unresolved = flow_f - flow_s
    if unresolved:
        problems.append(f"flow finish ids without a start: {sorted(unresolved)[:8]}")
    for name in require_names:
        if name not in names:
            problems.append(f"required event name missing: {name!r}")
    return problems
