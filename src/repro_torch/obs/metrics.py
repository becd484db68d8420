"""Counters / gauges / histograms with Prometheus text exposition.

A tiny dependency-free metrics substrate: the engine observes request
latencies (TTFT/TPOT histograms) and token counters live, and folds
windowed utilization stats into gauges at export time.  Instances are
keyed by ``(name, sorted-label-items)`` so repeated lookups return the
same object — observation sites can hold a reference and skip the
registry dict on the hot path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Explicit latency buckets (seconds).  TTFT spans sub-ms CPU smoke runs
# up to multi-second cold prefills; TPOT is per-token so sits an order
# of magnitude lower.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = bs
        self.counts = [0] * len(bs)  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                return
        # falls through to the implicit +Inf bucket (count only)

    def reset(self) -> None:
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class MetricsRegistry:
    """Name → labeled metric instances, with Prometheus text export."""

    def __init__(self) -> None:
        # name -> (type, help, buckets-or-None, {label_key: instance})
        self._metrics: Dict[str, Tuple[str, str, Optional[tuple], Dict[LabelKey, object]]] = {}

    def _get(self, kind: str, name: str, help: str, labels: Dict[str, str],
             buckets: Optional[Sequence[float]] = None):
        ent = self._metrics.get(name)
        if ent is None:
            ent = (kind, help, tuple(buckets) if buckets is not None else None, {})
            self._metrics[name] = ent
        elif ent[0] != kind:
            raise ValueError(f"metric {name} already registered as {ent[0]}, not {kind}")
        key = _label_key(labels)
        inst = ent[3].get(key)
        if inst is None:
            if kind == "counter":
                inst = Counter()
            elif kind == "gauge":
                inst = Gauge()
            else:
                inst = Histogram(ent[2] or ())
            ent[3][key] = inst
        return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get("counter", name, help, labels)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get("gauge", name, help, labels)  # type: ignore[return-value]

    def histogram(self, name: str, buckets: Sequence[float], help: str = "",
                  **labels: str) -> Histogram:
        return self._get("histogram", name, help, labels, buckets)  # type: ignore[return-value]

    # -- inspection ----------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, float]:
        """Flat {name{labels}: value} view (histograms as _sum/_count)."""
        out: Dict[str, float] = {}
        for name in sorted(self._metrics):
            kind, _, _, insts = self._metrics[name]
            for key in sorted(insts):
                inst = insts[key]
                ls = _label_str(key)
                if kind == "histogram":
                    out[f"{name}_sum{ls}"] = inst.sum  # type: ignore[union-attr]
                    out[f"{name}_count{ls}"] = float(inst.count)  # type: ignore[union-attr]
                else:
                    out[f"{name}{ls}"] = inst.value  # type: ignore[union-attr]
        return out

    def reset(self) -> None:
        for _, (_, _, _, insts) in self._metrics.items():
            for inst in insts.values():
                inst.reset()  # type: ignore[union-attr]

    # -- export --------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            kind, help, _, insts = self._metrics[name]
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(insts):
                inst = insts[key]
                if kind == "histogram":
                    h: Histogram = inst  # type: ignore[assignment]
                    cum = 0
                    for ub, c in zip(h.buckets, h.counts):
                        cum += c
                        lk = _label_str(key + (("le", _fmt(ub)),))
                        lines.append(f"{name}_bucket{lk} {cum}")
                    lk = _label_str(key + (("le", "+Inf"),))
                    lines.append(f"{name}_bucket{lk} {h.count}")
                    lines.append(f"{name}_sum{_label_str(key)} {_fmt(h.sum)}")
                    lines.append(f"{name}_count{_label_str(key)} {h.count}")
                else:
                    lines.append(f"{name}{_label_str(key)} {_fmt(inst.value)}")  # type: ignore[union-attr]
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
