"""Low-overhead engine tracer: ring-buffered, monotonic-clock records.

The tracer stores *complete* records (spans carry both endpoints) in a
fixed-size ring, so exporting can never produce a ``B`` without its
matching ``E`` even after the ring wraps.  All timestamps come from
``time.perf_counter()`` — the same monotonic clock the serving engine
uses for ``phase_time_s`` and request latencies, so trace spans line up
with engine stats by construction.

Record shapes (plain tuples, newest-kept ring):

- ``("X", track, name, t0, t1, args, flow_out, flow_in)`` — a span.
- ``("I", track, name, t, args)`` — an instant event.
- ``("C", track, name, t, values)`` — a counter sample (dict of series).
- ``("F", track, phase, fid, t)`` — a bare flow endpoint (``"s"``/``"f"``).

``track`` is either a string (``"tick"``, ``"requests"``) or a tuple
(``("stage", j)``, ``("replica", r)``); the Perfetto exporter maps each
track to its own named thread so stages and replicas render as parallel
timelines.

The hot path contract: when tracing is disabled the engine holds
``self._tr is None`` and every emission site is guarded, so *zero*
records are created.  ``RECORDS_TOTAL`` below counts every record ever
pushed by any tracer in the process — tests use it as an allocation
probe to pin the no-op fast path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

Track = Union[str, Tuple[str, int]]

# Process-wide record counter.  Incremented on every record pushed into
# any Tracer; an engine running with trace=None must leave it untouched
# (asserted by tests/test_torch_obs.py).
RECORDS_TOTAL = 0


@dataclass(frozen=True)
class TraceConfig:
    """Configuration for engine tracing.

    capacity: ring size in records; oldest records are dropped once the
        ring wraps (``Tracer.dropped`` counts them).
    path: optional output path — callers (CLI, benchmarks) write the
        Perfetto JSON here when the run finishes.
    """

    capacity: int = 1 << 16
    path: Optional[str] = None


class Tracer:
    """Ring-buffered trace-event recorder (monotonic clock)."""

    __slots__ = ("capacity", "_buf", "_idx", "t0")

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = int(capacity)
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._idx = 0
        self.t0 = time.perf_counter()

    # -- clock ---------------------------------------------------------
    @staticmethod
    def now() -> float:
        return time.perf_counter()

    # -- recording -----------------------------------------------------
    def _push(self, rec: tuple) -> None:
        global RECORDS_TOTAL
        RECORDS_TOTAL += 1
        self._buf[self._idx % self.capacity] = rec
        self._idx += 1

    def span(
        self,
        track: Track,
        name: str,
        t0: float,
        t1: Optional[float] = None,
        args: Optional[Dict[str, Any]] = None,
        flow_out: Optional[int] = None,
        flow_in: Optional[int] = None,
    ) -> None:
        """Record a complete span [t0, t1] (t1 defaults to now)."""
        if t1 is None:
            t1 = time.perf_counter()
        self._push(("X", track, name, t0, t1, args, flow_out, flow_in))

    def instant(
        self,
        track: Track,
        name: str,
        t: Optional[float] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        if t is None:
            t = time.perf_counter()
        self._push(("I", track, name, t, args))

    def counter(
        self,
        track: Track,
        name: str,
        values: Dict[str, float],
        t: Optional[float] = None,
    ) -> None:
        if t is None:
            t = time.perf_counter()
        self._push(("C", track, name, t, values))

    def flow(self, track: Track, phase: str, fid: int, t: Optional[float] = None) -> None:
        """Record a bare flow endpoint (phase 's' start / 'f' finish)."""
        if phase not in ("s", "f"):
            raise ValueError(f"flow phase must be 's' or 'f', got {phase!r}")
        if t is None:
            t = time.perf_counter()
        self._push(("F", track, phase, fid, t))

    # -- inspection ----------------------------------------------------
    @property
    def events(self) -> int:
        """Total records ever pushed (including dropped ones)."""
        return self._idx

    @property
    def dropped(self) -> int:
        return max(0, self._idx - self.capacity)

    def records(self) -> List[tuple]:
        """Retained records, oldest first."""
        if self._idx <= self.capacity:
            return [r for r in self._buf[: self._idx]]
        head = self._idx % self.capacity
        return [r for r in self._buf[head:] + self._buf[:head]]

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._idx = 0
