"""Structured span tracing with Chrome-trace export.

Port of `repro.telemetry.tracing` (the port's own copy).

`span(name, **args)` is a context manager that records one "complete"
event (Chrome trace phase ``X``) with microsecond start/duration; nested
spans on the same thread render as a flame stack in ``chrome://tracing``
or Perfetto because the viewer nests by time containment per
(pid, tid).  `instant(name, **args)` drops a zero-duration marker
(phase ``i``) — used for admission / rebucket / eviction decisions that
have no meaningful duration but should be visible on the timeline next
to the slice spans that surround them.

Like the metrics registry, recording is thread-safe (the driver's
scheduler loop, the `CheckpointWriter` daemon thread, and the caller's
thread all emit concurrently) and the disabled path never reaches this
module — `repro_torch.telemetry.span` returns a shared null context after a
single bool check.

The export format is the Chrome Trace Event JSON object form::

    {"traceEvents": [{"name": ..., "ph": "X", "ts": ..., "dur": ...,
                      "pid": ..., "tid": ..., "args": {...}}, ...],
     "displayTimeUnit": "ms"}

Timestamps come from ``time.perf_counter`` relative to tracer creation,
so a trace always starts near t=0 regardless of process uptime.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager


class Tracer:
    """In-memory Chrome-trace event buffer.

    >>> tr = Tracer()
    >>> with tr.span("outer"):
    ...     with tr.span("inner", k=3):
    ...         tr.instant("mark")
    >>> [e["name"] for e in sorted(tr.events, key=lambda e: e["ts"])]
    ['outer', 'inner', 'mark']
    >>> tr.to_chrome()["traceEvents"][0]["ph"] in ("X", "i")
    True
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _record(self, event: dict) -> None:
        with self._lock:
            self.events.append(event)

    @contextmanager
    def span(self, name: str, **args):
        """Record a complete event covering the with-block's duration."""
        tid = threading.get_ident()
        ts = self.now_us()
        try:
            yield
        finally:
            dur = self.now_us() - ts
            ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                  "pid": self._pid, "tid": tid}
            if args:
                ev["args"] = args
            self._record(ev)

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (thread-scoped instant event)."""
        ev = {"name": name, "ph": "i", "s": "t", "ts": self.now_us(),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._record(ev)

    # -- export -----------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome Trace Event JSON object (loadable as-is)."""
        with self._lock:
            events = sorted(self.events, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write the trace to `path`; returns the path for chaining."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=float)
        return path

    def span_names(self) -> list[str]:
        with self._lock:
            return sorted({e["name"] for e in self.events})

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self._t0 = time.perf_counter()

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)
