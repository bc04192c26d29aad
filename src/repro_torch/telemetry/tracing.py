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

Every event records its parent, the innermost span open on the same
thread when it started, under ``args["parent"]`` (none at the top
level), and `summary()` gives each span name's count, total and self
time: a span's duration less the time its child spans cover.

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
    >>> [e["args"]["parent"] for e in tr.events if e["name"] != "outer"]
    ['inner', 'outer']
    >>> sorted(tr.summary())
    ['inner', 'outer']
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self._totals: dict[str, list] = {}     # name -> [count, us, self us]
        self._open = threading.local()         # this thread's open spans
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> list:
        """[name, us its children covered] of this thread's open spans."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _record(self, event: dict, self_us: float | None = None) -> None:
        with self._lock:
            self.events.append(event)
            if self_us is not None:
                tot = self._totals.setdefault(event["name"], [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += event["dur"]
                tot[2] += self_us

    @contextmanager
    def span(self, name: str, **args):
        """Record a complete event covering the with-block's duration.
        Yields the event's args dict: what the block adds to it is
        recorded with the event."""
        stack = self._stack()
        if stack:
            args["parent"] = stack[-1][0]
        frame = [name, 0.0]
        stack.append(frame)
        tid = threading.get_ident()
        ts = self.now_us()
        try:
            yield args
        finally:
            dur = self.now_us() - ts
            stack.pop()
            if stack:
                stack[-1][1] += dur
            ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                  "pid": self._pid, "tid": tid}
            if args:
                ev["args"] = args
            self._record(ev, self_us=dur - frame[1])

    def instant(self, name: str, **args) -> None:
        """Record a zero-duration marker (thread-scoped instant event)."""
        stack = self._stack()
        if stack:
            args["parent"] = stack[-1][0]
        ev = {"name": name, "ph": "i", "s": "t", "ts": self.now_us(),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._record(ev)

    def summary(self) -> dict[str, tuple[int, float, float]]:
        """{span name: (count, total us, self us)}, where a span's self
        time is its duration less the time its child spans cover."""
        with self._lock:
            return {n: tuple(v) for n, v in self._totals.items()}

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
            self._totals.clear()
            self._t0 = time.perf_counter()

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)
