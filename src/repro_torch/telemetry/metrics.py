"""Process-wide metrics registry: counters, gauges, histograms.

Port of `repro.telemetry.metrics` (the port keeps its own copy: it
imports nothing of the reference).  For the same records,
`snapshot()`, `to_jsonl()` and `to_prometheus()` give the reference's
text.

One `MetricsRegistry` instance (the module default lives in
`repro_torch.telemetry`) holds every labeled series the instrumented
layers emit — scheduler counters from `serving/driver.py`, bucket
decisions from `serving/admission.py`, kernel wall-time histograms from
`kernels/ops.py`.  The design constraints, in order:

1. **Disabled is free.**  Recording goes through the facade helpers in
   `repro_torch.telemetry` (`inc` / `set_gauge` / `observe`), which are a
   single bool check when telemetry is off — nothing here allocates or
   locks until the first enabled record.
2. **Cheap snapshot/export.**  `snapshot()` returns plain-python rows;
   `to_jsonl()` is one JSON object per series (greppable, appendable);
   `to_prometheus()` is the standard text exposition format, so the
   dump drops into promtool / Grafana unchanged.
3. **Thread-safe.**  The driver's scheduler thread, the checkpoint
   writer thread, and user threads all record concurrently; one
   registry lock serialises series creation and updates (the values are
   tiny — contention is not a concern at scheduler rates).

Series identity is (name, sorted labels).  The same name may not be
reused with a different instrument kind (ValueError — a counter cannot
silently become a gauge between layers).
"""
from __future__ import annotations

import json
import threading
from typing import Optional

# Default histogram bucket upper bounds: log-ish spacing that covers
# microsecond kernel timings through multi-second checkpoint writes when
# the recorded unit is seconds or microseconds alike.
DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1e3, 1e4,
                   1e5, 1e6)


class _Series:
    """One labeled series.  `kind` is "counter" | "gauge" | "histogram"."""

    __slots__ = ("name", "kind", "labels", "value", "sum", "count",
                 "bounds", "bucket_counts", "_lock")

    def __init__(self, name: str, kind: str, labels: tuple,
                 bounds: Optional[tuple] = None):
        self.name = name
        self.kind = kind
        self.labels = labels                 # tuple of (key, value) pairs
        self.value = 0.0                     # counter total / gauge level
        self.sum = 0.0                       # histogram only
        self.count = 0                       # histogram only
        self.bounds = bounds                 # histogram only
        self.bucket_counts = ([0] * (len(bounds) + 1) if bounds is not None
                              else None)    # +1: the +Inf bucket
        self._lock = threading.Lock()

    # -- recording (one method per kind; the registry hands back bound
    #    methods so hot paths skip the kind dispatch) ----------------------
    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self.value += value

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.bucket_counts[i] += 1
                    break
            else:
                self.bucket_counts[-1] += 1

    # -- export -----------------------------------------------------------
    def row(self) -> dict:
        out = {"name": self.name, "kind": self.kind,
               "labels": dict(self.labels)}
        if self.kind == "histogram":
            with self._lock:
                out.update(count=self.count, sum=self.sum,
                           buckets={("+Inf" if i == len(self.bounds)
                                     else repr(self.bounds[i])): c
                                    for i, c in
                                    enumerate(self.bucket_counts)})
        else:
            out["value"] = self.value
        return out


def _label_str(labels: tuple, extra: tuple = ()) -> str:
    pairs = labels + extra
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


class MetricsRegistry:
    """Registry of labeled counter/gauge/histogram series.

    >>> reg = MetricsRegistry()
    >>> reg.counter("requests_total", route="vb").inc()
    >>> reg.counter("requests_total", route="vb").inc(2)
    >>> reg.gauge("queue_depth").set(7)
    >>> reg.histogram("write_seconds", bounds=(0.1, 1.0)).observe(0.25)
    >>> [r["value"] for r in reg.snapshot() if r["kind"] == "counter"]
    [3.0]
    >>> "queue_depth 7" in reg.to_prometheus()
    True
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}

    def _get(self, name: str, kind: str, labels: dict,
             bounds: Optional[tuple] = None) -> _Series:
        key = (name, tuple(sorted(labels.items())))
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    s = _Series(name, kind, key[1], bounds)
                    self._series[key] = s
        if s.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {s.kind}, "
                f"cannot re-register as {kind}")
        return s

    def counter(self, name: str, **labels) -> _Series:
        return self._get(name, "counter", labels)

    def gauge(self, name: str, **labels) -> _Series:
        return self._get(name, "gauge", labels)

    def histogram(self, name: str, bounds: tuple = DEFAULT_BUCKETS,
                  **labels) -> _Series:
        return self._get(name, "histogram", labels, tuple(bounds))

    # -- export -----------------------------------------------------------
    def snapshot(self) -> list[dict]:
        """Plain-python rows, one per series, sorted by (name, labels)."""
        with self._lock:
            series = sorted(self._series.values(),
                            key=lambda s: (s.name, s.labels))
        return [s.row() for s in series]

    def to_jsonl(self) -> str:
        """One JSON object per line per series (the driver's drain dump)."""
        return "\n".join(json.dumps(r, default=float)
                         for r in self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one # TYPE line per metric
        name, then the samples; histograms expand to _bucket/_sum/_count
        with cumulative `le` buckets)."""
        with self._lock:
            series = sorted(self._series.values(),
                            key=lambda s: (s.name, s.labels))
        lines, typed = [], set()
        for s in series:
            if s.name not in typed:
                lines.append(f"# TYPE {s.name} {s.kind}")
                typed.add(s.name)
            if s.kind == "histogram":
                with s._lock:
                    cum = 0
                    for i, c in enumerate(s.bucket_counts):
                        cum += c
                        le = ("+Inf" if i == len(s.bounds)
                              else repr(s.bounds[i]))
                        lines.append(
                            f"{s.name}_bucket"
                            f"{_label_str(s.labels, (('le', le),))} {cum}")
                    lines.append(
                        f"{s.name}_sum{_label_str(s.labels)} {s.sum}")
                    lines.append(
                        f"{s.name}_count{_label_str(s.labels)} {s.count}")
            else:
                v = s.value
                val = f"{int(v)}" if float(v).is_integer() else f"{v}"
                lines.append(f"{s.name}{_label_str(s.labels)} {val}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)
