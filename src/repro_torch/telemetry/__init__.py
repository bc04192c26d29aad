"""Unified telemetry: metrics registry + span tracing + device taps.

Port of `repro.telemetry`.  One switch, three layers:

- **Metrics** (`metrics.MetricsRegistry`): labeled counters / gauges /
  histograms with JSON-lines and Prometheus-text export.  The process
  default registry lives here; instrumented layers record through the
  module-level helpers below.
- **Tracing** (`tracing.Tracer`): `span(name)` / `instant(name)` events
  with Chrome-trace export — driver slices, slice shapes first stepped,
  checkpoint writes, admission/rebucket decisions and kernel calls on
  one timeline.
- **Taps** (`taps`): per-iteration series out of VB runs and fleets.
  Device taps have their OWN switch (`taps.enable()`), as in the
  reference: a tap adds a device copy per iteration; host telemetry
  alone adds no device work inside an iteration.

**Kernel time on the card** (`event_pair`, `observe_events`):
`kernels/ops.py` records a pair of CUDA events around each launch on the
current stream and never waits on them there.  The pending pairs are
resolved into their histogram when the registry is read (`registry()`,
`snapshot()`, the exports) or at a sync the caller makes anyway (after
`vb_run`'s loop, the driver's `fetch_flags`).

Disabled (the default) must be free: every helper below is a single
module-bool check before touching any registry/tracer state — no tensor
op, no CUDA event, no allocation.

Typical use::

    from repro_torch import telemetry

    telemetry.enable()
    ... run a driver / vb_run ...
    telemetry.export_chrome_trace("trace.json")   # chrome://tracing
    open("metrics.prom", "w").write(telemetry.to_prometheus())
    telemetry.disable(); telemetry.reset()        # tests
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext

from . import taps
from .metrics import DEFAULT_BUCKETS, MetricsRegistry
from .tracing import Tracer

__all__ = [
    "MetricsRegistry", "Tracer", "DEFAULT_BUCKETS", "taps",
    "enable", "disable", "enabled", "enabled_scope", "reset",
    "registry", "tracer",
    "inc", "set_gauge", "observe", "event_pair", "observe_events",
    "resolve_device_times",
    "span", "instant",
    "snapshot", "to_jsonl", "to_prometheus", "export_chrome_trace",
    "warn_once",
]

_ENABLED = False
_REGISTRY = MetricsRegistry()
_TRACER = Tracer()
_NULL_CONTEXT = nullcontext()
_WARNED: set = set()
# CUDA event pairs recorded around launches and not yet read:
# (start, end, histogram name, labels); finished pairs go back to the pool
_PENDING: list = []
_EVENT_POOL: list = []
_DEVICE_LOCK = threading.Lock()


def enable() -> None:
    """Turn on host-side telemetry (metrics + spans).  Device taps have
    a separate switch — `telemetry.taps.enable()`."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


@contextmanager
def enabled_scope():
    """Enable host telemetry for a with-block (tests, benchmarks)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    try:
        yield
    finally:
        _ENABLED = prev


def reset() -> None:
    """Clear metrics, trace events, tap buffers, pending kernel times and
    warn-once state."""
    with _DEVICE_LOCK:
        _PENDING.clear()
    _REGISTRY.clear()
    _TRACER.clear()
    taps.clear()
    _WARNED.clear()


def registry() -> MetricsRegistry:
    resolve_device_times()
    return _REGISTRY


def tracer() -> Tracer:
    return _TRACER


# -- fast-path recording helpers (no-ops when disabled) -------------------
def inc(name: str, value: float = 1.0, **labels) -> None:
    if _ENABLED:
        _REGISTRY.counter(name, **labels).inc(value)


def set_gauge(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name, **labels).set(value)


def observe(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.histogram(name, **labels).observe(value)


def event_pair():
    """Two timing CUDA events (from a pool) to record around a device
    interval; hand them to `observe_events` once both are recorded.
    Only for enabled telemetry (the caller checks)."""
    import torch

    with _DEVICE_LOCK:
        if _EVENT_POOL:
            return _EVENT_POOL.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def observe_events(name: str, start, end, **labels) -> None:
    """Observe the elapsed time between two recorded CUDA events, in
    seconds, into histogram `name` when the registry is next read (the
    events are not waited on here)."""
    with _DEVICE_LOCK:
        _PENDING.append(((start, end), name, labels))


def resolve_device_times() -> None:
    """Observe every pending event pair into its histogram (waiting for
    the work they bracket, which a reader has to) and return the events
    to the pool."""
    with _DEVICE_LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for (start, end), name, labels in pending:
        end.synchronize()
        _REGISTRY.histogram(name, **labels).observe(
            start.elapsed_time(end) / 1e3)
    with _DEVICE_LOCK:
        _EVENT_POOL.extend(pair for pair, _, _ in pending)


def span(name: str, **args):
    """Context manager: a Chrome-trace complete event, or a shared null
    context when disabled (one bool check, zero allocation)."""
    if _ENABLED:
        return _TRACER.span(name, **args)
    return _NULL_CONTEXT


def instant(name: str, **args) -> None:
    if _ENABLED:
        _TRACER.instant(name, **args)


def warn_once(key: str, message: str, category=UserWarning,
              stacklevel: int = 2) -> bool:
    """Issue `warnings.warn(message)` only the first time `key` is seen
    this session (cleared by `reset()`).  Returns True when the warning
    fired — callers pair it with an unconditional counter so repeat
    occurrences stay countable even though they stop warning.  Active
    regardless of the enabled switch: deduplicating a warning is not
    telemetry overhead, it removes log spam."""
    if key in _WARNED:
        return False
    _WARNED.add(key)
    import warnings
    warnings.warn(message, category, stacklevel=stacklevel + 1)
    return True


# -- export ---------------------------------------------------------------
def snapshot() -> list:
    return registry().snapshot()


def to_jsonl() -> str:
    return registry().to_jsonl()


def to_prometheus() -> str:
    return registry().to_prometheus()


def export_chrome_trace(path: str) -> str:
    return _TRACER.export_chrome_trace(path)
