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

**Recording**: the helpers record while host telemetry is enabled OR a
`torch.profiler` is recording.  Under the profiler a span also opens
`torch.profiler.record_function(name)`, so the port's layers land on the
profiler's host timeline, on the clock of the device events, and the
`Tracer` holds the same spans (each with its `parent`) for
`Tracer.summary()`.  `enabled()` stays the explicit switch: the code
it guards (the `vb_run/*` series, the driver's per-tick gauges) does not
run because a profiler does.  Kernel time on the card is the profiler's
to measure; the port keeps no timer of its own on the device.

Off (the default, no profiler) must be free: every helper below is one
module-bool check and one profiler-state check before touching any
registry/tracer state: no tensor op, no CUDA event, nothing retained.

Typical use::

    from repro_torch import telemetry

    telemetry.enable()
    ... run a driver / vb_run ...
    telemetry.export_chrome_trace("trace.json")   # chrome://tracing
    open("metrics.prom", "w").write(telemetry.to_prometheus())
    telemetry.disable(); telemetry.reset()        # tests
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from . import taps
from .metrics import DEFAULT_BUCKETS, MetricsRegistry
from .tracing import Tracer

__all__ = [
    "MetricsRegistry", "Tracer", "DEFAULT_BUCKETS", "taps",
    "enable", "disable", "enabled", "enabled_scope", "reset",
    "registry", "tracer",
    "inc", "set_gauge", "observe",
    "span", "instant",
    "snapshot", "to_jsonl", "to_prometheus", "export_chrome_trace",
    "warn_once",
]

_ENABLED = False
_REGISTRY = MetricsRegistry()
_TRACER = Tracer()
_NULL_CONTEXT = nullcontext()
_WARNED: set = set()


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
    """Clear metrics, trace events, tap buffers and warn-once state."""
    _REGISTRY.clear()
    _TRACER.clear()
    taps.clear()
    _WARNED.clear()


def registry() -> MetricsRegistry:
    return _REGISTRY


def tracer() -> Tracer:
    return _TRACER


# -- fast-path recording helpers (no-ops when not recording) --------------
def inc(name: str, value: float = 1.0, **labels) -> None:
    if _ENABLED or _profiler_enabled():
        _REGISTRY.counter(name, **labels).inc(value)


def set_gauge(name: str, value: float, **labels) -> None:
    if _ENABLED or _profiler_enabled():
        _REGISTRY.gauge(name, **labels).set(value)


def observe(name: str, value: float, **labels) -> None:
    if _ENABLED or _profiler_enabled():
        _REGISTRY.histogram(name, **labels).observe(value)


def span(name: str, **args):
    """Context manager: a Chrome-trace complete event (and, under the
    profiler, a `record_function` range) that yields its args dict, so
    the block can add what it learns (`args["slot"] = ...`); or a shared
    null context yielding None when not recording."""
    if _ENABLED or _profiler_enabled():
        return _recorded_span(name, args)
    return _NULL_CONTEXT


@contextmanager
def _recorded_span(name: str, args: dict):
    with _TRACER.span(name, **args) as a:
        if _profiler_enabled():
            with record_function(name):
                yield a
        else:
            yield a


def instant(name: str, **args) -> None:
    if _ENABLED or _profiler_enabled():
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
