"""Device taps: per-iteration series out of VB runs and serving fleets.

Port of `repro.telemetry.taps`, redesigned for the card.  Two paths get
per-iteration series to the host, as in the reference:

1. **Run series** (`record_series`, used by `core.engine.vb_run`): when
   host telemetry is enabled, `vb_run` files the per-iteration tensors
   it stacks anyway (kl, consensus error, ADMM diagnostics) as
   `vb_run/*` series after its loop.  No tap switch needed.

2. **Device taps** (`tap`, opt-in via `taps.enable()`, a switch of its
   own as in the reference): in the reference an `io_callback` inside
   the traced step; here a device-side record.  `tap(name, value, t)`
   COPIES `value` into a device buffer preallocated for the enclosing
   `Window` (a `vb_run` call's `n_iters`, a fleet slice's k), because the
   fleet's buffers are written in place and a reference would be stale
   by the time it is read.  The buffers are read to the host once, when
   the window is flushed at its end (after `vb_run`'s loop; in the
   driver's `FleetGroup.fetch_flags`, which syncs anyway), so a tap adds
   one device copy per iteration and no host sync.  A value that is
   already a host number (the solo stream's epoch, the SVRG refresh
   decision) is filed at once, with no device work.  A tensor tapped
   outside any window is read to the host at once (a sync).

Records carry their iteration index `t` (an int, or a fleet's (S,) t
tensor, one entry per slot); `series()` sorts by t, as in the
reference.  `tap(..., mean=True)` files the mean of the value's elements
(the reference's `jnp.mean(kl)` taps), taken over the window's buffer in
one reduction at its end, so the loop still adds only the copy.

Disabled (the default) costs one module-bool check per tap site: no
tensor op, no allocation.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import Optional

import numpy as np
import torch

_enabled = False
_lock = threading.Lock()
# name -> list of (t or None, np.ndarray) records, in arrival order
_buffer: dict[str, list] = {}
_local = threading.local()          # .window: this thread's open Window
_NULL_CONTEXT = nullcontext()


def enable() -> None:
    """Turn on device taps (independent of host telemetry)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextmanager
def enabled_scope():
    """Enable taps for the duration of a with-block (tests, debugging)."""
    global _enabled
    prev = _enabled
    _enabled = True
    try:
        yield
    finally:
        _enabled = prev


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _sink(name: str, t, value) -> None:
    # the host-side entry point of record()/record_series() and of host
    # values given to tap(); np.asarray copies
    with _lock:
        _buffer.setdefault(name, []).append(
            (None if t is None else _host(t), _host(value)))


class _Slot:
    """One name's records in a window: values (capacity, ...) on the
    device, viewed row by row (the views are made once, so a record is
    one copy); t in a host list or, for tensor t, a device buffer."""

    __slots__ = ("values", "rows", "ts", "t_rows", "host_ts", "n", "mean")

    def __init__(self, capacity, value, t, mean):
        self.values = torch.empty((capacity,) + tuple(value.shape),
                                  dtype=value.dtype, device=value.device)
        self.rows = self.values.unbind(0)
        self.ts = self.t_rows = self.host_ts = None
        if isinstance(t, torch.Tensor):
            self.ts = torch.empty((capacity,) + tuple(t.shape),
                                  dtype=t.dtype, device=t.device)
            self.t_rows = self.ts.unbind(0)
        else:
            self.host_ts = []
        self.n = 0
        self.mean = mean


class Window:
    """The device buffers of the taps inside one run or slice.

    >>> w = Window(3)
    >>> with w.collecting(), enabled_scope():
    ...     for t in range(3):
    ...         tap("w", torch.tensor([1.0, 2.0]) * t, t=t, mean=True)
    >>> w.flush(); series("w")[1].tolist()
    [0.0, 1.5, 3.0]
    >>> clear()
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._slots: dict[str, _Slot] = {}

    @contextmanager
    def collecting(self):
        """Make this the window `tap` writes into on this thread."""
        prev = getattr(_local, "window", None)
        _local.window = self
        try:
            yield self
        finally:
            _local.window = prev

    def put(self, name: str, value, t, mean: bool = False) -> None:
        s = self._slots.get(name)
        if s is None:
            s = self._slots[name] = _Slot(self.capacity, value, t, mean)
        if s.n == self.capacity:
            raise RuntimeError(f"tap {name!r}: more than {self.capacity} "
                               "records in one window")
        if tuple(value.shape) != tuple(s.values.shape[1:]):
            raise ValueError(f"tap {name!r}: shape {tuple(value.shape)} "
                             f"in a window of {tuple(s.values.shape[1:])}")
        s.rows[s.n].copy_(value)
        if s.t_rows is not None:
            s.t_rows[s.n].copy_(t)
        else:
            s.host_ts.append(t)
        s.n += 1

    def flush(self) -> None:
        """Read every buffer to the host (one copy a name) and file the
        records; the window is empty afterwards."""
        for name, s in self._slots.items():
            vals = s.values[:s.n]
            if s.mean:
                vals = vals.reshape(s.n, -1).mean(1)
            vals = vals.cpu().numpy()
            ts = (s.ts[:s.n].cpu().numpy() if s.ts is not None
                  else s.host_ts)
            with _lock:
                recs = _buffer.setdefault(name, [])
                for i in range(s.n):
                    t = ts[i]
                    recs.append((None if t is None else np.asarray(t),
                                 vals[i]))
        self._slots.clear()


def tap(name: str, value, t=None, *, mean: bool = False) -> None:
    """Record `value` (a tensor or a host number) at iteration `t`.

    No-op when taps are disabled.  A host value is filed at once; a
    tensor is copied into the open window's buffer (read to the host at
    once when no window is open).  `mean` files the mean of the value's
    elements."""
    if not _enabled:
        return
    window = getattr(_local, "window", None)
    if window is None or not isinstance(value, torch.Tensor):
        if mean:
            value = (value.double().mean() if isinstance(value, torch.Tensor)
                     else float(np.mean(value)))
        _sink(name, t, value)
        return
    window.put(name, value, t, mean)


def record(name: str, value, t=None) -> None:
    """Host-side single record (callable anywhere)."""
    _sink(name, t, value)


def record_series(name: str, values, ts=None) -> None:
    """File a whole per-iteration series (the vb_run path).

    `values` is a (T, ...) array or tensor; `ts` an optional (T,)
    iteration-index array (absolute t, so resumed runs interleave
    correctly).
    """
    values = _host(values)
    ts = None if ts is None else _host(ts)
    with _lock:
        recs = _buffer.setdefault(name, [])
        for i in range(values.shape[0]):
            recs.append((None if ts is None else ts[i], values[i]))


def series(name: str):
    """Return (ts, values) numpy arrays for a tapped series.

    `ts` is None when no record carried an index; otherwise records are
    sorted by t (a fleet's records by their slots' least t).  Raises
    KeyError for unknown names (see `names()`).
    """
    with _lock:
        recs = list(_buffer[name])
    if recs and recs[0][0] is not None:
        recs.sort(key=lambda r: int(np.min(r[0])))
        return (np.stack([r[0] for r in recs]),
                np.stack([r[1] for r in recs]))
    return None, np.stack([r[1] for r in recs]) if recs else np.empty((0,))


def names() -> list[str]:
    with _lock:
        return sorted(_buffer)


def counts() -> dict:
    """{name: number of records} — cheap progress probe for live runs."""
    with _lock:
        return {k: len(v) for k, v in _buffer.items()}


def clear() -> None:
    with _lock:
        _buffer.clear()


def open_window(capacity: int) -> Optional[Window]:
    """A `Window` of `capacity` records a name when taps are enabled,
    else None (the callers' one check)."""
    return Window(capacity) if _enabled else None


def collecting(window: Optional[Window]):
    """`window.collecting()`, or a shared null context for None."""
    return window.collecting() if window is not None else _NULL_CONTEXT
