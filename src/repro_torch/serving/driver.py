"""Host-side scheduling primitives of the serving stack (the generic
classes of `repro.serving.driver`): the arrival queue, the slot table and
the driver's counters, which the LM `serving.engine.Engine` schedules its
prefill/decode waves with.  The VB continuous-batching driver itself waits
for ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, NamedTuple, Optional


class ArrivalQueue:
    """Thread-safe arrival queue ordered by (arrive_at, submission seq)."""

    def __init__(self):
        self._heap: list[tuple[float, int, Any]] = []
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def push(self, item: Any, arrive_at: float = 0.0) -> None:
        with self._lock:
            heapq.heappush(self._heap,
                           (float(arrive_at), next(self._seq), item))

    def push_entry(self, entry: tuple[float, int, Any]) -> None:
        """Re-queue a popped entry unchanged (keeps its FIFO position)."""
        with self._lock:
            heapq.heappush(self._heap, entry)

    def pop_ready(self, now: float) -> list[tuple[float, int, Any]]:
        out = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                out.append(heapq.heappop(self._heap))
        return out

    def next_arrival(self) -> Optional[float]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


class SlotTable:
    """Fixed-capacity slot allocator: which fleet row belongs to which
    request id.  Lowest free slot first, so admission is deterministic."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.rids: list[Optional[str]] = [None] * self.capacity

    def alloc(self, rid: str) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self.rids[slot] = rid
        return slot

    def free(self, slot: int) -> Optional[str]:
        rid, self.rids[slot] = self.rids[slot], None
        self._free.append(slot)
        self._free.sort(reverse=True)
        return rid

    def grow(self, new_capacity: int) -> None:
        extra = range(self.capacity, new_capacity)
        self.rids.extend([None] * (new_capacity - self.capacity))
        self._free = sorted(self._free + list(extra), reverse=True)
        self.capacity = new_capacity

    def occupied(self) -> list[tuple[int, str]]:
        return [(i, r) for i, r in enumerate(self.rids) if r is not None]

    @property
    def n_occupied(self) -> int:
        return self.capacity - len(self._free)


class DriverStats(NamedTuple):
    """Host-side scheduler counters (cumulative unless noted)."""

    slices: int          # device slices dispatched
    compiles: int        # slice-fn traces across all groups (incl. retired)
    admitted: int        # sessions placed into a fleet slot
    evicted: int         # sessions removed at a slice boundary
    queue_depth: int     # now: sessions waiting for arrival time or a slot
    active: int          # now: occupied slots that still have work
    capacity: int        # now: total fleet slots across groups
    occupancy: float     # time-averaged active/capacity over stepped slices
    padding_waste: float  # 1 - occupancy: fraction of stepped slots masked
    checkpoints: int     # background checkpoint writes completed
    buckets: tuple = ()  # per-group breakdown (VB driver only; empty here)
    checkpoint_errors: int = 0  # background checkpoint writes that raised
