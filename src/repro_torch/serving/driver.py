"""Continuous-batching serving driver (port of `repro.serving.driver`):
fixed-capacity VB fleets with mid-flight join/leave, an arrival queue,
eviction and background checkpoint writes, the LM-inference-server
scheduling model applied to sensor-network VB sessions.

* **SlotTable** — host-side allocator for a FIXED-capacity fleet.  A
  group allocates its fleet buffers once per (capacity, slice length)
  shape, and sessions join and leave by in-place writes into a slot
  (`FleetGroup.compiles` counts the shapes: the analogue of the
  reference's slice-function traces).
* **CUDA graph** — on the card a fleet captures one gated iteration as a
  `torch.cuda.CUDAGraph` in the first slice at each capacity and replays
  it k times a slice (`FleetGroup._run_graphed`), so the host launches
  one graph an iteration instead of queueing each of its ~330 ops; the
  state buffers are written in place, so join and leave need no
  recapture.  A slice takes the graph only where `_graph_eligible` says
  so (CUDA, no mesh executor, full batch, taps closed, a model and
  topology whose step never waits for the host); every other slice runs
  the eager loop.
* **Active mask for free** — a free or evicted slot is written as
  `conv=True, budget=0`: the per-session budget/early-stop gate of
  `_gated_step` is the driver's active mask, and frozen slots stay bit
  for bit inert.
* **ArrivalQueue** — thread-safe `(arrive_at, seq)` heap.  `tick()`
  admits every ready arrival at the slice boundary, dispatches one slice
  per group (the kernels are queued on the card, nothing waits), takes
  the checkpoint snapshots while the device runs, then syncs the small
  per-slot flag vectors and **evicts** sessions that converged or spent
  their budget, freeing their slots for the next arrival.
* **CheckpointWriter** — a daemon thread doing the device-to-host copy
  and the .npz compression off the scheduler thread, overlapped with the
  in-flight slice.
* **Bucketed admission** — fleet groups are keyed by the BUCKETED data
  shape: per-node buffers pad with mask-zero slots up to a capacity
  ladder rung (`admission.bucket_capacity`) and per-iteration constants
  (tau/d0, rho/xi) lift to per-slot fleet tensors
  (`engine.session_hyper`), so mixed-shape mixed-hyper sessions share one
  fleet.
* **Eviction is safe** because of the absolute-t resumability contract
  (`engine.VBState`): every per-iteration source (minibatch epochs, link
  drops, eta/kappa ramps) is a function of the session's own t, so a
  session's trajectory does not depend on WHEN its slices run.

The fleet is one batch on the device: its data are contiguous (S, N, T,
...) buffers (plus the hot path's cast copy), its iterates (S, N, P),
its t an (S,) int64 tensor; one slice is k iterations of
`engine.fleet_step_fn` under the gate, whose local step is one kernel
launch for the whole fleet.  Nothing inside a slice waits for the device
except a parity hook (`link_mask_fn`, `perm_fn`, `active_mask_fn`),
which reads each slot's t on the host; the host mirror of t, conv and
delta is refreshed once a slice (`FleetGroup.fetch_flags`).

`VBDriver` is the scheduler; `serving/vb_service.py` keeps its public
API as a thin wrapper, and `serving/engine.py`'s LM `Engine` reuses
`SlotTable` / `ArrivalQueue` / `DriverStats` for its prefill/decode
waves.

Under the mesh executor (`executor=MeshExecutor(group)`, SPMD: every
rank drives the same driver with the same requests) the fleet's buffers
stay global; each slice takes this rank's block of the node axis (the
slot axis stays a leading batch axis on every rank), runs the k gated
iterations with the topology's collectives and the early-stop delta
averaged over the ranks, and gathers phi, the carry and the stream back.
t, conv, budget and delta are the same on every rank, so every decision
(admit, evict, budgets, the epoch redraw test) is too.  The checkpoint
files are rank 0's alone (`save_session`, the autosaves): the ranks hold
the same state, and ranks sharing a directory would race on one file.

Telemetry (`repro_torch.telemetry`: recorded with host telemetry on or
under a torch profiler, where each span is also a profiler range).  The
reference's catalogue: spans `driver/slice{k,slots}` (with
`driver/compile` nested in the first slice of each (capacity, k)
shape), `driver/sync` and `driver/checkpoint` (from the writer thread);
counters `driver_admitted_total`, `driver_evicted_total`,
`driver_rebucket_total`, `driver_requeue_total`,
`driver_checkpoints_total`, `driver_checkpoint_errors_total`; the
histogram `driver_checkpoint_write_seconds`; gauges
`driver_queue_depth`, `driver_active`, `driver_capacity`,
`driver_occupancy`, `driver_padding_waste` at every slice boundary
(host telemetry only); `driver/admit{rid,slot,waited}` and
`driver/evict{rid,slot}` (spans around the slot write and the state
snapshot; instants in the reference), instants `driver/rebucket`,
`driver/requeue`.  The port's own: spans `driver/tick` (slice, sync,
admit and evict nest in it), `driver/submit{rid}` and
`driver/status{rid}`; the counter `driver_fleet_iterations_total` (k a
group stepped); the histograms `driver_queue_wait_slices` and
`driver_queue_wait_seconds`, one observation an admission: the slice
boundaries and seconds from `submit` (or a re-queue; a deferred
arrival's deferral included) to it, 0 slices where a slot was free; the
counters `driver_graph_replays_total` (fleet iterations run as a graph
replay, 0 added by an eager slice) and `driver_graph_captures_total`.
With taps on, a slice's taps go to a window of k records read in
`fetch_flags`.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
import queue as queue_lib
import threading
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import telemetry
from repro_torch.checkpoint import ckpt
from repro_torch.core import engine
from repro_torch.data import stream as stream_lib
from repro_torch.dist import collectives, sharding
from repro_torch.kernels import ops
from repro_torch.serving import admission
from repro_torch.telemetry import taps


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


class BucketStats(NamedTuple):
    """Per-fleet-group (= per admission bucket) scheduler counters."""

    label: str               # "<Model>/N<nodes>/cap<rung>" or ".../exact"
    bucket_capacity: Optional[int]  # data-capacity rung (None = unbucketed)
    slots: int               # fleet slot capacity now
    admitted: int            # sessions ever admitted into this group
    active: int              # now: occupied slots that still have work
    occupancy: float         # time-averaged active/slots over stepped slices
    padding_waste: float     # 1 - occupancy: stepped-but-masked slot frac
    data_pad_frac: float     # mean fraction of mask-zero rung-padding
    #                          slots per admitted session (0 = exact fit)


class DriverStats(NamedTuple):
    """Host-side scheduler counters (cumulative unless noted)."""

    slices: int          # device slices dispatched
    compiles: int        # fleet (capacity, k) shapes stepped, all groups
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


class _PendingSave:
    """Tiny future for one background checkpoint write."""

    def __init__(self):
        self._done = threading.Event()
        self.path: Optional[str] = None
        self.exc: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> str:
        self._done.wait(timeout)
        if self.exc is not None:
            raise self.exc
        return self.path


def _host_tree(tree: dict) -> dict:
    """A checkpoint record's tensors on the host, its integer scalars in
    the reference's file dtype: t, budget and a stream's epoch as int32."""
    out = _tree_map(lambda a: a.detach().cpu(), tree)
    out["t"], out["budget"] = (out[k].to(torch.int32)
                               for k in ("t", "budget"))
    if out["stream"] is not None:
        out["stream"] = out["stream"]._replace(
            epoch=out["stream"].epoch.to(torch.int32))
    return out


class CheckpointWriter:
    """Background checkpoint writes: the device-to-host copy and the .npz
    compression run on a daemon thread, overlapped with the in-flight
    slice.  The fleet's buffers are overwritten by the next slice, so the
    tree handed to `submit` holds CLONES taken on the scheduler thread at
    the slice boundary (`FleetGroup.state_tree`), queued on the card
    before that slice; `submit` records a CUDA event after them, and the
    worker waits for that event, not for the slice, then copies on a side
    stream.  What lands on disk is always a valid resumable boundary
    state."""

    def __init__(self):
        self._q: queue_lib.Queue = queue_lib.Queue()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._side: Optional[torch.cuda.Stream] = None
        self.completed = 0
        self.errors = 0     # failed writes (counted even when nobody waits)

    def submit(self, tree: Any, path: str) -> _PendingSave:
        pending = _PendingSave()
        event = None
        if any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in _tree_leaves(tree)):
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._worker,
                                                daemon=True)
                self._thread.start()
        self._q.put((tree, path, event, pending))
        return pending

    def _host(self, tree, event):
        if event is None:
            return _host_tree(tree)
        event.synchronize()             # the clones, not the slice after
        if self._side is None:
            self._side = torch.cuda.Stream()
        with torch.cuda.stream(self._side):
            return _host_tree(tree)

    def _worker(self) -> None:
        while True:
            tree, path, event, pending = self._q.get()
            t0 = time.perf_counter()
            try:
                with telemetry.span("driver/checkpoint",
                                    file=os.path.basename(path)):
                    pending.path = ckpt.save(path, self._host(tree, event))
                self.completed += 1
                telemetry.inc("driver_checkpoints_total")
                telemetry.observe("driver_checkpoint_write_seconds",
                                  time.perf_counter() - t0)
            except Exception as e:
                # surfaced by pending.wait() when someone holds the
                # future; the periodic autosaves never wait, so the
                # error is also counted (DriverStats.checkpoint_errors),
                # and the daemon thread (and the scheduler) stay alive
                pending.exc = e
                self.errors += 1
                telemetry.inc("driver_checkpoint_errors_total")
            finally:
                pending._done.set()
                self._q.task_done()

    def flush(self) -> None:
        self._q.join()


# ---------------------------------------------------------------------------
# Tree helpers + the gated slice (the reference's vmap/scan, batched)
# ---------------------------------------------------------------------------
def _tree_map(fn, tree, *rest):
    """fn over the leaves of a tree of tensors in tuples, NamedTuples,
    lists and dicts (None and Python scalars are leaves of their own
    when `fn` is given them; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _tree_index(tree, i):
    return _tree_map(lambda leaf: leaf[i], tree)


def _tree_set(tree, i, value) -> None:
    """Write `value` (one session's tree) into slot i of the fleet's
    buffers, in place."""
    _tree_map(lambda buf, v: buf[i].copy_(torch.as_tensor(v)), tree, value)


def _tree_where(active: torch.Tensor, new, old):
    """Per slot: the new leaf where `active`, else the old one.  A leaf
    the step left as it was (the same tensor) is kept without a copy."""
    def pick(a, b):
        if a is b:
            return b
        return torch.where(active.reshape(active.shape
                                          + (1,) * (a.dim() - 1)), a, b)

    return _tree_map(pick, new, old)


def _gated_step(step_fn, axis=None):
    """Wrap `engine.fleet_step_fn` with the per-session budget /
    early-stop gate: inactive sessions (converged, or budget spent) keep
    their state bit for bit and their absolute t frozen, so a session
    that early-stops inside a fleet ends in exactly the state a solo
    `vb_run` of the same length would have produced.  A FREE slot is a
    session with `conv=True, budget=0`: the same gate is the driver's
    active mask.  The reference's arithmetic, per slot: delta = sqrt of
    the mean over (N, P) of (phi' - phi)^2, conv' = conv or (tol > 0 and
    delta < tol), and `where(active, new, old)` over the whole state
    tree, the stream's anchors included.  Under the mesh executor
    (`axis`) the mean is over every rank's nodes (`pmean`), so every rank
    takes the same stop decision."""

    def one(data, stream_data, phi, carry, st, t, conv, budget, tol,
            delta_prev, hyper, may_redraw):
        active = ~conv & (t < budget)
        phi2, carry2, st2, _ = step_fn(data, stream_data, phi, carry, st,
                                       t, hyper, may_redraw)
        msq = ((phi2 - phi) ** 2).mean((-2, -1))
        if axis is not None:
            msq = collectives.pmean(msq, axis)
        delta = torch.sqrt(msq).to(phi.dtype)
        conv2 = conv | ((tol > 0.0) & (delta < tol))
        return (torch.where(active[:, None, None], phi2, phi),
                _tree_where(active, carry2, carry),
                _tree_where(active, st2, st),
                t + active.to(t.dtype),
                torch.where(active, conv2, conv),
                torch.where(active, delta, delta_prev))

    return one


def _redraw_possible(t0, budget, conv, tol, j: int, n_chunks: int) -> bool:
    """Can any slot enter a new stream epoch at iteration j of a slice
    (host bounds, no sync)?  A slot at t0 (exact at the slice start) that
    is not latched is at t0 + j if it stayed active; with tol > 0 it may
    have stopped anywhere in [t0, t0 + j].  It advances at t only while
    t < budget, and enters an epoch where t is a positive multiple of
    n_chunks."""
    for s in range(len(t0)):
        if conv[s] or t0[s] >= budget[s]:
            continue
        hi = min(int(t0[s]) + j, int(budget[s]) - 1)
        lo = hi if tol[s] <= 0.0 else int(t0[s])
        if hi < lo:
            continue
        first = max(lo, 1)
        if -(-first // n_chunks) * n_chunks <= hi:
            return True
    return False


#: eager iterations a slice runs on the capture stream before it captures
#: its graph: the first call of each library (cuBLAS and its workspace on
#: that stream, the kernel's module) must not fall inside a capture
GRAPH_WARMUP = 2


def _graph_eligible(device, executor, minibatch, tap_window, model,
                    topology) -> bool:
    """Whether a fleet's slice replays one captured iteration as a CUDA
    graph (`FleetGroup._run_graphed`), from what the slice can observe:
    buffers on a CUDA device, the single-array executor (the mesh's
    collectives are not captured), full batch (a minibatch's
    `may_redraw` is decided on the host every iteration), taps closed
    (a tap copies each iteration out), and a (model, topology) whose
    step launches nothing that waits for the host (`sync_free_step` on
    the model's type, `sync_free()` on the topology's)."""
    return (torch.device(device).type == "cuda" and executor is None
            and minibatch is None and tap_window is None
            and getattr(model, "sync_free_step", False)
            and topology.sync_free())


# ---------------------------------------------------------------------------
# FleetGroup: one fixed-capacity fleet of same-shape sessions
# ---------------------------------------------------------------------------
class FleetGroup:
    """One fleet: same-shape sessions batched along a leading slot axis
    of FIXED capacity.  Free slots hold an inert copy of the first
    record's state (conv latched, zero budget), so join/leave are
    in-place writes into a slot.  `max_fleet=None` falls back to
    power-of-two auto-growth (the capacity doubles when full: the buffers
    are allocated anew at the new shape).

    The buffers: `data` (each leaf (S, N, T, ...), contiguous) and
    `stream_data`, the hot path's copy (`model.stream_data`: the data
    leaves themselves where no cast is needed, else a cast buffer kept in
    step by every write into `data`); `phi` (S, N, P); `carry` and
    `stream` with a leading (S,) axis; `t` (S,) int64; `conv` (S,) bool;
    `budget` (S,) int64; `tol` and `delta` (S,) in phi's dtype; `hyper`
    {name: (S,)}.  Nothing re-stacks or re-casts the data per iteration.
    With an `executor` a slice runs on this rank's block of the node axis
    (`_run_slice`).  On the graph path (`_run_graphed`) `phi`, `carry`,
    `stream`, `t`, `conv` and `delta` are written in place, never rebound,
    while the group holds a graph.
    """

    def __init__(self, session: engine.VBSession,
                 max_fleet: Optional[int] = None,
                 bucket_capacity: Optional[int] = None, executor=None):
        self.session = session          # template (data ignored per-slot)
        self.max_fleet = max_fleet
        self.bucket_capacity = bucket_capacity  # data rung; None = exact
        self.slots: Optional[SlotTable] = None
        self.data = self.stream_data = None
        self.phi = self.carry = self.stream = None
        self.t = self.conv = self.budget = self.tol = self.delta = None
        self.hyper = None               # per-slot lifted constants
        # host mirrors of the per-slot flag vectors (refreshed by
        # fetch_flags after each slice; written in step with control ops)
        self.host_t = self.host_conv = None
        self.host_budget = self.host_delta = self.host_tol = None
        self.executor = executor
        if executor is None:
            self._step = _gated_step(engine.fleet_step_fn(session))
        else:
            # the reference's `_mesh_slice_fn`: the node axis sharded,
            # the fleet axis a leading batch axis on every rank; the step
            # reads the template's model, topology, schedule, replication
            # and minibatch spec, never its data
            n_nodes = engine._leaves(session.data)[0].shape[0]
            n_local = n_nodes // collectives.axis_size(executor)
            template = dataclasses.replace(
                session, minibatch=engine._local_minibatch(
                    session.minibatch, executor, n_local))
            local = engine._local_inputs(session.topology, executor,
                                         n_local)
            self._step = _gated_step(engine.fleet_step_fn(
                template, axis=executor, local=local), axis=executor)
            self._n_local = n_local
        self._local_data = None     # this rank's rows of data/stream_data
        self._shapes: set = set()       # (capacity, k) stepped at
        self._compiles = 0
        # the captured iteration at this capacity: (CUDAGraph, the kernel
        # launches it holds), or None (`_run_graphed`)
        self._graph = None
        self._taps: Optional[taps.Window] = None    # the slice's taps
        # per-bucket accounting (read by VBDriver.stats)
        self.n_admitted = 0
        self.pad_frac_sum = 0.0         # sum over admits of padded-slot frac
        self.occ_active = 0             # sum of active counts over slices
        self.occ_slots = 0              # sum of capacities over slices

    @property
    def capacity(self) -> int:
        return 0 if self.slots is None else self.slots.capacity

    # -- allocation -------------------------------------------------------
    def _stream_buffers(self):
        return engine._stream_data(self.session.model, self.data)

    def _alloc(self, record: dict) -> None:
        cap = 1 if self.max_fleet is None else int(self.max_fleet)

        def rep(leaf):
            leaf = torch.as_tensor(leaf)
            return leaf.unsqueeze(0).repeat((cap,) + (1,) * leaf.dim())

        self.data = _tree_map(rep, record["data"])
        self.stream_data = self._stream_buffers()
        self._local_data = None
        self.phi = rep(record["phi"])
        self.carry = _tree_map(rep, record["carry"])
        self.stream = _tree_map(rep, record["stream"])
        self.hyper = _tree_map(rep, record["hyper"])
        self.t = rep(record["t"]).to(torch.int64)
        dev, dt = self.phi.device, self.phi.dtype
        self.conv = torch.ones((cap,), dtype=torch.bool, device=dev)
        self.budget = torch.zeros((cap,), dtype=self.t.dtype, device=dev)
        self.tol = torch.zeros((cap,), dtype=dt, device=dev)
        self.delta = torch.zeros((cap,), dtype=dt, device=dev)
        self.host_t = np.zeros((cap,), np.int64)
        self.host_conv = np.ones((cap,), bool)
        self.host_budget = np.zeros((cap,), np.int64)
        self.host_delta = np.zeros((cap,), np.float64)
        self.host_tol = np.zeros((cap,), np.float64)
        self.slots = SlotTable(cap)

    def _grow(self) -> None:
        old = self.capacity
        new = old * 2

        def pad(leaf):
            return torch.cat([leaf, leaf[:1].expand(
                (new - old,) + leaf.shape[1:])])

        self.data = _tree_map(pad, self.data)
        self.stream_data = self._stream_buffers()
        self._local_data = None
        self.phi = pad(self.phi)
        self.carry = _tree_map(pad, self.carry)
        self.stream = _tree_map(pad, self.stream)
        self.hyper = _tree_map(pad, self.hyper)
        self.t = pad(self.t)
        self.conv = torch.cat([self.conv, self.conv.new_ones(new - old)])
        self.budget = torch.cat([self.budget,
                                 self.budget.new_zeros(new - old)])
        self.tol = torch.cat([self.tol, self.tol.new_zeros(new - old)])
        self.delta = torch.cat([self.delta, self.delta.new_zeros(new - old)])
        self.host_t = np.concatenate(
            [self.host_t, np.zeros((new - old,), np.int64)])
        self.host_conv = np.concatenate(
            [self.host_conv, np.ones((new - old,), bool)])
        self.host_budget = np.concatenate(
            [self.host_budget, np.zeros((new - old,), np.int64)])
        self.host_delta = np.concatenate(
            [self.host_delta, np.zeros((new - old,), np.float64)])
        self.host_tol = np.concatenate(
            [self.host_tol, np.zeros((new - old,), np.float64)])
        self.slots.grow(new)
        self._shapes.clear()            # the capacity is a new shape
        self._graph = None              # it read the old buffers

    # -- join / leave -----------------------------------------------------
    def admit(self, rid: str, record: dict) -> int:
        """Place one session record into a free slot, growing a fleet
        without `max_fleet`; the caller keeps a session queued while the
        fleet is `full`."""
        if self.slots is None:
            self._alloc(record)
        slot = self.slots.alloc(rid)
        if slot is None:                # not `full`: the fleet may grow
            self._grow()
            slot = self.slots.alloc(rid)
        self.load_state_tree(slot, record)
        self.host_t[slot] = int(record["t"])
        self.host_conv[slot] = bool(record["conv"])
        self.host_budget[slot] = int(record["budget"])
        self.host_delta[slot] = float(record["delta"])
        self.host_tol[slot] = float(record["tol"])
        return slot

    @property
    def full(self) -> bool:
        """No free slot, and the fleet may not grow (`max_fleet`)."""
        return (self.slots is not None and self.max_fleet is not None
                and self.slots.n_occupied == self.slots.capacity)

    def evict(self, slot: int) -> dict:
        """Snapshot a slot's resumable state and mark the slot free
        (inert: conv latched, zero budget)."""
        record = self.state_tree(slot)
        self.conv[slot] = True
        self.budget[slot] = 0
        self.host_conv[slot] = True
        self.host_budget[slot] = 0
        self.slots.free(slot)
        return record

    def write_data(self, i: int, data) -> None:
        """New data for slot i, written in place, and the hot path's copy
        of it."""
        _tree_set(self.data, i, data)
        cast = engine._stream_data(self.session.model,
                                   _tree_index(self.data, i))
        bufs = engine._leaves(self.stream_data)
        for buf, src, d in zip(bufs, engine._leaves(cast),
                               engine._leaves(self.data)):
            if buf is not d:
                buf[i].copy_(src)
        self._local_data = None
    # -- slice execution --------------------------------------------------
    def step_slice(self, k: int) -> None:
        """Queue one k-iteration slice on the device (nothing waits: host
        work may overlap until `fetch_flags`)."""
        shape = (self.capacity, k)
        first = shape not in self._shapes
        if first:
            self._shapes.add(shape)
            self._compiles += 1
        with telemetry.span("driver/slice", k=k, slots=self.capacity):
            if first:
                # the first slice of a (capacity, k) shape: the analogue
                # of the reference's compile, nested so a timeline tells
                # it from the steady-state slices
                with telemetry.span("driver/compile", k=k,
                                    slots=self.capacity):
                    self._run_slice(k)
            else:
                self._run_slice(k)

    def _mesh_specs(self) -> tuple:
        """The fleet's specs (dist/sharding.py) of (data, stream_data,
        phi, carry, stream): the engine executor's `vb_node_specs`, each
        node axis one to the right of the slot axis."""
        has_carry = self.carry is not None
        in_specs, _ = sharding.vb_node_specs(
            self.data, has_carry=has_carry, n_local=0,
            carry_specs=(self.session.topology.carry_specs()
                         if has_carry else None),
            stream_specs=(stream_lib.state_specs(self.stream)
                          if self.stream is not None else None))
        data, phi, carry, stream = in_specs
        return tuple(sharding.fleet_spec(s)
                     for s in (data, data, phi, carry, stream))

    def _run_slice(self, k: int) -> None:
        if self._taps is None:
            self._taps = taps.open_window(k)    # None unless taps are on
        ses = self.session
        if _graph_eligible(self.phi.device, self.executor, ses.minibatch,
                           self._taps, ses.model, ses.topology):
            replays = self._run_graphed(k)
        else:
            # the loop below rebinds the state: a graph captured on the
            # old tensors is stale
            self._graph = None
            self._run_eager(k)
            replays = 0
        telemetry.inc("driver_graph_replays_total", replays)

    def _iterate_in_place(self) -> None:
        """One gated fleet iteration, its state written back into the
        group's buffers (the graph path's iteration: what a capture
        records and each replay repeats, reading and writing the same
        tensors)."""
        state = (self.phi, self.carry, self.stream, self.t, self.conv,
                 self.delta)
        new = self._step(self.data, self.stream_data, self.phi, self.carry,
                         self.stream, self.t, self.conv, self.budget,
                         self.tol, self.delta, self.hyper, False)
        for buf, val in zip(_tree_leaves(state), _tree_leaves(new)):
            if val is not buf:
                buf.copy_(val)

    def _run_graphed(self, k: int) -> int:
        """k iterations on the CUDA graph path; returns the replays.  The
        first slice at a capacity runs `GRAPH_WARMUP` iterations eagerly
        on the capture stream, then captures one (a capture runs
        nothing), and replays the rest; later slices replay all k.  Join,
        leave, checkpoints and flag reads write or read the buffers in
        place on the current stream, so they need no recapture; `_grow`
        drops the graph."""
        done = 0
        if self._graph is None:
            cur = torch.cuda.current_stream(self.phi.device)
            side = torch.cuda.Stream(self.phi.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                done = min(k, GRAPH_WARMUP)
                for _ in range(done):
                    self._iterate_in_place()
                before = ops.launch_counts()
                graph = torch.cuda.CUDAGraph()
                # thread_local: the checkpoint writer's copies on its own
                # thread may run meanwhile
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._iterate_in_place()
                except BaseException:
                    try:        # the step's error is the one to report
                        graph.capture_end()
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
                after = ops.launch_counts()
                ops.set_launch_counts(before)
            cur.wait_stream(side)
            self._graph = (graph, {key: after[key] - n
                                   for key, n in before.items()})
            telemetry.inc("driver_graph_captures_total")
        graph, launches = self._graph
        for _ in range(k - done):
            graph.replay()
        ops.add_launch_counts(launches, k - done)
        return k - done

    def _run_eager(self, k: int) -> None:
        mb = self.session.minibatch
        n_chunks = None
        if mb is not None:
            T = int(self.session.model.data_mask(self.data).shape[-1])
            n_chunks = -(-T // min(int(mb.batch_size), T))
        data, stream_data = self.data, self.stream_data
        phi, carry, st = self.phi, self.carry, self.stream
        ex = self.executor
        if ex is not None:          # this rank's rows of the node axis
            specs = self._mesh_specs()
            if self._local_data is None:    # the buffers changed
                self._local_data = tuple(
                    sharding.local_tree(v, s, ex, self._n_local)
                    for v, s in zip((data, stream_data), specs[:2]))
            data, stream_data = self._local_data
            phi, carry, st = (sharding.local_tree(v, s, ex, self._n_local)
                              for v, s in zip((phi, carry, st), specs[2:]))
        with taps.collecting(self._taps):
            for j in range(k):
                may_redraw = n_chunks is not None and _redraw_possible(
                    self.host_t, self.host_budget, self.host_conv,
                    self.host_tol, j, n_chunks)
                phi, carry, st, self.t, self.conv, self.delta = self._step(
                    data, stream_data, phi, carry, st, self.t, self.conv,
                    self.budget, self.tol, self.delta, self.hyper,
                    may_redraw)
        if ex is not None:          # every rank's rows back together
            phi, carry, st = (sharding.gather_tree(v, s, ex)
                              for v, s in zip((phi, carry, st), specs[2:]))
        self.phi, self.carry, self.stream = phi, carry, st

    def fetch_flags(self) -> None:
        """Sync the small per-slot flag vectors device -> host (and read
        the slice's taps, whose work is then done)."""
        with telemetry.span("driver/sync"):
            self.host_t = self.t.cpu().numpy().astype(np.int64)
            self.host_conv = self.conv.cpu().numpy().astype(bool)
            self.host_delta = self.delta.cpu().numpy().astype(np.float64)
        if self._taps is not None:
            self._taps.flush()
            self._taps = None

    # -- host-side views --------------------------------------------------
    def done_mask(self) -> np.ndarray:
        return self.host_conv | (self.host_t >= self.host_budget)

    def active_count(self) -> int:
        if self.slots is None:
            return 0
        done = self.done_mask()
        return sum(1 for i, _ in self.slots.occupied() if not done[i])

    @property
    def compiles(self) -> int:
        """The (capacity, k) shapes the fleet's buffers have been stepped
        at, over the group's life: 1 for a fixed-capacity fleet through
        any number of joins and leaves; each `_grow` adds one at its next
        slice.  The analogue of the reference's slice-function traces; on
        the graph path the first slice of a capacity captures its
        iteration (`_run_graphed`)."""
        return self._compiles

    def state_tree(self, i: int) -> dict:
        """One session's full resumable state (the checkpoint payload):
        CLONES of the slot's tensors, queued now, so the next slice's
        in-place writes do not reach them."""
        def own(leaf):
            return leaf[i].clone()

        return dict(phi=own(self.phi), t=own(self.t),
                    carry=_tree_map(own, self.carry),
                    stream=_tree_map(own, self.stream),
                    conv=own(self.conv), budget=own(self.budget),
                    tol=own(self.tol), delta=own(self.delta),
                    data=_tree_map(own, self.data),
                    hyper=_tree_map(own, self.hyper))

    def load_state_tree(self, i: int, tree: dict) -> None:
        for name in ("phi", "t", "carry", "stream", "conv", "budget", "tol",
                     "delta", "hyper"):
            _tree_set(getattr(self, name), i, tree[name])
        self.write_data(i, tree["data"])


class SessionStatus(NamedTuple):
    """Host-side snapshot of one session (admitted, queued or evicted)."""

    rid: str
    t: int                  # absolute iterations actually applied
    budget: int
    converged: bool         # early-stop latch (tol reached)
    done: bool              # converged or budget exhausted
    delta: float            # last applied step's rms phi change
    phi: Any                # (N, P) current natural parameters
    queued: bool = False    # waiting for arrival time or a free slot
    evicted: bool = False   # finished and removed from its fleet slot
    latency_s: float = 0.0  # submit -> finished wall time (0 while open)


def _stream_record(st):
    """A solo session's stream state as a record leaf tree: the epoch
    (a Python int on a solo session) as a 0-dim int64 tensor."""
    if st is None:
        return None
    return st._replace(epoch=torch.tensor(int(st.epoch), dtype=torch.int64,
                                          device=st.perm.device))


# ---------------------------------------------------------------------------
# VBDriver: the continuous-batching scheduler
# ---------------------------------------------------------------------------
class VBDriver:
    """Continuous-batching scheduler for VB sessions.

    slice_iters : device iterations per slice, the scheduling quantum.
    max_fleet : fixed slot capacity per fleet group (arrivals beyond it
        queue until an eviction frees a slot); None = power-of-two
        auto-growth.
    executor : optional `dist.MeshExecutor`: every fleet's node axis
        split over the group's ranks (the fleet axis a leading batch axis
        on each), SPMD (module docstring); its backend must serve
        `device`, and each session's node count must divide evenly.
    bucket : capacity-bucketed admission.  "pow2" (default) pads each
        session's per-node data buffers up to the next power-of-two
        ladder rung (`admission.bucket_capacity`) with mask-zero slots, so
        near-same-shape sessions share one fleet; a float (> 1) is a
        custom ladder growth factor (e.g. 1.25); None keeps exact-shape
        grouping.  Minibatch sessions are never padded (the streaming
        sampler's epoch permutations are a function of the true
        capacity), nor are data the model cannot pad (no
        `pad_to_capacity`, e.g. a LinReg phi* stack).
    bucket_min : smallest ladder rung.
    ckpt_dir / ckpt_every : when set, every `ckpt_every` slices each
        occupied slot's boundary state is handed to the background
        `CheckpointWriter` as `<ckpt_dir>/<rid>.npz`.  Under the executor
        rank 0 alone writes, so `DriverStats.checkpoints` and
        `checkpoint_errors` count rank 0's writes (0 on the others).
    device : where the fleets run; None = the CUDA card (raises without
        one), "cpu" only when asked for.  Each request's model must live
        there.

    Sessions differing ONLY in per-iteration hyperparameters (the
    schedule's tau/d0, ADMM's rho/xi: `engine.hyper_names`) share a fleet:
    those constants are per-slot tensors (`engine.session_hyper`).

    Drive it synchronously (`tick()` / `drain()`) or start the background
    scheduler thread (`start()`), then `submit` / `push_data` /
    `extend_budget` from any thread; control ops apply at slice
    boundaries (the driver lock serializes them with the device loop).
    """

    def __init__(self, *, slice_iters: int = 25,
                 max_fleet: Optional[int] = None, executor=None,
                 bucket: Optional[str | float] = "pow2",
                 bucket_min: int = 8,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 device=None):
        if slice_iters < 1:
            raise ValueError(f"slice_iters must be >= 1: {slice_iters}")
        if max_fleet is not None and max_fleet < 1:
            raise ValueError(f"max_fleet must be >= 1: {max_fleet}")
        if executor is not None and not isinstance(executor,
                                                   collectives.MeshExecutor):
            raise TypeError(f"executor must be a dist.MeshExecutor or None, "
                            f"not {type(executor).__name__}")
        if bucket is None or bucket == "pow2":
            self._bucket_growth = 2.0 if bucket == "pow2" else None
        else:
            self._bucket_growth = float(bucket)
            if self._bucket_growth <= 1.0:
                raise ValueError(f"bucket growth must be > 1.0: {bucket}")
        self.device = device_lib.resolve(device)
        self.bucket = bucket
        self.bucket_min = int(bucket_min)
        self.slice_iters = slice_iters
        self.max_fleet = max_fleet
        self.executor = executor
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self._groups: dict[tuple, FleetGroup] = {}
        self._where: dict[str, tuple[tuple, int]] = {}  # rid -> (key, slot)
        self._queue = ArrivalQueue()
        self._queued: dict[str, dict] = {}              # rid -> entry
        self._finished: dict[str, dict] = {}            # rid -> fin record
        self._meta: dict[str, dict] = {}
        self._order: list[str] = []
        self._counter = 0
        self._clock = 0                 # slice-boundary clock (arrive_at)
        self._slices = 0
        self._n_admitted = 0
        self._n_evicted = 0
        self._occ_active = 0            # sum of active counts over slices
        self._occ_slots = 0             # sum of capacities over slices
        self._writer = CheckpointWriter()
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- admission --------------------------------------------------------
    def _session_key(self, model, topology, schedule, replication,
                     minibatch, data) -> tuple:
        """Fleet-group key: structural signatures (small arrays by
        content digest), shapes of the ALREADY-BUCKETED data, and only
        the hyperparameters the step specializes on: lifted ones
        (`engine.lifted_attr_names` / the schedule's tau and d0) are
        stripped, since per-session values flow through the fleet's
        hyper tensors (or the carry)."""
        topo_sig = admission.static_signature(
            topology, ignore=engine.lifted_attr_names(topology))
        # tau/d0 are dead when eta is fixed and lifted otherwise; only
        # eta_fixed itself picks a static branch (the one-shot jump)
        sched_key = ("eta_fixed", schedule.eta_fixed)
        return (admission.static_signature(model), topo_sig,
                admission.shape_signature(data), sched_key,
                replication, minibatch)

    def _bucket_plan(self, req):
        """(data on the ladder rung, (true_cap, rung)), or (req.data,
        None) when bucketing does not apply: disabled, minibatch, or data
        the model cannot pad."""
        if self.bucket is None or req.minibatch is not None:
            return req.data, None
        pad = getattr(req.model, "pad_to_capacity", None)
        mask_of = getattr(req.model, "data_mask", None)
        if pad is None or mask_of is None:
            return req.data, None
        data = engine._on_device(req.data, self.device)
        try:
            true_cap = int(mask_of(data).shape[1])
        except (ValueError, IndexError):    # e.g. LinReg phi* stack
            return req.data, None
        rung = admission.bucket_capacity(true_cap,
                                         growth=self._bucket_growth,
                                         min_size=self.bucket_min)
        data = pad(data, rung) if rung != true_cap else data
        return data, (true_cap, rung)

    def submit(self, req, *, arrive_at: Optional[int] = None,
               restore_from: Optional[str] = None) -> str:
        """Queue one session (any object with the `VBRequest` fields);
        returns its id.  `arrive_at` defers admission until that slice
        boundary; `restore_from` loads a `save_session` checkpoint (the
        port's or the JAX package's) into the fresh record (the request
        must describe the same shapes), resuming it exactly."""
        if req.n_iters < 1:
            raise ValueError(f"n_iters must be >= 1: {req.n_iters}")
        with telemetry.span("driver/submit") as span_args:
            rid = self._submit(req, arrive_at, restore_from)
            if span_args is not None:
                span_args["rid"] = rid
        self._wake.set()
        return rid

    def _submit(self, req, arrive_at, restore_from) -> str:
        data, bucket = self._bucket_plan(req)
        state = engine.vb_init(
            req.model, data, req.topology, schedule=req.schedule,
            replication=req.replication, init_phi=req.init_phi,
            executor=self.executor, minibatch=req.minibatch,
            diagnostics=False, device=self.device)
        dt, dev = state.phi.dtype, state.phi.device
        hyper = engine.session_hyper(req.topology, req.schedule, dt)
        record = dict(phi=state.phi.contiguous(),
                      t=torch.tensor(state.t, dtype=torch.int64, device=dev),
                      carry=state.carry, stream=_stream_record(state.stream),
                      conv=torch.zeros((), dtype=torch.bool, device=dev),
                      budget=torch.tensor(req.n_iters, dtype=torch.int64,
                                          device=dev),
                      tol=torch.tensor(req.tol, dtype=dt, device=dev),
                      delta=torch.zeros((), dtype=dt, device=dev),
                      data=state.session.data,
                      hyper={k: v.to(dev) for k, v in hyper.items()})
        if restore_from is not None:
            record = ckpt.restore(restore_from, record)
        key = self._session_key(req.model, req.topology, req.schedule,
                                req.replication, req.minibatch, data)
        with self._lock:
            rid = f"s{self._counter:04d}"
            self._counter += 1
            self._order.append(rid)
            at = self._clock if arrive_at is None else int(arrive_at)
            now = time.monotonic()
            self._meta[rid] = dict(submitted=now, finished=None,
                                   arrive_at=at, bucket=bucket,
                                   queued=(self._clock, now))
            entry = dict(rid=rid, key=key, session=state.session,
                         record=record, bucket=bucket)
            self._queued[rid] = entry
            self._queue.push(entry, at)
            self._try_admit()
        return rid

    def _try_admit(self) -> None:
        """Admit every ready arrival that a fleet slot can take (lock
        held).  Fleet-full entries go back on the queue in FIFO order.
        An admission records its slice clock and time in `_meta[rid]`
        ("admitted") and observes the wait since "queued"."""
        for at, seq, entry in self._queue.pop_ready(self._clock):
            rid, rec = entry["rid"], entry["record"]
            if bool(rec["conv"]) or int(rec["t"]) >= int(rec["budget"]):
                # e.g. restored from a finished checkpoint: nothing to run
                self._queued.pop(rid, None)
                self._retire(rid, dict(record=rec, key=entry["key"],
                                       session=entry["session"]))
                continue
            bucket = self._meta[rid].get("bucket")
            group = self._groups.get(entry["key"])
            if group is None:
                group = FleetGroup(entry["session"],
                                   max_fleet=self.max_fleet,
                                   bucket_capacity=(bucket[1] if bucket
                                                    else None),
                                   executor=self.executor)
                self._groups[entry["key"]] = group
            if group.full:
                self._queue.push_entry((at, seq, entry))
                continue
            meta = self._meta[rid]
            clock0, t0 = meta["queued"]
            waited = self._clock - clock0
            with telemetry.span("driver/admit", rid=rid,
                                waited=waited) as span_args:
                slot = group.admit(rid, rec)
                if span_args is not None:
                    span_args["slot"] = slot
            now = time.monotonic()
            meta["admitted"] = (self._clock, now)
            self._queued.pop(rid, None)
            self._where[rid] = (entry["key"], slot)
            self._n_admitted += 1
            group.n_admitted += 1
            telemetry.inc("driver_admitted_total")
            telemetry.observe("driver_queue_wait_slices", waited)
            telemetry.observe("driver_queue_wait_seconds", now - t0)
            if bucket is not None:
                group.pad_frac_sum += (bucket[1] - bucket[0]) / bucket[1]

    def _retire(self, rid: str, fin: dict) -> None:
        self._finished[rid] = fin
        if self._meta[rid]["finished"] is None:
            self._meta[rid]["finished"] = time.monotonic()

    # -- the scheduling loop ----------------------------------------------
    def tick(self) -> int:
        """One slice boundary: admit ready arrivals, queue one slice per
        fleet with active work, take the checkpoint snapshots (clones
        queued before the slice) and hand them to the writer while the
        device runs, then sync flags, evict finished sessions and advance
        the clock.  Returns #sessions still open."""
        with telemetry.span("driver/tick"), self._lock:
            self._try_admit()
            stepped = [g for g in self._groups.values()
                       if g.active_count() > 0]
            snaps = []
            if self.ckpt_dir and self.ckpt_every and stepped \
                    and self._writes_files() \
                    and (self._slices + 1) % self.ckpt_every == 0:
                for g in stepped:       # boundary state, before the slice
                    snaps.extend((rid, g.state_tree(slot))
                                 for slot, rid in g.slots.occupied())
            for g in stepped:
                n_act = g.active_count()
                self._occ_active += n_act
                self._occ_slots += g.capacity
                g.occ_active += n_act
                g.occ_slots += g.capacity
                g.step_slice(self.slice_iters)      # queued on the device
                telemetry.inc("driver_fleet_iterations_total",
                              self.slice_iters)
            if stepped:
                self._slices += 1
            for rid, tree in snaps:     # writer overlaps the device slice
                self._writer.submit(
                    tree, os.path.join(self.ckpt_dir, f"{rid}.npz"))
            for g in stepped:
                g.fetch_flags()                     # device -> host sync
            self._evict_done()
            self._clock += 1
            if telemetry.enabled():
                # fleet health gauges at every slice boundary (one bool
                # check when telemetry is off)
                occ = (self._occ_active / self._occ_slots
                       if self._occ_slots else 0.0)
                telemetry.set_gauge("driver_queue_depth",
                                    len(self._queued))
                telemetry.set_gauge("driver_active", sum(
                    g.active_count() for g in self._groups.values()))
                telemetry.set_gauge("driver_capacity", sum(
                    g.capacity for g in self._groups.values()))
                telemetry.set_gauge("driver_occupancy", occ)
                telemetry.set_gauge("driver_padding_waste",
                                    (1.0 - occ) if self._occ_slots
                                    else 0.0)
            return self._remaining_locked()

    def _evict_done(self) -> None:
        for key, group in self._groups.items():
            if group.slots is None:
                continue
            done = group.done_mask()
            for slot, rid in group.slots.occupied():
                if done[slot]:
                    with telemetry.span("driver/evict", rid=rid, slot=slot):
                        record = group.evict(slot)
                    del self._where[rid]
                    self._n_evicted += 1
                    telemetry.inc("driver_evicted_total")
                    self._retire(rid, dict(record=record, key=key,
                                           session=group.session))

    def _remaining_locked(self) -> int:
        return (sum(g.active_count() for g in self._groups.values())
                + len(self._queued))

    def remaining(self) -> int:
        with self._lock:
            return self._remaining_locked()

    def drain(self, max_slices: Optional[int] = None,
              poll: float = 0.002) -> int:
        """Run until no session is open (or `max_slices` dispatched).
        With the background thread running this just waits; otherwise it
        pumps `tick()` inline.  Returns #sessions still open."""
        if self._thread is not None and self._thread.is_alive():
            while self.remaining() > 0:
                time.sleep(poll)
            self._writer.flush()
            return 0
        n = 0
        left = self.tick()
        while left > 0:
            n += 1
            if max_slices is not None and n >= max_slices:
                break
            left = self.tick()
        self._writer.flush()
        return left

    def start(self) -> None:
        """Start the background scheduler thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            if self.tick() == 0:
                self._wake.clear()
                self._wake.wait(timeout=0.02)

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- observation ------------------------------------------------------
    def status(self, rid: str) -> SessionStatus:
        with telemetry.span("driver/status", rid=rid), self._lock:
            meta = self._meta.get(rid)
            if meta is None:
                raise KeyError(f"unknown session {rid!r}")
            lat = ((meta["finished"] - meta["submitted"])
                   if meta["finished"] is not None else 0.0)
            if rid in self._where:
                key, i = self._where[rid]
                g = self._groups[key]
                t, budget = int(g.host_t[i]), int(g.host_budget[i])
                conv = bool(g.host_conv[i])
                return SessionStatus(
                    rid=rid, t=t, budget=budget, converged=conv,
                    done=conv or t >= budget, delta=float(g.host_delta[i]),
                    phi=g.phi[i].clone(), latency_s=lat)
            rec = (self._finished[rid]["record"] if rid in self._finished
                   else self._queued[rid]["record"])
            t, budget = int(rec["t"]), int(rec["budget"])
            conv = bool(rec["conv"])
            return SessionStatus(
                rid=rid, t=t, budget=budget, converged=conv,
                done=conv or t >= budget, delta=float(rec["delta"]),
                phi=rec["phi"], queued=rid in self._queued,
                evicted=rid in self._finished, latency_s=lat)

    @property
    def sessions(self) -> list[str]:
        with self._lock:
            return list(self._order)

    def _bucket_stats(self) -> tuple:
        out = []
        for g in self._groups.values():
            data = g.data if g.data is not None else g.session.data
            n_nodes = engine._leaves(data)[0].shape[
                1 if g.data is not None else 0]
            cap = g.bucket_capacity
            label = (f"{type(g.session.model).__name__}/N{n_nodes}/"
                     + (f"cap{cap}" if cap is not None else "exact"))
            occ = g.occ_active / g.occ_slots if g.occ_slots else 0.0
            out.append(BucketStats(
                label=label, bucket_capacity=cap, slots=g.capacity,
                admitted=g.n_admitted, active=g.active_count(),
                occupancy=occ,
                padding_waste=(1.0 - occ) if g.occ_slots else 0.0,
                data_pad_frac=(g.pad_frac_sum / g.n_admitted
                               if g.n_admitted else 0.0)))
        return tuple(sorted(out, key=lambda b: b.label))

    def stats(self) -> DriverStats:
        with self._lock:
            active = sum(g.active_count() for g in self._groups.values())
            capacity = sum(g.capacity for g in self._groups.values())
            compiles = sum(g.compiles for g in self._groups.values())
            occ = (self._occ_active / self._occ_slots
                   if self._occ_slots else 0.0)
            return DriverStats(
                slices=self._slices, compiles=compiles,
                admitted=self._n_admitted, evicted=self._n_evicted,
                queue_depth=len(self._queued), active=active,
                capacity=capacity, occupancy=occ,
                padding_waste=(1.0 - occ) if self._occ_slots else 0.0,
                checkpoints=self._writer.completed,
                buckets=self._bucket_stats(),
                checkpoint_errors=self._writer.errors)

    # -- mid-flight control ops (apply at slice boundaries) ---------------
    def push_data(self, rid: str, node: int, points: Any) -> None:
        """Append freshly-arrived observations to one node's buffer (into
        padding slots: `model.append_node_data`) and un-latch the
        session's convergence flag.  An EVICTED session whose budget
        still has room goes back through the arrival queue and resumes in
        any free slot (absolute-t contract).

        A BUCKETED session whose buffer overflows is not an error: the
        session is evicted from its fleet, its buffers regrown to the
        next ladder rung that fits, and it re-enters the queue under the
        larger bucket's group key."""
        with self._lock:
            if rid in self._where:
                key, i = self._where[rid]
                g = self._groups[key]
                data_i = _tree_index(g.data, i)
                try:
                    new = g.session.model.append_node_data(data_i, node,
                                                           points)
                except ValueError:
                    if self._meta[rid].get("bucket") is None:
                        raise
                    record = g.evict(i)
                    del self._where[rid]
                    self._n_evicted += 1
                    self._retire(rid, dict(record=record, key=key,
                                           session=g.session))
                    self._rebucket(rid, node, points)
                    self._maybe_requeue(rid)
                else:
                    g.write_data(i, new)
                    g.conv[i] = False
                    g.host_conv[i] = False
            elif rid in self._finished or rid in self._queued:
                fin = (self._finished.get(rid) or self._queued[rid])
                rec = fin["record"]
                try:
                    rec["data"] = fin["session"].model.append_node_data(
                        rec["data"], node, points)
                except ValueError:
                    if self._meta[rid].get("bucket") is None:
                        raise
                    self._rebucket(rid, node, points)
                else:
                    rec["conv"] = torch.zeros_like(rec["conv"])
                if rid in self._finished:
                    self._maybe_requeue(rid)
            else:
                raise KeyError(f"unknown session {rid!r}")
        self._wake.set()

    def _rebucket(self, rid: str, node: int, points: Any) -> None:
        """Grow an overflowing bucketed session to the next ladder rung
        that fits `points`, append them, and re-key it (lock held; the
        rid is in `_finished` or `_queued`)."""
        fin = self._finished.get(rid) or self._queued[rid]
        rec, ses = fin["record"], fin["session"]
        model = ses.model
        true_cap, rung = self._meta[rid]["bucket"]
        data = rec["data"]
        for _ in range(64):             # each rung at least doubles room
            rung = admission.bucket_capacity(
                rung + 1, growth=self._bucket_growth,
                min_size=self.bucket_min)
            grown = model.pad_to_capacity(data, rung)
            try:
                grown = model.append_node_data(grown, node, points)
                break
            except ValueError:
                continue
        else:
            raise ValueError(
                f"session {rid!r}: could not grow buffers to fit "
                "pushed points")
        rec["data"] = grown
        rec["conv"] = torch.zeros_like(rec["conv"])
        telemetry.inc("driver_rebucket_total")
        telemetry.instant("driver/rebucket", rid=rid, rung=rung)
        self._meta[rid]["bucket"] = (true_cap, rung)
        fin["session"] = dataclasses.replace(
            ses, data=grown, stream_data=engine._stream_data(model, grown))
        fin["key"] = self._session_key(model, ses.topology, ses.schedule,
                                       ses.replication, ses.minibatch,
                                       grown)

    def replace_data(self, rid: str, data: Any) -> None:
        """Replace a session's data buffers wholesale (same shapes; a
        bucketed session accepts any data that pads to its rung)."""
        with self._lock:
            data = engine._on_device(data, self.device)
            bucket = self._meta.get(rid, {}).get("bucket")
            if bucket is not None:
                if rid in self._where:
                    model = self._groups[self._where[rid][0]].session.model
                else:
                    fin = (self._finished.get(rid)
                           or self._queued.get(rid))
                    model = fin["session"].model if fin else None
                if model is not None:
                    data = model.pad_to_capacity(data, bucket[1])
            cur = self._current_data(rid)
            sig_new = admission.shape_signature(data)
            sig_old = admission.shape_signature(cur)
            if sig_new != sig_old:
                raise ValueError(
                    f"replace_data: shape signature mismatch "
                    f"({sig_new} != {sig_old})")
            if rid in self._where:
                key, i = self._where[rid]
                g = self._groups[key]
                g.write_data(i, data)
                g.conv[i] = False
                g.host_conv[i] = False
            else:
                fin = (self._finished.get(rid) or self._queued[rid])
                fin["record"]["data"] = data
                fin["record"]["conv"] = torch.zeros_like(
                    fin["record"]["conv"])
                if rid in self._finished:
                    self._maybe_requeue(rid)
        self._wake.set()

    def _current_data(self, rid: str):
        if rid in self._where:
            key, i = self._where[rid]
            return _tree_index(self._groups[key].data, i)
        if rid in self._finished:
            return self._finished[rid]["record"]["data"]
        if rid in self._queued:
            return self._queued[rid]["record"]["data"]
        raise KeyError(f"unknown session {rid!r}")

    def extend_budget(self, rid: str, extra_iters: int) -> None:
        with self._lock:
            if rid in self._where:
                key, i = self._where[rid]
                g = self._groups[key]
                g.budget[i] += extra_iters
                g.conv[i] = False
                g.host_budget[i] += extra_iters
                g.host_conv[i] = False
            elif rid in self._finished or rid in self._queued:
                fin = (self._finished.get(rid) or self._queued[rid])
                rec = fin["record"]
                rec["budget"] = rec["budget"] + extra_iters
                rec["conv"] = torch.zeros_like(rec["conv"])
                if rid in self._finished:
                    self._maybe_requeue(rid)
            else:
                raise KeyError(f"unknown session {rid!r}")
        self._wake.set()

    def _maybe_requeue(self, rid: str) -> None:
        """Re-queue an evicted session that has work again (new data or
        extended budget); absolute-t resumability makes re-admission into
        any free slot safe."""
        fin = self._finished[rid]
        rec = fin["record"]
        if bool(rec["conv"]) or int(rec["t"]) >= int(rec["budget"]):
            return
        del self._finished[rid]
        self._meta[rid]["finished"] = None
        self._meta[rid]["queued"] = (self._clock, time.monotonic())
        telemetry.inc("driver_requeue_total")
        telemetry.instant("driver/requeue", rid=rid)
        entry = dict(rid=rid, key=fin["key"], session=fin["session"],
                     record=rec)
        self._queued[rid] = entry
        self._queue.push(entry, self._clock)
        self._try_admit()

    # -- checkpointing ----------------------------------------------------
    def save_session(self, rid: str, path: str, *, wait: bool = True) -> str:
        """Write one session's full resumable state (incl. data buffers
        and budget bookkeeping) as a `checkpoint/ckpt.py` .npz, the
        reference's file format (either package resumes the other's).
        With `wait=False` the device-to-host copy and compression happen
        on the background writer thread (call `flush_checkpoints`, or
        rely on `drain`, before reading the file).

        Under the executor every rank calls it (SPMD) and rank 0 writes;
        with `wait` the ranks then agree on the outcome (one `psum`), so
        a failed write raises on every rank, and the file is on disk
        when any rank returns."""
        with self._lock:
            if rid in self._where:
                key, i = self._where[rid]
                tree = self._groups[key].state_tree(i)
            elif rid in self._finished:
                tree = dict(self._finished[rid]["record"])
            elif rid in self._queued:
                tree = dict(self._queued[rid]["record"])
            else:
                raise KeyError(f"unknown session {rid!r}")
        if not self._writes_files():
            pending = None
        else:
            pending = self._writer.submit(tree, path)
        if not wait:
            return path
        if self.executor is None:
            return pending.wait()
        exc = None
        if pending is not None:
            try:
                pending.wait()
            except Exception as e:      # re-raised below, after the psum
                exc = e
        failed = collectives.psum(torch.tensor(
            [int(exc is not None)], dtype=torch.int32, device=self.device),
            self.executor)
        if exc is not None:
            raise exc
        if int(failed.item()):
            raise RuntimeError(f"rank 0 failed to write checkpoint {path!r}")
        return path

    def flush_checkpoints(self) -> None:
        """Wait for the background writes.  Under the executor every rank
        calls it, and it returns once rank 0's files are on disk."""
        self._writer.flush()
        if self.executor is not None:
            collectives.psum(torch.zeros(1, dtype=torch.int32,
                                         device=self.device), self.executor)

    def _writes_files(self) -> bool:
        """Whether this process writes the checkpoint files: always on
        the single-array executor, rank 0 alone under the mesh executor."""
        return (self.executor is None
                or collectives.axis_index(self.executor) == 0)
