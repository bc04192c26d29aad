"""Multi-tenant VB serving: fleets of sensor-network sessions (port of
`repro.serving.vb_service`).

A `VBRequest` is one independent sensor network (dataset + topology +
hyper + iteration budget); the `VBService` is the stable public API over
the continuous-batching scheduler in `serving/driver.py`:

* **admits** requests into fleet groups keyed by the BUCKETED data shape
  signature plus the static run configuration: per-node data buffers are
  padded with mask-zero slots up to a shared capacity-ladder rung
  (`admission.bucket_capacity`) and per-iteration hyperparameters such
  as the schedule's tau or ADMM's rho are per-slot fleet tensors
  (`engine.hyper_names`), so mixed-shape, mixed-hyper tenants run as ONE
  device batch;
* **fleet-batches** each group along a leading slot axis: one iteration
  of the whole fleet is `engine.fleet_step_fn`, whose local step is one
  kernel launch over the fleet's (S N, T, D) data (for the GMM on the
  fused backend, one `gmm_estep_nodes` launch);
* **schedules continuously** (`serving/driver.py`): sessions join and
  leave their fleet mid-flight with no reallocation (fixed-capacity
  slots with `max_fleet`, power-of-two growth otherwise), finished
  sessions are EVICTED at slice boundaries so their slots go back to the
  arrival queue, and `run` is a drive-to-drain wrapper over
  `driver.tick()`; `start()` / `drain()` / `stop()` expose the background
  scheduler thread for real-time arrival workloads;
* supports **mid-flight data arrival** between slices: `push_data`
  appends new observations into a node's padding slots
  (`model.append_node_data`, fixed-capacity buffers) and `replace_data`
  swaps a session's buffers wholesale; both un-latch the session's
  convergence flag, re-queueing an already-evicted session;
* **checkpoints** sessions in the reference's file format
  (`checkpoint/ckpt.py`): `save_session` writes one session's full
  resumable state (phi, absolute t, topology carry, stream state,
  budget/tol bookkeeping, data buffers), on the background
  `CheckpointWriter` thread with `wait=False`, and `submit(request,
  restore_from=path)` resumes it, from the port's file or the JAX
  package's.

Example::

    svc = VBService(slice_iters=20, max_fleet=8)
    rid = svc.submit(VBRequest(model=mdl, data=(x, mask),
                               topology=engine.Diffusion(W),
                               n_iters=400, tol=1e-8))
    results = svc.run()            # drive every admitted session to done
    results[rid].phi               # (N, P) final natural parameters
    svc.stats()                    # DriverStats: compiles/occupancy/...

Runs on the CUDA card unless built with `device="cpu"` (the models must
live on the same device).  `executor=` (the mesh executor) is not ported:
ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

from repro_torch.core import engine
from repro_torch.data import stream as stream_lib
from repro_torch.serving.driver import (DriverStats, SessionStatus,  # noqa: F401
                                        VBDriver)


class VBRequest(NamedTuple):
    """One tenant: an independent sensor network to run to convergence.

    model / data / topology / schedule / replication / minibatch mean
    exactly what they mean for `engine.run_vb`; `n_iters` is the
    iteration BUDGET (the session finishes early if `tol` is hit) and
    `tol` (> 0 to enable) is the early-stop threshold on the rms
    per-iteration change of the natural parameters.
    """

    model: Any
    data: Any
    topology: Any
    n_iters: int
    schedule: engine.Schedule = engine.Schedule()
    replication: Optional[float] = None
    init_phi: Any = None
    minibatch: Optional[stream_lib.MinibatchSpec] = None
    tol: float = 0.0


class VBService:
    """Admit, batch, step, stream into, and checkpoint VB sessions.

    slice_iters : iterations per slice, the scheduling quantum: between
        slices the driver admits arrivals, evicts finished sessions,
        applies pushed data, checkpoints, or answers status.
    executor : not ported (ROADMAP Queue 1 item 14); raises when given.
    max_fleet : fixed fleet capacity (continuous batching: arrivals
        beyond it queue until an eviction frees a slot); None =
        power-of-two growth.
    bucket / bucket_min : capacity-bucketed admission (see `VBDriver`):
        "pow2" (default), a float growth factor > 1, or None for
        exact-signature grouping only.
    ckpt_dir / ckpt_every : background-checkpoint every occupied slot
        each `ckpt_every` slices into `<ckpt_dir>/<rid>.npz`.
    device : where the fleets run (None = the CUDA card).
    """

    def __init__(self, *, slice_iters: int = 25, executor=None,
                 max_fleet: Optional[int] = None,
                 bucket: Optional[str | float] = "pow2",
                 bucket_min: int = 8,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 device=None):
        self.driver = VBDriver(slice_iters=slice_iters, executor=executor,
                               max_fleet=max_fleet, bucket=bucket,
                               bucket_min=bucket_min, ckpt_dir=ckpt_dir,
                               ckpt_every=ckpt_every, device=device)

    @property
    def slice_iters(self) -> int:
        return self.driver.slice_iters

    @property
    def executor(self):
        return self.driver.executor

    @property
    def _groups(self):
        return self.driver._groups

    # -- admission --------------------------------------------------------
    def submit(self, req: VBRequest, *, arrive_at: Optional[int] = None,
               restore_from: Optional[str] = None) -> str:
        """Admit one session; returns its id.  `arrive_at` defers
        admission to that slice boundary; `restore_from` loads a
        `save_session` checkpoint into the fresh slot (the request must
        describe the same shapes), resuming it exactly."""
        return self.driver.submit(req, arrive_at=arrive_at,
                                  restore_from=restore_from)

    # -- stepping ---------------------------------------------------------
    def step_slice(self) -> int:
        """Advance every group with active sessions by one slice (one
        driver tick); returns the number of sessions still open."""
        return self.driver.tick()

    def run(self, max_slices: Optional[int] = None):
        """Drive every submitted session to done (or `max_slices`);
        returns {rid: SessionStatus}."""
        n = 0
        while self.driver.tick() > 0:
            n += 1
            if max_slices is not None and n >= max_slices:
                break
        self.driver.flush_checkpoints()
        return {rid: self.status(rid) for rid in self.driver.sessions}

    def start(self) -> None:
        """Start the background scheduler: submissions and pushed data
        are picked up at slice boundaries without a host driving loop."""
        self.driver.start()

    def drain(self) -> None:
        """Block until every submitted session is done (background or
        inline) and all background checkpoint writes landed."""
        self.driver.drain()

    def stop(self) -> None:
        self.driver.stop()

    # -- observation ------------------------------------------------------
    def status(self, rid: str) -> SessionStatus:
        return self.driver.status(rid)

    def stats(self) -> DriverStats:
        return self.driver.stats()

    @property
    def sessions(self) -> list[str]:
        return self.driver.sessions

    # -- mid-flight data arrival -----------------------------------------
    def push_data(self, rid: str, node: int, points: Any) -> None:
        """Append freshly-arrived observations to one node's buffer
        (into padding slots, `model.append_node_data`) and un-latch the
        session's convergence flag so it keeps iterating on the new
        evidence; an evicted session re-enters the arrival queue."""
        self.driver.push_data(rid, node, points)

    def replace_data(self, rid: str, data: Any) -> None:
        """Replace a session's data buffers wholesale (same shapes)."""
        self.driver.replace_data(rid, data)

    def extend_budget(self, rid: str, extra_iters: int) -> None:
        self.driver.extend_budget(rid, extra_iters)

    # -- checkpointing ----------------------------------------------------
    def save_session(self, rid: str, path: str, *, wait: bool = True) -> str:
        """Write one session's full resumable state (incl. data buffers
        and budget bookkeeping) as a `checkpoint/ckpt.py` .npz; with
        `wait=False` the write happens on the background writer."""
        return self.driver.save_session(rid, path, wait=wait)
