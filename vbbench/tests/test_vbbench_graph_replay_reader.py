"""The per-layer reader `graph_replay_share`: the share of the traced
window's fleet iterations that the program ran as a CUDA graph replay,
from the program's own counters.

* A small fleet run under the profiler on the CPU (telemetry off, as in
  the benchmark) runs every slice on the eager loop: the registry holds
  0 replays over slices x k iterations, and the reader returns 0.
* Counters written by hand (a capture slice's k - 2 replays, then whole
  slices) read back as their share.
* Empty records, or records without VBDriver's counters (a program
  that keeps none), read None.
"""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from vbbench import harness

K, D, N, SLICE = 3, 2, 8, 8


def _read():
    return harness.load_module("metrics", "graph_replay_share").read({})


@pytest.fixture(autouse=True)
def _clean():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def test_profiled_cpu_fleet_reads_zero():
    from repro_torch.core import engine, expfam
    from repro_torch.core import model as model_lib
    from repro_torch.data import synthetic
    from repro_torch.serving.vb_service import VBRequest, VBService

    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device="cpu")
    mdl = model_lib.GMMModel(prior, K, D, device="cpu")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            svc = VBService(slice_iters=SLICE, max_fleet=2, device="cpu")
            for s in range(3):
                d = synthetic.paper_synthetic(n_nodes=N, n_per_node=10,
                                              seed=s)
                svc.submit(VBRequest(model=mdl, data=(d.x, d.mask),
                                     topology=engine.RingDiffusion(),
                                     n_iters=16))
            svc.run()
    finally:
        torch.set_num_threads(n_threads)
    rows = {r["name"]: r["value"] for r in telemetry.snapshot()
            if "value" in r}
    assert rows["driver_fleet_iterations_total"] == svc.stats().slices * SLICE
    assert rows["driver_graph_replays_total"] == 0
    assert _read() == 0.0


def test_hand_written_counters_read_their_share():
    with telemetry.enabled_scope():
        # a capture slice (2 eager iterations, 6 replays), then 3 whole
        # slices of replays
        telemetry.inc("driver_fleet_iterations_total", 4 * SLICE)
        telemetry.inc("driver_graph_replays_total", SLICE - 2)
        telemetry.inc("driver_graph_replays_total", 3 * SLICE)
        telemetry.inc("driver_graph_captures_total")
    assert _read() == pytest.approx(100.0 * 30 / 32, rel=1e-12)


def test_empty_records_read_none():
    assert _read() is None
    with telemetry.enabled_scope():
        telemetry.inc("driver_fleet_iterations_total", SLICE)
    assert _read() is None          # a program with no replay counter
    telemetry.reset()
    with telemetry.enabled_scope():
        telemetry.inc("driver_graph_replays_total", 0)
    assert _read() is None          # no fleet iteration to share
