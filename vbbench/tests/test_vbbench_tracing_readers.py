"""The per-layer readers of the program's own tracing records
(`queue_wait_slices`, `slice_host_ms`, `admit_evict_host_ms`,
`submit_host_ms`): each returns the value worked out by hand from the
`Tracer` and the registry that a small fleet run under the profiler
fills (telemetry off, as in the benchmark), and None from empty
records; a traced run of the fleet cell reads exactly its traced window
(the program records nothing outside the profiler)."""
from __future__ import annotations

import pytest
import torch
from conftest import _SMALL_FLEET, run_line
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from vbbench import harness

READERS = ("queue_wait_slices", "slice_host_ms", "admit_evict_host_ms",
           "submit_host_ms")
K, D, N, SLICE = 3, 2, 8, 8


def _read(name: str):
    return harness.load_module("metrics", name).read({})


@pytest.fixture(autouse=True)
def _clean():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _fleet_under_profiler():
    """Three ring sessions of 16, 24 and 16 iterations in a fleet of two
    slots, slices of 8 (the third waits two slices), under the profiler;
    returns the service."""
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
                                     n_iters=16 + 8 * (s % 2)))
            svc.run()
    finally:
        torch.set_num_threads(n_threads)
    return svc


def test_readers_return_hand_computed_values():
    svc = _fleet_under_profiler()
    evs = telemetry.tracer().events
    iters = svc.stats().slices * SLICE

    def total_us(name):
        return sum(e["dur"] for e in evs if e["name"] == name)

    # submit's self time: its spans less the admissions made inside them
    in_submit = sum(e["dur"] for e in evs
                    if e.get("args", {}).get("parent") == "driver/submit")
    waits = [e["args"]["waited"] for e in evs if e["name"] == "driver/admit"]
    want = {"queue_wait_slices": sum(waits) / len(waits),
            "slice_host_ms": total_us("driver/slice") / 1e3 / iters,
            "admit_evict_host_ms": (total_us("driver/admit")
                                    + total_us("driver/evict")) / 1e3 / iters,
            "submit_host_ms": (total_us("driver/submit") - in_submit)
            / 1e3 / iters}
    assert sorted(waits) == [0, 0, 2] and iters == 32 and in_submit > 0
    for name in READERS:
        got = _read(name)
        assert got == pytest.approx(want[name], rel=1e-9), name
        assert got > 0, name


def test_readers_return_none_from_empty_records():
    for name in READERS:
        assert _read(name) is None, name
    # records, but none of the driver's
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("engine/vb_run"):
            telemetry.inc("admission_bucket_total")
    for name in READERS:
        assert _read(name) is None, name


def test_traced_fleet_run_reads_its_traced_window(small_root, capsys):
    """Set-up, warm-up and the untraced window record nothing; the
    traced window's fleet iterations are its ticks times the slice."""
    rc, line, err = run_line(small_root, capsys, "k3d2_1k.fleet64_dsvb",
                             trace=1)
    assert rc == 0, err
    (iters,) = [r["value"] for r in telemetry.snapshot()
                if r["name"] == "driver_fleet_iterations_total"]
    assert iters == _SMALL_FLEET["trace_ticks"] * _SMALL_FLEET["slice_iters"]
    ticks = telemetry.tracer().summary()["driver/tick"][0]
    assert ticks == _SMALL_FLEET["trace_ticks"]
    for name in READERS:
        metric = line["metrics"][f"{name}.fleet"]
        assert metric["value"] == pytest.approx(_read(name), rel=1e-12)
        assert metric["value"] >= 0
