"""The serving driver's spans and counters on the profiler's timeline, on
the CPU (the port alone: 8 nodes x 10 points, K=3, D=2, f64).

A small fleet (`max_fleet=2`, slices of 8, three ring sessions of 16,
24 and 16 iterations: the third waits for a slot) runs with telemetry
off under `torch.profiler.profile(activities=[CPU])`:

* the driver's spans are profiler ranges: `driver/tick`, `submit`,
  `slice`, `sync`, `admit`, `evict` and `status` are in `prof.events()`,
  and `slice`, `sync`, `admit` and `evict` lie inside a `tick` range;
  the `Tracer` holds the same names (and `driver/compile`, in the first
  slice), each with its parent; a tick after
  the profiler has stopped records nothing;
* `driver_queue_wait_slices` observes the slices each session waited
  for a slot (0, 0 and the third's, counted tick by tick here), and
  `driver_queue_wait_seconds` one wait an admission;
* `driver_fleet_iterations_total` is slices x k.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.core import engine, expfam
from repro_torch.core import model as model_lib
from repro_torch.data import synthetic
from repro_torch.serving.vb_service import VBRequest, VBService

K, D, N, SLICE = 3, 2, 8, 8
SPANS = ("driver/tick", "driver/submit", "driver/slice", "driver/sync",
         "driver/admit", "driver/evict", "driver/status")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


@pytest.fixture(scope="module")
def mdl():
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device="cpu")
    return model_lib.GMMModel(prior, K, D, device="cpu")


def _request(mdl, s):
    d = synthetic.paper_synthetic(n_nodes=N, n_per_node=10, seed=s)
    return VBRequest(model=mdl, data=(d.x, d.mask),
                     topology=engine.RingDiffusion(),
                     n_iters=16 + 8 * (s % 2))


def _fleet(mdl):
    """Submit three sessions, then tick to the end.  Returns (service,
    rids, the slice boundaries each session spent queued, counted from
    outside: the ticks after which its status still read queued)."""
    svc = VBService(slice_iters=SLICE, max_fleet=2, device="cpu")
    rids = [svc.submit(_request(mdl, s)) for s in range(3)]
    waited = {r: 0 for r in rids}
    left = len(rids)
    while left:
        left = svc.step_slice()
        for r in rids:
            waited[r] += svc.status(r).queued
    return svc, rids, waited


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


def test_driver_spans_are_profiler_ranges(mdl):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        svc, rids, _ = _fleet(mdl)
    assert not telemetry.enabled()
    ticks = _ranges(prof, "driver/tick")
    assert len(ticks) == svc.stats().slices
    for name in SPANS:
        assert _ranges(prof, name), name
    for name in ("driver/slice", "driver/sync", "driver/evict"):
        for s, e in _ranges(prof, name):
            assert any(a <= s and e <= b for a, b in ticks), name
    # an admission inside a tick (the third session's) nests in it
    assert any(a <= s and e <= b for s, e in _ranges(prof, "driver/admit")
               for a, b in ticks)
    evs = telemetry.tracer().events
    assert set(telemetry.tracer().span_names()) == {*SPANS, "driver/compile"}
    parents = {(e["name"], e.get("args", {}).get("parent")) for e in evs}
    assert {("driver/slice", "driver/tick"), ("driver/sync", "driver/tick"),
            ("driver/compile", "driver/slice"),
            ("driver/evict", "driver/tick"), ("driver/admit", "driver/tick"),
            ("driver/admit", "driver/submit"), ("driver/tick", None),
            ("driver/submit", None), ("driver/status", None)} == parents
    by_rid = {e["args"]["rid"] for e in evs if e["name"] in (
        "driver/submit", "driver/admit", "driver/evict", "driver/status")}
    assert by_rid == set(rids)
    # outside the profiler, telemetry off: nothing more is recorded
    n, rows = len(telemetry.tracer()), telemetry.snapshot()
    svc.submit(_request(mdl, 3))
    svc.run()
    assert len(telemetry.tracer()) == n and telemetry.snapshot() == rows


def test_queue_wait_and_iterations_counted(mdl):
    with profile(activities=[ProfilerActivity.CPU]):
        svc, rids, waited = _fleet(mdl)
    assert [waited[r] for r in rids[:2]] == [0, 0] and waited[rids[2]] == 2
    rows = {r["name"]: r for r in telemetry.snapshot()}
    slices = rows["driver_queue_wait_slices"]
    assert slices["count"] == 3 and slices["sum"] == waited[rids[2]]
    assert rows["driver_queue_wait_seconds"]["count"] == 3
    assert rows["driver_queue_wait_seconds"]["sum"] > 0
    admits = {e["args"]["rid"]: e["args"] for e in telemetry.tracer().events
              if e["name"] == "driver/admit"}
    assert {r: a["waited"] for r, a in admits.items()} == waited
    assert sorted(a["slot"] for a in admits.values()) == [0, 0, 1]
    st = svc.stats()
    assert rows["driver_fleet_iterations_total"]["value"] == \
        st.slices * SLICE == 32
    assert rows["driver_admitted_total"]["value"] == st.admitted == 3
