"""The port's telemetry through the serving driver, on the CPU, against
the JAX driver (8 nodes x 10 points, K=3, D=2, f64).

* A traced fleet run (tests/test_telemetry.py's `_run_fleet`: 3 ring
  sessions, `max_fleet=2`, slices of 8, a checkpoint every 2 slices):
  its counters and gauges (name, labels, value), its histogram counts,
  its span-name set and its event counts equal the JAX driver's run
  plus the port's own names (`NEW_SPANS`, `NEW_COUNTERS`, `NEW_HISTS`),
  which are checked on their own; one `driver/slice` span a slice;
  `driver/compile` nested in the first slice, the slice in its tick.
* A push that overflows a bucketed session's rung and a budget extended
  after eviction: the rebucket, requeue, admission and eviction counters
  and events equal the JAX driver's, the port's own names apart.
* A disabled run leaves the registry and the tracer empty; telemetry
  does not move a tenant's result.
* A failing checkpoint write is counted (`driver_checkpoint_errors_total`,
  `DriverStats.checkpoint_errors`) and does not stop the scheduler.
* Taps in a fleet: a slice's taps land in a window read by `fetch_flags`,
  one (S,) record per iteration (`stream/epoch`, the SVRG refresh), each
  slot's values those of its solo run at the same t.
"""
import collections
import os

import jax
import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import model as jm
from repro.data import synthetic as js
from repro.serving.vb_service import VBRequest as JRequest
from repro.serving.vb_service import VBService as JService
from repro_torch import telemetry
from repro_torch.core import engine, expfam
from repro_torch.core import model as model_lib
from repro_torch.data import stream, synthetic
from repro_torch.serving import driver as drv
from repro_torch.serving.vb_service import VBRequest, VBService
from repro_torch.telemetry import taps

K, D, N = 3, 2, 8
GAUGES = ("driver_queue_depth", "driver_active", "driver_capacity",
          "driver_occupancy", "driver_padding_waste")
# the port's names beyond the JAX driver's catalogue
NEW_SPANS = {"driver/tick", "driver/submit", "driver/status"}
NEW_COUNTERS = {"driver_fleet_iterations_total",
                "driver_graph_replays_total"}
NEW_HISTS = {"driver_queue_wait_slices", "driver_queue_wait_seconds"}


def _shared(d: dict, new: set) -> dict:
    """`d` without the keys (or (name, labels) keys) named in `new`."""
    return {k: v for k, v in d.items()
            if (k[0] if isinstance(k, tuple) else k) not in new}


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """JAX in f64; one torch intra-op thread (see test_torch_vb_driver)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
    torch.set_num_threads(n)


def _off():
    for mod in (telemetry, jtel):
        mod.disable()
        mod.taps.disable()
        mod.reset()


@pytest.fixture(autouse=True)
def _clean():
    _off()
    yield
    _off()


@pytest.fixture(scope="module")
def models():
    jprior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    tprior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                         device="cpu")
    return (jm.GMMModel(jprior, K, D),
            model_lib.GMMModel(tprior, K, D, device="cpu"))


def _data(pkg, n_per, seed):
    d = (js if pkg == "jax" else synthetic).paper_synthetic(
        n_nodes=N, n_per_node=n_per, seed=seed)
    return d.x, d.mask


def _service(pkg, **kw):
    if pkg == "jax":
        return JService(**kw), JRequest, je
    return VBService(device="cpu", **kw), VBRequest, engine


def _run_fleet(pkg, models, ckpt_dir=None, n_sessions=3):
    """tests/test_telemetry.py's `_run_fleet` in either package."""
    mdl = models[0] if pkg == "jax" else models[1]
    svc, req, eng = _service(pkg, slice_iters=8, max_fleet=2,
                             ckpt_dir=ckpt_dir,
                             ckpt_every=2 if ckpt_dir else 0)
    rids = []
    for s in range(n_sessions):
        rids.append(svc.submit(req(model=mdl, data=_data(pkg, 10, s),
                                   topology=eng.RingDiffusion(),
                                   n_iters=16 + 8 * (s % 2))))
    out = svc.run()
    return svc.stats(), out, rids


def _recorded(tel):
    """(counters and gauges {(name, labels): value}, histogram counts,
    span-name set, {event name: count})."""
    scalars, hists = {}, {}
    for r in tel.snapshot():
        key = (r["name"], tuple(sorted(r["labels"].items())))
        if r["kind"] == "histogram":
            hists[key] = r["count"]
        else:
            scalars[key] = r["value"]
    events = {}
    for e in tel.tracer().to_chrome()["traceEvents"]:
        events[e["name"]] = events.get(e["name"], 0) + 1
    return scalars, hists, set(tel.tracer().span_names()), events


def test_traced_fleet_run_equals_reference(models, tmp_path):
    got = {}
    for pkg, tel in (("jax", jtel), ("torch", telemetry)):
        tel.enable()
        st, _, _ = _run_fleet(pkg, models, str(tmp_path / pkg))
        tel.disable()
        got[pkg] = (st, *_recorded(tel))
    evs = telemetry.tracer().to_chrome()["traceEvents"]
    (jst, jsc, jh, jnames, jev), (tst, tsc, th, tnames, tev) = (
        got["jax"], got["torch"])
    assert tst.compiles == jst.compiles == 1
    assert tst.slices == jst.slices and tst.evicted == 3
    assert tst.checkpoints == jst.checkpoints > 0
    assert _shared(tsc, NEW_COUNTERS) == jsc
    assert _shared(th, NEW_HISTS) == jh
    assert tnames == jnames | NEW_SPANS and not jnames & NEW_SPANS
    assert _shared(tev, NEW_SPANS) == jev
    # the port's own: a tick span a tick (here one slice each), a submit
    # and a status span a session, k iterations a slice, a wait an
    # admission
    assert tev["driver/tick"] == tst.slices == 4
    assert tev["driver/submit"] == tev["driver/status"] == 3
    assert tsc[("driver_fleet_iterations_total", ())] == tst.slices * 8
    # the CPU runs every slice on the eager loop: no replay, no capture
    assert tsc[("driver_graph_replays_total", ())] == 0
    assert ("driver_graph_captures_total", ()) not in tsc
    assert th[("driver_queue_wait_slices", ())] == th[
        ("driver_queue_wait_seconds", ())] == tst.admitted == 3
    assert {"driver/slice", "driver/compile", "driver/sync",
            "driver/checkpoint", "driver/admit", "driver/evict"} <= tnames
    assert tev["driver/slice"] == tst.slices and tev["driver/compile"] == 1
    assert {g for (g, _) in tsc} >= set(GAUGES)
    assert tsc[("driver_checkpoints_total", ())] == tst.checkpoints
    assert 0.0 <= tsc[("driver_occupancy", ())] <= 1.0
    # the compile span nests in the first slice's
    first = min((e for e in evs if e["name"] == "driver/slice"),
                key=lambda e: e["ts"])
    (comp,) = [e for e in evs if e["name"] == "driver/compile"]
    assert first["ts"] <= comp["ts"]
    assert comp["ts"] + comp["dur"] <= first["ts"] + first["dur"] + 1e-6
    assert first["args"] == {"k": 8, "slots": 2, "parent": "driver/tick"}
    assert comp["args"] == {"k": 8, "slots": 2, "parent": "driver/slice"}
    parents = {(e["name"], e.get("args", {}).get("parent")) for e in evs
               if e["name"] in ("driver/sync", "driver/evict",
                                "driver/admit")}
    assert parents == {("driver/sync", "driver/tick"),
                       ("driver/evict", "driver/tick"),
                       ("driver/admit", "driver/submit"),
                       ("driver/admit", "driver/tick")}


def _push_scenario(pkg, models):
    """A full rung-8 session pushed 3 points after one slice (evicted,
    re-bucketed to rung 16, re-queued) beside a ring session that
    converges, then has its budget extended (re-queued)."""
    mdl = models[0] if pkg == "jax" else models[1]
    svc, req, eng = _service(pkg, slice_iters=5, max_fleet=2)
    a = svc.submit(req(model=mdl, data=_data(pkg, 8, 0),
                       topology=eng.RingDiffusion(), n_iters=20))
    b = svc.submit(req(model=mdl, data=_data(pkg, 10, 1),
                       topology=eng.RingDiffusion(), n_iters=10))
    svc.step_slice()
    svc.push_data(a, node=1,
                  points=np.random.default_rng(7).normal(size=(3, D)))
    svc.run()
    svc.extend_budget(b, 5)
    svc.run()
    return svc.stats()


def test_rebucket_and_requeue_counted_as_reference(models):
    got = {}
    for pkg, tel in (("jax", jtel), ("torch", telemetry)):
        tel.enable()
        st = _push_scenario(pkg, models)
        tel.disable()
        got[pkg] = (st, *_recorded(tel))
        tel.reset()
    (jst, jsc, jh, jnames, jev), (tst, tsc, th, tnames, tev) = (
        got["jax"], got["torch"])
    assert _shared(tsc, NEW_COUNTERS) == jsc
    assert _shared(th, NEW_HISTS) == jh
    assert tnames == jnames | NEW_SPANS
    assert _shared(tev, NEW_SPANS) == jev
    assert tev["driver/submit"] == 2 and tev["driver/status"] == 4
    assert tev["driver/tick"] >= tst.slices
    # k iterations a group stepped: here two groups share some ticks
    assert tsc[("driver_fleet_iterations_total", ())] == \
        tev["driver/slice"] * 5 > tst.slices * 5
    assert th[("driver_queue_wait_slices", ())] == tst.admitted
    assert tsc[("driver_rebucket_total", ())] == 1.0
    assert tsc[("driver_requeue_total", ())] == 2.0
    assert tsc[("driver_admitted_total", ())] == tst.admitted == 4
    assert {"driver/rebucket", "driver/requeue"} <= tnames
    assert tsc[("admission_bucket_total", (("rung", 16),))] >= 1


def test_disabled_driver_leaves_no_telemetry(models):
    st, out, rids = _run_fleet("torch", models)
    assert st.compiles == 1
    assert len(telemetry.registry()) == 0
    assert len(telemetry.tracer()) == 0
    assert taps.names() == []
    telemetry.enable()
    taps.enable()
    _, out_on, rids_on = _run_fleet("torch", models)
    for a, b in zip(rids, rids_on):
        assert torch.equal(out[a].phi, out_on[b].phi)


def _blocked_dir(tmp_path) -> str:
    """A checkpoint 'directory' below a regular file: every write fails."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    return str(blocker / "sub")


def test_checkpoint_failures_counted_scheduler_survives(models, tmp_path):
    telemetry.enable()
    w = drv.CheckpointWriter()
    tree = dict(t=torch.tensor(3), budget=torch.tensor(5), stream=None,
                phi=torch.zeros(2, 4, dtype=torch.float64))
    pending = w.submit(tree, os.path.join(_blocked_dir(tmp_path), "x.npz"))
    with pytest.raises(OSError):
        pending.wait()
    good = str(tmp_path / "ok.npz")
    assert w.submit(tree, good).wait() == good
    assert w.errors == 1 and w.completed == 1
    rows = {r["name"]: r for r in telemetry.snapshot()}
    assert rows["driver_checkpoint_errors_total"]["value"] == 1.0
    assert rows["driver_checkpoints_total"]["value"] == 1.0
    assert rows["driver_checkpoint_write_seconds"]["count"] == 1
    assert "driver/checkpoint" in telemetry.tracer().span_names()
    # every periodic autosave fails; the fleet still drains
    (tmp_path / "x").mkdir()
    svc = VBService(slice_iters=8, max_fleet=2, device="cpu",
                    ckpt_dir=_blocked_dir(tmp_path / "x"), ckpt_every=1)
    rids = [svc.submit(VBRequest(model=models[1], data=_data("torch", 10, s),
                                 topology=engine.RingDiffusion(),
                                 n_iters=16)) for s in range(3)]
    out = svc.run()
    st = svc.stats()
    assert all(out[r].done for r in rids)
    assert st.checkpoint_errors > 0 and st.checkpoints == 0
    rows = {r["name"]: r for r in telemetry.snapshot()}
    assert rows["driver_checkpoint_errors_total"]["value"] == \
        1.0 + st.checkpoint_errors


def test_fleet_taps_per_slot_match_solo_runs(models):
    """Two SVRG streams (B = 4 of 10 points) in a fleet of 2, slices of 4:
    taps give one (2,) record per fleet iteration (`stream/epoch` every
    iteration, the anchor refresh where one was possible), read at the
    slice boundary; each slot's epoch at each t is its solo run's, and
    each solo refresh shows in the fleet's records."""
    mdl = models[1]
    spec = stream.MinibatchSpec(4, seed=1, control_variate="svrg")
    W = torch.full((N, N), 1.0 / N, dtype=torch.float64)
    reqs = [VBRequest(model=mdl, data=_data("torch", 10, s),
                      topology=engine.Diffusion(W), n_iters=12,
                      minibatch=spec) for s in range(2)]
    taps.enable()
    solo = []
    for r in reqs:
        taps.clear()
        engine.run_vb(r.model, r.data, r.topology, n_iters=12,
                      minibatch=r.minibatch, diagnostics=False,
                      device="cpu")
        solo.append({n: dict(zip(*(a.tolist() for a in taps.series(n))))
                     for n in ("stream/epoch", "stream/svrg_anchor_refresh")})
    taps.clear()
    svc = VBService(slice_iters=4, max_fleet=2, device="cpu")
    for r in reqs:
        svc.submit(r)
    svc.step_slice()
    # the first slice's records are on the host once fetch_flags ran
    assert taps.counts()["stream/epoch"] == 4
    svc.run()
    ts, epochs = taps.series("stream/epoch")
    assert ts.shape == epochs.shape == (12, 2)
    assert ts[:, 0].tolist() == list(range(12))
    for s in range(2):
        assert {t: e for t, e in zip(ts[:, s].tolist(),
                                     epochs[:, s].tolist())} \
            == solo[s]["stream/epoch"]
    rts, refresh = taps.series("stream/svrg_anchor_refresh")
    for s in range(2):
        fleet = dict(zip(rts[:, s].tolist(), refresh[:, s].tolist()))
        want = solo[s]["stream/svrg_anchor_refresh"]
        assert all(want[t] == int(v) for t, v in fleet.items())
        assert {t for t, v in want.items() if v} <= {
            t for t, v in fleet.items() if v}


def test_fused_fleet_times_one_kernel_call_per_fleet_iteration(models):
    """On the fused backend a fleet calls the kernel wrapper once a fleet
    iteration; each call is one `kernel/gmm_estep_nodes` span, nested in
    its slice's, and no metric of its own."""
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device="cpu")
    mdl = model_lib.GMMModel(prior, K, D, backend="fused", device="cpu")
    telemetry.enable()
    svc = VBService(slice_iters=4, max_fleet=2, device="cpu")
    for s in range(2):
        svc.submit(VBRequest(model=mdl, data=_data("torch", 10, s),
                             topology=engine.RingDiffusion(), n_iters=8))
    svc.run()
    st = svc.stats()
    assert not [r for r in telemetry.snapshot()
                if r["name"].startswith("kernel")]
    evs = [e for e in telemetry.tracer().to_chrome()["traceEvents"]
           if e["name"] == "kernel/gmm_estep_nodes"]
    assert len(evs) == st.slices * 4 == 8
    # the first slice's calls nest in its `driver/compile`
    assert collections.Counter(e["args"]["parent"] for e in evs) == {
        "driver/compile": 4, "driver/slice": 4}
