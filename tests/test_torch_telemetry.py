"""The port's telemetry (repro_torch.telemetry) against repro.telemetry,
on the CPU.

* Registry and tracer: the same records applied to the reference's and
  the port's `MetricsRegistry` give equal `snapshot()`, `to_jsonl()` and
  `to_prometheus()` text; thread safety; the facade helpers are no-ops
  when disabled; Chrome-trace nesting, each event's `parent` beside the
  reference's events, and the tracer's self times.
* Series and taps: `vb_run/*` series (host telemetry) and `vb/*` taps
  (taps on) of dSVB and adaptive dVB-ADMM at 8 nodes x 20 points in f64
  against the reference's, at the engine parity bar of
  tests/test_torch_engine.py (rtol 1e-9), across a resumed run.
* Disabled is free: aten ops per iteration (a `TorchDispatchMode`
  count) equal disabled and host-enabled, phi bit-equal; with taps on
  phi is bit-equal and the extra ops per iteration are exactly the tap
  copies.
* The backend fallback warns once and counts every fallback; the kernel
  wrappers' `kernel/<name>` spans (and no histogram of their own); the
  `vb_serve` launcher's `--trace` / `--metrics` files.
"""
import collections
import json
import os
import re
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import telemetry as jtel
from repro.core import algorithms as ja
from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import gmm as jg
from repro.core import model as jm
from repro.core import network as jn
from repro.core import refperm as jr
from repro.data import synthetic as js
from repro.kernels import ops as jops
from repro_torch import telemetry
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.kernels import ops
from repro_torch.telemetry import taps

K, D, N_NODES = 3, 2, 8
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _x64_one_thread():
    """JAX in f64; one torch intra-op thread (tiny tensors: a pool of
    threads synchronising on each small op runs ~10x slower when the
    suite's workers share the cores)."""
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
    """Telemetry is process-global: every test starts and ends disabled
    and empty, in both packages."""
    _off()
    yield
    _off()


# ---------------------------------------------------------------------------
# Registry and tracer
# ---------------------------------------------------------------------------
def _apply_records(reg):
    reg.counter("req_total", route="vb").inc()
    reg.counter("req_total", route="vb").inc(2)
    reg.counter("req_total", route="lm").inc(0.5)
    reg.counter("admission_padded_slots_total").inc(42)
    reg.gauge("depth").set(7)
    reg.gauge("driver_occupancy").set(0.5833333333333334)
    reg.gauge("z_level", slot=3, group="A").set(-1.25e-7)
    h = reg.histogram("lat_s", bounds=(0.1, 1.0))
    for v in (0.05, 5.0, 0.1, 1.0, 0.7):
        h.observe(v)
    k = reg.histogram("kernel_wall_seconds", kernel="gmm_estep_nodes")
    for v in (2.9586880207061766e-05, 0.0123, 3.0, 1e7):
        k.observe(v)
    reg.histogram("empty_s")


def test_registry_text_equals_reference():
    ours, ref = telemetry.MetricsRegistry(), jtel.MetricsRegistry()
    for reg in (ours, ref):
        _apply_records(reg)
    assert ours.snapshot() == ref.snapshot()
    assert ours.to_jsonl() == ref.to_jsonl()
    assert ours.to_prometheus() == ref.to_prometheus()
    assert len(ours) == len(ref) == 9
    assert telemetry.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS
    prom = ours.to_prometheus()
    assert 'req_total{route="vb"} 3' in prom
    assert 'lat_s_bucket{le="+Inf"} 5' in prom
    with pytest.raises(ValueError, match="already registered"):
        ours.gauge("req_total", route="vb")
    ours.clear()
    assert ours.to_prometheus() == "" and len(ours) == 0


def test_registry_thread_safety():
    """More threads than cores, a short switch interval: no update of a
    counter, a histogram, a tracer or a tap window is lost."""
    reg, tr = telemetry.MetricsRegistry(), telemetry.Tracer()
    n_threads, n = 4 * (os.cpu_count() or 4), 500

    def work(i):
        w = taps.Window(n)
        with w.collecting():
            for t in range(n):
                reg.counter("n").inc()
                reg.histogram("h").observe(0.5)
                tr.instant("i")
                taps.tap("w", torch.tensor(float(i)), t=t)
        w.flush()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with taps.enabled_scope():
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert reg.counter("n").value == n_threads * n
    assert reg.histogram("h").count == n_threads * n
    assert len(tr) == n_threads * n
    ts, vals = taps.series("w")
    assert len(ts) == n_threads * n
    assert sorted(vals.tolist()) == sorted(float(i) for i in range(
        n_threads) for _ in range(n))


def test_helpers_noop_when_disabled():
    telemetry.inc("x_total")
    telemetry.set_gauge("g", 1.0)
    telemetry.observe("h", 0.5)
    telemetry.instant("ev")
    with telemetry.span("s"):
        pass
    taps.tap("t", torch.ones(2), t=0)
    assert len(telemetry.registry()) == 0
    assert len(telemetry.tracer()) == 0
    assert taps.names() == []
    # the disabled span is one shared null context that yields None, and
    # a run of disabled sites leaves nothing allocated behind it
    assert telemetry.span("a") is telemetry.span("b")
    with telemetry.span("a") as args:
        assert args is None
    import tracemalloc

    def sites():
        for i in range(2000):
            with telemetry.span("s", rid=i):
                telemetry.instant("i", slot=i)
                telemetry.inc("x_total", 2.0)
                telemetry.observe("h", 0.5)

    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        sites()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if "telemetry" in str(d.traceback) and d.size_diff > 0]
    assert not grown, grown
    with telemetry.enabled_scope():
        telemetry.inc("x_total")
        with telemetry.span("s"):
            pass
    assert not telemetry.enabled()
    assert len(telemetry.registry()) == 1
    assert telemetry.tracer().span_names() == ["s"]


def _events(tr):
    """(name, phase, args but the port's `parent`) of each event."""
    out = []
    for e in tr.to_chrome()["traceEvents"]:
        args = {k: v for k, v in e.get("args", {}).items() if k != "parent"}
        out.append((e["name"], e["ph"], args or None))
    return out


def test_tracer_chrome_nesting_matches_reference(tmp_path):
    """The reference's events, and the port's each name its parent (the
    innermost span open on its thread; none at the top level)."""
    trs = (telemetry.Tracer(), jtel.Tracer())
    for tr in trs:
        with tr.span("outer", k=8):
            with tr.span("inner"):
                tr.instant("mark", rid="s0")
    assert _events(trs[0]) == _events(trs[1])
    assert {e["name"]: e["args"].get("parent") for e in trs[0].events} == {
        "outer": None, "inner": "outer", "mark": "inner"}
    assert trs[0].span_names() == trs[1].span_names()
    doc = json.load(open(trs[0].export_chrome_trace(
        str(tmp_path / "trace.json"))))
    assert doc["displayTimeUnit"] == "ms"
    by = {e["name"]: e for e in doc["traceEvents"]}
    outer, inner, mark = by["outer"], by["inner"], by["mark"]
    assert outer["ph"] == "X" and mark["ph"] == "i" and mark["s"] == "t"
    assert outer["tid"] == inner["tid"] == mark["tid"]
    assert outer["ts"] <= inner["ts"] <= mark["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert outer["args"] == {"k": 8}
    assert mark["args"] == {"rid": "s0", "parent": "inner"}
    trs[0].clear()
    assert len(trs[0]) == 0 and trs[0].summary() == {}


def test_tracer_self_time_is_duration_less_children():
    """A hand-built nest (a with two children, one with a child of its
    own, on this thread; b on another thread, not a's child): each
    name's self time is its duration less its children's, and the
    late args a span's block adds are recorded with it."""
    import time
    tr = telemetry.Tracer()

    def leaf():
        with tr.span("b"):
            time.sleep(0.002)

    with tr.span("a") as args:
        time.sleep(0.002)
        with tr.span("c"):
            time.sleep(0.003)
            with tr.span("d"):
                time.sleep(0.002)
        with tr.span("c"):
            time.sleep(0.001)
        th = threading.Thread(target=leaf)
        th.start()
        th.join()
        args["slot"] = 3
    dur = collections.defaultdict(list)
    for e in tr.events:
        dur[e["name"]].append(e["dur"])
    got = tr.summary()
    assert {n: v[0] for n, v in got.items()} == {"a": 1, "b": 1, "c": 2,
                                                 "d": 1}
    for n, v in dur.items():
        assert got[n][1] == pytest.approx(sum(v), rel=1e-12)
    assert got["d"][2] == pytest.approx(dur["d"][0], rel=1e-12)
    assert got["b"][2] == pytest.approx(dur["b"][0], rel=1e-12)
    assert got["c"][2] == pytest.approx(sum(dur["c"]) - dur["d"][0],
                                        rel=1e-9)
    assert got["a"][2] == pytest.approx(
        dur["a"][0] - sum(dur["c"]), rel=1e-9)
    assert got["a"][2] >= 1.5e3            # its own 2 ms sleep
    by = {e["name"]: e for e in tr.events}
    assert by["a"]["args"] == {"slot": 3}
    assert "args" not in by["b"]           # another thread: no parent
    assert by["d"]["args"] == {"parent": "c"}


def test_helpers_record_under_the_profiler():
    """Telemetry off, a torch profiler recording: span, instant, inc and
    observe record, each span also a profiler range; `enabled()` stays
    False; outside the profiler nothing records again."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not telemetry.enabled()
        with telemetry.span("outer", k=1):
            with telemetry.span("inner") as args:
                telemetry.instant("mark")
                telemetry.inc("n_total", 2)
                telemetry.observe("h", 0.5)
                args["late"] = True
    names = [e.name for e in prof.events()]
    assert names.count("outer") == names.count("inner") == 1
    assert telemetry.tracer().span_names() == ["inner", "mark", "outer"]
    rows = {r["name"]: r for r in telemetry.snapshot()}
    assert rows["n_total"]["value"] == 2.0 and rows["h"]["count"] == 1
    by = {e["name"]: e for e in telemetry.tracer().events}
    assert by["inner"]["args"] == {"parent": "outer", "late": True}
    n = len(telemetry.tracer())
    with telemetry.span("after"):
        telemetry.inc("n_total")
    assert len(telemetry.tracer()) == n
    assert {r["name"]: r for r in telemetry.snapshot()}["n_total"][
        "value"] == 2.0


def test_taps_record_series_ordering_and_windows():
    taps.record_series("s", np.arange(6.0).reshape(3, 2),
                       ts=np.array([7, 5, 6]))
    ts, vals = taps.series("s")
    assert ts.tolist() == [5, 6, 7] and vals[0].tolist() == [2.0, 3.0]
    taps.record("r", 1.5)
    assert taps.series("r")[0] is None
    # a window: device copies (here CPU tensors) read at flush, a fleet's
    # (S,) t per record, host values filed at once, out-of-order t sorted
    w = taps.Window(3)
    with taps.enabled_scope(), w.collecting():
        src = torch.zeros(2)
        for t in (4, 2, 3):
            src.fill_(t)                 # written in place after the tap
            taps.tap("fleet", src, t=torch.tensor([t, t + 10]))
            taps.tap("host", t, t=t)
        with pytest.raises(RuntimeError, match="more than 3"):
            taps.tap("fleet", src, t=torch.tensor([0, 0]))
    assert taps.counts() == {"s": 3, "r": 1, "host": 3}
    w.flush()
    ts, vals = taps.series("fleet")
    assert ts.tolist() == [[2, 12], [3, 13], [4, 14]]
    assert vals.tolist() == [[2.0, 2.0], [3.0, 3.0], [4.0, 4.0]]
    assert taps.series("host")[1].tolist() == [2, 3, 4]
    # outside a window: read at once
    with taps.enabled_scope():
        v = torch.arange(4.0)
        taps.tap("loose", v, t=9, mean=True)
        v.zero_()
    assert taps.series("loose")[1].tolist() == [1.5]
    assert sorted(taps.names()) == ["fleet", "host", "loose", "r", "s"]
    taps.clear()
    assert taps.names() == []


# ---------------------------------------------------------------------------
# Series and taps of vb_run against the reference (f64, rtol 1e-9)
# ---------------------------------------------------------------------------
def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def inst():
    """tests/test_torch_engine.py's instance (8 nodes x 20 points)."""
    data = js.paper_synthetic(n_nodes=N_NODES, n_per_node=20, seed=2)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                    dtype=jnp.float64)
    adj, _ = jn.random_geometric_graph(N_NODES, seed=4)
    adj = adj.astype(jnp.float64)
    W = jn.nearest_neighbor_weights(adj).astype(jnp.float64)
    init_q = ja._perturbed_init(prior, data.x, jax.random.PRNGKey(3))
    ref = jr.permuted_refs(jg.ground_truth_posterior(*data.flat, prior, K))
    j = dict(x=data.x, mask=data.mask, prior=prior, adj=adj, W=W,
             init_q=init_q, ref=ref)
    t = dict(x=_t(data.x), mask=_t(data.mask),
             prior=tx.GMMPosterior(*(_t(a) for a in prior)), adj=_t(adj),
             W=_t(W), init_q=tx.GMMPosterior(*(_t(a) for a in init_q)),
             ref=_t(ref))
    return j, t


def _jax_state(j, topo_name):
    mdl = jm.GMMModel(j["prior"], K, D)
    phi0 = jnp.broadcast_to(jx.pack_natural(j["init_q"]),
                            (N_NODES, mdl.flat_dim))
    topo = (je.Diffusion(j["W"]) if topo_name == "dsvb"
            else je.ADMMConsensus(j["adj"], adaptive_rho=True))
    return je.vb_init(mdl, (j["x"], j["mask"]), topo, init_phi=phi0,
                      ref_phi=j["ref"])


def _torch_state(t, topo_name, backend=None):
    mdl = tm.GMMModel(t["prior"], K, D, device="cpu")
    phi0 = tx.pack_natural(t["init_q"]).expand(N_NODES, mdl.flat_dim)
    topo = (te.Diffusion(t["W"]) if topo_name == "dsvb"
            else te.ADMMConsensus(t["adj"], adaptive_rho=True))
    return te.vb_init(mdl, (t["x"], t["mask"]), topo, init_phi=phi0,
                      ref_phi=t["ref"], backend=backend, device="cpu")


SERIES = ("kl_mean", "consensus_msd")
ADMM_SERIES = ("admm_rho", "admm_primal_resid", "admm_dual_resid")


@pytest.mark.parametrize("topo_name", ["dsvb", "admm_adaptive"])
def test_vb_run_series_and_taps_match_reference(inst, topo_name):
    """Host telemetry and taps on, a run of 6 resumed for 5 more: the
    vb_run/* series and the vb/* taps, absolute-t indexed, equal the
    reference's at rtol 1e-9; vb_run/kl_mean is the VBRun's kl_mean bit
    for bit; the engine/vb_run spans carry n_iters."""
    j, t = inst
    names = SERIES + (ADMM_SERIES if topo_name != "dsvb" else ())
    got = {}
    for pkg, mod, make in (("jax", jtel, lambda: _jax_state(j, topo_name)),
                           ("torch", telemetry,
                            lambda: _torch_state(t, topo_name))):
        run_fn = je.vb_run if pkg == "jax" else te.vb_run
        mod.reset()
        mod.enable()
        mod.taps.enable()
        state, run_a = run_fn(make(), 6)
        state, run_b = run_fn(state, 5)
        if pkg == "jax":
            jax.block_until_ready(state.phi)
        got[pkg] = {f"{p}/{n}": mod.taps.series(f"{p}/{n}")
                    for p in ("vb_run", "vb") for n in names}
        got[pkg]["spans"] = [(e["name"], e.get("args")) for e in
                             mod.tracer().to_chrome()["traceEvents"]
                             if e["name"] == "engine/vb_run"]
        if pkg == "torch":
            np.testing.assert_array_equal(
                got[pkg]["vb_run/kl_mean"][1],
                torch.cat([run_a.kl_mean, run_b.kl_mean]).numpy())
        mod.disable()
        mod.taps.disable()
    assert got["torch"]["spans"] == got["jax"]["spans"] == [
        ("engine/vb_run", {"n_iters": 6}), ("engine/vb_run", {"n_iters": 5})]
    for key in got["jax"]:
        if key == "spans":
            continue
        (jts, jv), (tts, tv) = got["jax"][key], got["torch"][key]
        assert tts.tolist() == jts.tolist() == list(range(11)), key
        assert tv.shape == jv.shape == (11,), key
        np.testing.assert_allclose(tv, jv, rtol=RTOL, err_msg=key)


# ---------------------------------------------------------------------------
# Disabled is free: aten ops per iteration, phi bit-equal
# ---------------------------------------------------------------------------
class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _counted_run(t, topo_name, n_iters, mode):
    """(ops Counter, final phi) of vb_run(n_iters) on the fused backend
    (the kernel wrapper runs its plain version here) in a telemetry
    mode: "off", "host" or "taps" (host and taps)."""
    _off()
    state = _torch_state(t, topo_name, backend="fused")
    if mode != "off":
        telemetry.enable()
    if mode == "taps":
        taps.enable()
    with _OpCount() as c:
        state, _ = te.vb_run(state, n_iters)
    _off()
    return c.ops, state.phi


@pytest.mark.parametrize("topo_name,copies", [("dsvb", 2),
                                              ("admm_adaptive", 5)])
def test_disabled_and_host_enabled_same_ops_per_iteration(inst, topo_name,
                                                          copies):
    """Counted over runs of 3 and 6 iterations, the ops an iteration adds
    are the same disabled and host-enabled; with taps on they are the
    same plus exactly `copies` tap copies (kl and msd; ADMM adds rho and
    the two residuals).  phi is bit-equal in the three modes."""
    _, t = inst
    slope, phi = {}, {}
    for mode in ("off", "host", "taps"):
        (ops3, _), (ops6, phi[mode]) = (_counted_run(t, topo_name, n, mode)
                                        for n in (3, 6))
        slope[mode] = ops6 - ops3
        assert not ops3 - ops6, (mode, ops3 - ops6)
        assert sum(ops6.values()) > sum(ops3.values())
    assert slope["host"] == slope["off"]
    assert slope["taps"] - slope["off"] == collections.Counter(
        {"aten.copy_.default": 3 * copies})
    assert not slope["off"] - slope["taps"]
    assert torch.equal(phi["off"], phi["host"])
    assert torch.equal(phi["off"], phi["taps"])


def test_disabled_run_leaves_telemetry_empty(inst):
    _, t = inst
    te.vb_run(_torch_state(t, "admm_adaptive", backend="fused"), 3)
    assert len(telemetry.registry()) == 0
    assert len(telemetry.tracer()) == 0
    assert taps.names() == []


# ---------------------------------------------------------------------------
# Backend fallback; kernel wrappers; the launcher
# ---------------------------------------------------------------------------
def test_backend_fallback_warns_once_and_counts():
    """Three fused sessions of a model the kernel cannot run: one
    warning, backend_fallback_total == 3 with the reference's labels;
    after reset() it warns again."""
    from repro_torch.core import linreg
    mdl = tm.LinRegModel(linreg.prior(2), device="cpu")
    phi_star = torch.stack([mdl.init_phi() + 1.0, mdl.init_phi() - 1.0])
    telemetry.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            te.vb_init(mdl, phi_star, te.FusionCenter(), backend="fused",
                       device="cpu")
    fallback = [w for w in caught if "falling back to the reference "
                "backend" in str(w.message)]
    assert len(fallback) == 1
    assert fallback[0].filename == __file__      # points at the caller
    (row,) = [r for r in telemetry.snapshot()
              if r["name"] == "backend_fallback_total"]
    assert row["value"] == 3.0
    assert row["labels"] == {"backend": "fused", "model": "LinRegModel"}
    telemetry.reset()
    with pytest.warns(UserWarning, match="falling back"):
        te.vb_init(mdl, phi_star, te.FusionCenter(), backend="fused",
                   device="cpu")


def _gmm_args(lib, rng):
    N, T = 2, 16
    x = rng.normal(size=(N, T, D)).astype(np.float32)
    mask = np.ones((N, T), np.float32)
    A = rng.normal(size=(N, K, D, D)) * 0.3
    Wn = (np.eye(D) + A @ np.swapaxes(A, -1, -2)).astype(np.float32)
    b = rng.normal(size=(N, K, D)).astype(np.float32)
    c = rng.normal(size=(N, K)).astype(np.float32)
    lp = np.log(np.full((N, K), 1.0 / K, np.float32))
    conv = torch.from_numpy if lib == "torch" else jnp.asarray
    return [conv(a) for a in (x, mask, lp, Wn, b, c)]


def _kernel_spans(tel) -> dict:
    """{kernel name: [span durations in us]} of the `kernel/<name>`
    spans recorded."""
    out = collections.defaultdict(list)
    for e in tel.tracer().to_chrome()["traceEvents"]:
        if e["name"].startswith("kernel/"):
            out[e["name"][len("kernel/"):]].append(e["dur"])
    return dict(out)


def test_kernel_wrappers_record_wall_time_and_spans():
    """Each instrumented wrapper, called with telemetry on, records one
    `kernel/<name>` span a call (the host's call; the card's kernel time
    is the profiler's) and no metric of its own; the gmm names and span
    counts equal the reference's (its eager calls); the launch counters
    stay readable and writable through the wrappers."""
    rng = np.random.default_rng(0)
    names = ("gmm_estep_nodes", "gmm_estep", "gmm_estep_from_posterior")
    counts = {}
    for lib, tel, mod in (("jax", jtel, jops), ("torch", telemetry, ops)):
        x, mask, lp, Wn, b, c = _gmm_args(lib, rng)
        tel.enable()
        for _ in range(2):
            mod.gmm_estep_nodes(x, mask, lp, Wn, b, c)
        mod.gmm_estep(x[0], mask[0], lp[0], Wn[0], b[0], c[0])
        prior = (jx if lib == "jax" else tx).noninformative_prior(K, D)
        mod.gmm_estep_from_posterior(x[0], mask[0], prior)
        tel.disable()
        counts[lib] = {n: len(d) for n, d in _kernel_spans(tel).items()}
        assert tel.tracer().span_names() == sorted(f"kernel/{n}"
                                                   for n in names)
    assert counts["torch"] == counts["jax"] == {
        "gmm_estep_nodes": 2, "gmm_estep": 1, "gmm_estep_from_posterior": 1}
    assert len(telemetry.registry()) == 0
    # the LM kernels' wrappers (plain versions on the CPU)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 16, generator=g)
    kv = torch.randn(1, 8, 1, 16, generator=g)
    xs = torch.randn(1, 8, 2, 4, generator=g)
    dt = torch.rand(1, 8, 2, generator=g)
    A = -torch.rand(2, generator=g)
    Bm = torch.randn(1, 8, 4, generator=g)
    telemetry.reset()
    with telemetry.enabled_scope():
        ops.flash_attention(q, kv, kv)
        ops.ssd_scan(xs, dt, A, Bm, Bm, chunk=4)
    spans = _kernel_spans(telemetry)
    assert {k: len(d) for k, d in spans.items()} == {
        "flash_attention": 1, "ssd_scan": 1}
    assert all(d[0] > 0 for d in spans.values())
    assert len(telemetry.registry()) == 0
    before = ops.gmm_estep_nodes.launches
    ops.gmm_estep_nodes.launches = before + 3
    assert ops.gmm_estep_nodes.__wrapped__.launches == before + 3
    ops.gmm_estep_nodes.launches = before
    assert set(ops.gmm_estep_nodes.variant_launches) == {
        "registers", "shared", "wide"}
    assert ops.gmm_estep_nodes.__name__ == "gmm_estep_nodes"


_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$")


def parse_prometheus(text: str) -> dict:
    """{sample name with labels: value} of Prometheus text exposition;
    raises on a malformed line."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            assert line.split()[3] in ("counter", "gauge", "histogram")
            continue
        assert _PROM_LINE.match(line), line
        key, value = line.rsplit(" ", 1)
        out[key] = float(value)
    return out


def test_vb_serve_trace_and_metrics_files(tmp_path, capsys):
    """`vb_serve --device cpu --trace --metrics`: a loadable Chrome trace
    with the driver's spans, Prometheus text that parses, the lines the
    reference prints, and telemetry off again afterwards."""
    from repro_torch.launch import vb_serve
    tr, pm = str(tmp_path / "t.json"), str(tmp_path / "m.prom")
    vb_serve.main(["--device", "cpu", "--sessions", "3", "--budgets",
                   "6,10", "--nodes", "4", "--per-node", "6,5", "--slice",
                   "2", "--max-fleet", "2", "--ckpt-dir",
                   str(tmp_path / "ck"), "--trace", tr, "--metrics", pm])
    out = capsys.readouterr().out
    assert "telemetry: wrote" in out and f"series to {pm}" in out
    doc = json.load(open(tr))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"driver/slice", "driver/compile", "driver/sync", "driver/admit",
            "driver/evict"} <= names
    prom = parse_prometheus(open(pm).read())
    # three sessions, and session 0 restored into a second service
    assert prom["driver_admitted_total"] == 4.0
    assert prom["driver_evicted_total"] == 4.0
    assert "driver_occupancy" in prom and "driver_queue_depth" in prom
    assert not telemetry.enabled()
