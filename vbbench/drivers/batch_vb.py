"""Traffic kind `batch_vb`: one deployed sensor field run as a batch
estimator, iteration after iteration, as a user runs `algorithms.run_dsvb`
(`algorithm: dsvb`) or `algorithms.run_dvb_admm(adaptive_rho=True)`
(`algorithm: admm`) on a field too large to finish in one call.

Set-up makes the field on the device from the seed (the configuration's
`n_nodes` x `n_per_node` points, its random geometric graph and the
initial means), opens ONE session through the program's entry
(`engine.vb_init` over a `SparseGraph`: Eq. 47 weights for dSVB, the
adjacency for ADMM), drives it through its first `check_steps`
iterations with the window's own call (`engine.vb_run`), keeping each
iterate, and runs one more chunk to warm up (with `check_warm`, the
iterate after it is kept too: for ADMM, 25 more iterations of Eqs. 38a-b
with the clip rule that resets the duals and the ramp, which an early
step's check does not reach).  The window then calls
`vb_run(state, chunk_iters)` on that same session, synchronising after
each chunk, until `--seconds` have passed: `iter_ms` is the window's
time over the iterations it completed.

`correct`: once the window has closed and the peak memory is read, the
program's session is freed and the plain reference
(`reference/gmm_vb.py`, float64) follows the session from the same
inputs as far as the last kept iterate; each kept iterate is compared,
node by node and block by block, by the median node (`gap_<label>`,
`median_gap`) and by the 99th percentile of the nodes (`tail_<label>`,
`tail_gap`), which sees a fault confined to a minority of the nodes
(`check_steps` names the labels).
"""
from __future__ import annotations

import json
import sys
import time

import torch

from vbbench import harness
from vbbench.counts import gmm_work
from vbbench.data import synth
from vbbench.reference import gmm_vb


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def make_inputs(cfg: dict, seed: int, dev) -> dict:
    """The field, its links and the initial means, from the seed."""
    N, T = cfg["n_nodes"], cfg["n_per_node"]
    x, mask = synth.sensor_data(cfg, N, T, dev, seed, 1)
    u, v = synth.graph_edges(cfg, N, dev, seed, 2)
    return {"x": x, "mask": mask, "u": u, "v": v,
            "m_init": synth.init_means(cfg, seed)}


def open_session(cfg: dict, mix: dict, inp: dict, dev):
    """The program's session over the inputs (`algorithms.run_dsvb`'s
    path: a fused-backend GMMModel, the prior with the initial means as
    every node's starting posterior, Eq. 47 weights over a SparseGraph,
    the Robbins-Monro schedule)."""
    from repro_torch.core import engine, expfam, network
    from repro_torch.core.model import GMMModel

    K, D, N = cfg["K"], cfg["D"], cfg["n_nodes"]
    prior = expfam.noninformative_prior(
        K, D, alpha0=cfg["alpha0"], beta0=cfg["beta0"], nu0=cfg["nu0"],
        w0_scale=cfg["w0_scale"], dtype=torch.float64, device=dev)
    init_q = prior._replace(m=inp["m_init"].to(dev))
    mdl = GMMModel(prior, K, D, backend="fused", device=dev)
    phi0 = expfam.pack_natural(init_q).expand(N, mdl.flat_dim)
    graph = network.SparseGraph.from_undirected(
        inp["u"].numpy(), inp["v"].numpy(), N)
    if mix["algorithm"] == "dsvb":
        topology = engine.Diffusion(
            network.sparse_nearest_neighbor_weights(graph))
        schedule = engine.Schedule(tau=cfg["tau"], d0=cfg["d0"])
    elif mix["algorithm"] == "admm":
        topology, schedule = admm_topology(cfg, graph, cfg["rho"]), \
            engine.Schedule()
    else:
        raise ValueError(f"unknown algorithm {mix['algorithm']!r}")
    return engine.vb_init(mdl, (inp["x"], inp["mask"]), topology,
                          schedule=schedule, init_phi=phi0, device=dev)


def admm_topology(cfg: dict, adj, rho: float):
    """`run_dvb_admm(adaptive_rho=True)`'s topology, its constants the
    configuration's."""
    from repro_torch.core import engine
    a = cfg["admm"]
    return engine.ADMMConsensus(
        adj, rho=rho, xi=cfg["xi"], adaptive_rho=a["adaptive_rho"],
        mu=a["mu"], tau_incr=a["tau_incr"], tau_decr=a["tau_decr"],
        adapt_every=a["adapt_every"], rho_min=a["rho_min"],
        rho_max=a["rho_max"], warmup_tol=a["warmup_tol"],
        warmup_window=a["warmup_window"], dual_reset=a["dual_reset"],
        clip_tol=a["clip_tol"])


def check_steps(mix: dict) -> list:
    """(label, iteration number) of the iterates compared: "step1" ..
    for 1 .. `check_steps`, and with `check_warm` "warm" for the end of
    the warm-up chunk, iteration `check_steps` + `chunk_iters`."""
    n = int(mix["check_steps"])
    steps = [(f"step{t}", t) for t in range(1, n + 1)]
    if mix.get("check_warm"):
        steps.append(("warm", n + int(mix["chunk_iters"])))
    return steps


def reference_steps(cfg: dict, mix: dict, inp: dict, steps: list, dtype,
                    dev) -> list:
    """The plain reference's iterates after the iterations numbered in
    `steps` (ascending), in `dtype`."""
    K, D, N = cfg["K"], cfg["D"], cfg["n_nodes"]
    pri = gmm_vb.prior(cfg, dtype, dev)
    init = dict(pri, m=inp["m_init"].to(dev, dtype))
    phi0 = gmm_vb.pack(init).expand(N, gmm_vb.flat_dim(K, D)).contiguous()
    graph = gmm_vb.Graph(inp["u"], inp["v"], N, dev)
    if mix["algorithm"] == "admm":
        return gmm_vb.admm(inp["x"], inp["mask"], phi0, pri, graph,
                           rho=cfg["rho"], xi=cfg["xi"],
                           admm_cfg=cfg["admm"], n_iters=max(steps),
                           replication=float(N), K=K, D=D, keep=set(steps))
    return gmm_vb.dsvb(inp["x"], inp["mask"], phi0, pri, graph,
                       tau=cfg["tau"], d0=cfg["d0"], n_iters=max(steps),
                       replication=float(N), K=K, D=D, keep=set(steps))


def first_steps(state, n_steps: int) -> tuple:
    """Drive the session through its first iterations with the window's
    call; (state, [copies of the iterate after each])."""
    from repro_torch.core import engine
    snaps = []
    for _ in range(n_steps):
        state, _ = engine.vb_run(state, 1)
        snaps.append(state.phi.clone())
    return state, snaps


def run(cell: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> dict:
    from repro_torch.core import engine
    from repro_torch.kernels import ops

    cfg, mix, wl = cell["config"], cell["traffic"], cell["workload"]
    K, D, N, T = cfg["K"], cfg["D"], cfg["n_nodes"], cfg["n_per_node"]
    chunk, steps = int(mix["chunk_iters"]), check_steps(mix)

    inp = make_inputs(cfg, seed, dev)
    state = open_session(cfg, mix, inp, dev)
    state, snaps = first_steps(state, int(mix["check_steps"]))
    with torch.profiler.record_function("vbbench/vb_run"):
        state, warm = engine.vb_run(state, chunk)     # warm-up
    if mix.get("check_warm"):
        snaps.append(state.phi.clone())
    report_admm("warm-up end", state, warm)
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    t0 = harness.open_window()
    setup_s = t0 - t_start
    iters = 0
    while True:
        with torch.profiler.record_function("vbbench/vb_run"):
            state, last = engine.vb_run(state, chunk)
        _sync(dev)
        iters += chunk
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else 0)
    finite = bool(torch.isfinite(state.phi).all())
    report_admm("window end", state, last)

    out = {"e2e": {mix["iter_metric"]: window_s * 1e3 / iters,
                   "setup_s": setup_s},
           "attempted": iters, "failed": 0 if finite else iters,
           "memory_peak_bytes": peak, "trace": None, "ctx": {}}
    if trace:
        n_trace = int(mix["trace_iters"])
        launches0 = ops.gmm_estep_nodes.launches

        def window():
            nonlocal state
            done = 0
            while done < n_trace:
                with torch.profiler.record_function("vbbench/vb_run"):
                    state, _ = engine.vb_run(state, chunk)
                done += chunk
            return done

        tr = harness.traced(window)
        graph_bytes = gmm_work.sparse_graph_bytes(N, len(inp["u"]))
        out["trace"] = tr
        out["ctx"] = {
            "trace": tr, "iterations": tr["iterations"],
            "iter_s": window_s / iters,
            "estep_calls": ops.gmm_estep_nodes.launches - launches0,
            "estep_least_s": gmm_work.least_seconds(
                gmm_work.estep_work(N, T, K, D)),
            "iter_least_s": gmm_work.least_seconds(gmm_work.iteration_work(
                N, T, K, D, graph_bytes=graph_bytes))}

    # the check: the program's state freed, the reference in blocks
    del state
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    refs = reference_steps(cfg, mix, inp, [t for _, t in steps],
                           torch.float64, dev)
    out["checks"] = step_checks(steps, snaps, refs, wl["limits"], K, D)
    return out


def step_checks(steps: list, got: list, refs: list, limits: dict, K: int,
                D: int) -> list:
    """(name, value, limit) of each compared step (`check_steps`): the
    median node's gap `gap_<label>`, then the 99th percentile's
    `tail_<label>`; each step's node-gap quantiles go to standard error
    for the record."""
    checks = []
    for (label, t), a, b in zip(steps, got, refs):
        print(f"vbbench gaps {label} (iteration {t}): "
              + json.dumps(gmm_vb.gap_quantiles(a, b, K, D)), file=sys.stderr)
        checks += [(f"gap_{label}", gmm_vb.median_gap(a, b, K, D),
                    limits[f"gap_{label}"]),
                   (f"tail_{label}", gmm_vb.tail_gap(a, b, K, D),
                    limits[f"tail_{label}"])]
    return checks


def report_admm(when: str, state, run) -> None:
    """What Algorithm 2's adaptive machinery did in the last chunk, on
    standard error (nothing for dSVB)."""
    d = run.consensus_diag
    if d is None:
        return
    on = (d.dual_on > 0).nonzero()
    print(f"vbbench admm {when}: " + json.dumps({
        "t": state.t, "dual_on": float(d.dual_on[-1]),
        "gate_open_from": (state.t - len(d.dual_on) + 1 + int(on[0])
                           if len(on) else None),
        "rho": float(d.rho[-1]), "kappa": float(d.kappa[-1]),
        "kappa_max": float(d.kappa.max()),
        "clip_count_max": int(d.clip_count.max()),
        "reset_count_max": int(d.reset_count.max()),
        "primal_resid": float(d.primal_resid[-1]),
        "dual_resid": float(d.dual_resid[-1])}), file=sys.stderr)
