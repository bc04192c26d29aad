"""Traffic kind `fleet_closed_loop`: many tenant networks served as one
fleet by `VBService`, in a closed loop.

`clients` clients each keep one session open: when a client's session
finishes, it submits its next one at once, so the queue never empties
and admission and eviction run at every slice boundary.  Session s
(numbered in the order they are submitted) is a new hour of data from
the same field: its points are drawn on the device from (seed, s) at
capacity `caps[(s // 3) % 3]` points a node, its Robbins-Monro tau is
`taus[s % 3]` and its budget `budgets[(s // 9) % 3]` iterations with
tol 0, so every 27 sessions run every combination.  All sessions share
one model, the same initial posterior and the configuration's random
geometric graph from the seed: one Diffusion object (Eq. 47 weights)
serves every dSVB session.

The loop drives the service with `step_slice()` (one driver tick) and
reads which sessions finished after each tick.  Set-up opens the
service, submits the first `clients` sessions and runs `warm_ticks`
ticks, past the first sessions' longest budget, so the window opens at
steady state.  The window runs ticks until `--seconds` have passed:
`sessions_per_s` counts the sessions that finished in it over its time,
`session_p95_s` is the 95th percentile of their submit-to-result times
(host clock, from just before `submit` to the end of the tick that
finished the session).

A finished session's record is released from the driver once its
result is read (the client acknowledges it; `release`): the driver keeps
every finished record, its data included (~49 MB a session here), for as
long as the service lives, and has no call that lets one go.  Kept, the
records would fill the card within a window at today's rate.

`correct`: once the window has closed, `sample` of the sessions that
finished in it are drawn from the seed (one of them with the longest
budget), their data drawn again from (seed, s), and the plain reference
(float64) runs each as a solo session of its own budget and tau; every
session's final iterate is compared node by node and block by block, by
the median node (`session_gap`, `median_gap`) and by the 99th
percentile of the nodes (`session_tail`, `tail_gap`), the worst session
counting on each.
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


def session_params(mix: dict, s: int) -> dict:
    """Session s's tau `taus[s % 3]`, capacity `caps[(s // 3) % 3]` and
    budget `budgets[(s // 9) % 3]`."""
    return {"tau": mix["taus"][s % 3], "cap": mix["caps"][(s // 3) % 3],
            "budget": mix["budgets"][(s // 9) % 3]}


def session_data(cfg: dict, seed: int, s: int, cap: int, dev, comps=None):
    return synth.sensor_data(cfg, cfg["n_nodes"], cap, dev, seed, 3, s,
                             comps=comps)


class Loop:
    """The closed loop over one `VBService` (program side)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        from repro_torch.core import engine, expfam, network
        from repro_torch.core.model import GMMModel
        from repro_torch.serving import vb_service

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        K, D, N = cfg["K"], cfg["D"], cfg["n_nodes"]
        self.u, self.v = synth.graph_edges(cfg, N, dev, seed, 2)
        self.m_init = synth.init_means(cfg, seed)
        self.comps = synth.components(cfg, N, dev)
        adj = torch.zeros(N, N, dtype=torch.float64, device=dev)
        adj[self.u.to(dev), self.v.to(dev)] = 1.0
        adj[self.v.to(dev), self.u.to(dev)] = 1.0
        prior = expfam.noninformative_prior(
            K, D, alpha0=cfg["alpha0"], beta0=cfg["beta0"], nu0=cfg["nu0"],
            w0_scale=cfg["w0_scale"], dtype=torch.float64, device=dev)
        self.model = GMMModel(prior, K, D, backend="fused", device=dev)
        self.phi0 = expfam.pack_natural(
            prior._replace(m=self.m_init.to(dev))).expand(
                N, self.model.flat_dim)
        self.topology = engine.Diffusion(network.nearest_neighbor_weights(adj))
        self._engine, self._vb_service = engine, vb_service
        self.svc = vb_service.VBService(
            slice_iters=int(mix["slice_iters"]),
            max_fleet=int(mix["max_fleet"]), bucket=mix["bucket"], device=dev)
        self.open: dict = {}         # rid -> (s, submitted at)
        self.done: list = []         # (s, latency s, finished at, phi)
        self.next_s = 0
        self.ticks = 0

    def submit(self) -> None:
        s = self.next_s
        self.next_s += 1
        p = session_params(self.mix, s)
        with torch.profiler.record_function("vbbench/session_data"):
            data = session_data(self.cfg, self.seed, s, p["cap"], self.dev,
                                self.comps)
        req = self._vb_service.VBRequest(
            model=self.model, data=data, topology=self.topology,
            n_iters=p["budget"], init_phi=self.phi0,
            schedule=self._engine.Schedule(tau=p["tau"], d0=self.cfg["d0"]))
        t = time.perf_counter()
        with torch.profiler.record_function("vbbench/submit"):
            rid = self.svc.submit(req)
        self.open[rid] = (s, t)

    def tick(self) -> int:
        """One driver tick; the sessions it finished are read, released
        and replaced by their clients' next ones.  Returns how many
        finished."""
        with torch.profiler.record_function("vbbench/tick"):
            self.svc.step_slice()
        now = time.perf_counter()
        self.ticks += 1
        finished = self.svc.driver._finished       # see `release`
        ended = [rid for rid in self.open if rid in finished]
        for rid in ended:
            st = self.svc.status(rid)
            s, t_sub = self.open.pop(rid)
            if not st.done:
                raise RuntimeError(f"session {s} retired undone: {st}")
            self.done.append((s, now - t_sub, now, st.phi.cpu()))
            self.release(rid)
        for _ in ended:
            self.submit()
        return len(ended)

    def release(self, rid: str) -> None:
        """Let a read session's record go.  The driver has no call for it
        (nor one that lists the finished sessions without copying every
        open one's iterate, as `status` does), so the two reach into its
        record of finished sessions."""
        del self.svc.driver._finished[rid]

    def occupancy_counts(self) -> tuple:
        """(slot-slices active, slot-slices stepped) so far, from the
        driver's time-averaged occupancy and its slice count."""
        st = self.svc.stats()
        slots = st.slices * st.capacity
        return st.occupancy * slots, slots


def reference_sessions(cfg: dict, mix: dict, seed: int, sessions: list,
                       m_init, u, v, dtype, dev) -> list:
    """The plain reference's final iterate of each session s in
    `sessions`, each a solo run of its own budget and tau, side by side
    in `dtype` (data padded to the largest capacity with mask-zero
    points)."""
    K, D, N = cfg["K"], cfg["D"], cfg["n_nodes"]
    ps = [session_params(mix, s) for s in sessions]
    graph = gmm_vb.Graph(u, v, N, dev, dense=True)
    pri = gmm_vb.prior(cfg, dtype, dev)
    P = gmm_vb.flat_dim(K, D)
    S, T = len(ps), max(p["cap"] for p in ps)
    x = torch.zeros(S, N, T, D, dtype=torch.float32, device=dev)
    mask = torch.zeros(S, N, T, dtype=torch.float32, device=dev)
    for k, (s, p) in enumerate(zip(sessions, ps)):
        x[k, :, :p["cap"]], mask[k, :, :p["cap"]] = session_data(
            cfg, seed, s, p["cap"], dev)
    x, mask = x.reshape(S * N, T, D), mask.reshape(S * N, T)
    phi = gmm_vb.pack(dict(pri, m=m_init.to(dev, dtype))).expand(
        S, N, P).contiguous()
    final = [None] * S
    for t in range(max(p["budget"] for p in ps)):
        star = gmm_vb.local_optimum(x, mask, phi.reshape(S * N, P), pri,
                                    float(N), K, D).reshape(S, N, P)
        eta = torch.tensor([gmm_vb.eta(t, p["tau"], cfg["d0"]) for p in ps],
                           dtype=dtype, device=dev)
        phi = graph.diffuse(phi + eta[:, None, None] * (star - phi))
        for k, p in enumerate(ps):
            if p["budget"] == t + 1:
                final[k] = phi[k].clone()
    return final


def pick_sample(mix: dict, seed: int, done: list) -> list:
    """`sample` indices into `done`, drawn from the seed: one of the
    sessions with the longest budget, then the rest at random."""
    gen = synth.generator("cpu", seed, 5)
    budgets = [session_params(mix, s)["budget"] for s, *_ in done]
    longest = [i for i, b in enumerate(budgets) if b == max(budgets)]
    pick = [longest[int(torch.randint(len(longest), (1,), generator=gen))]]
    rest = [i for i in range(len(done)) if i not in pick]
    order = torch.randperm(len(rest), generator=gen).tolist()
    return pick + [rest[j] for j in order[:int(mix["sample"]) - 1]]


def run(cell: dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> dict:
    from repro_torch.kernels import ops

    cfg, mix, wl = cell["config"], cell["traffic"], cell["workload"]
    K, D, N = cfg["K"], cfg["D"], cfg["n_nodes"]
    k = int(mix["slice_iters"])

    loop = Loop(cfg, mix, seed, dev)
    for _ in range(int(mix["clients"])):
        loop.submit()
    for _ in range(int(mix["warm_ticks"])):
        loop.tick()
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    n_warm = len(loop.done)
    act0, slots0 = loop.occupancy_counts()
    t0 = harness.open_window()
    setup_s = t0 - t_start
    ticks0 = loop.ticks
    while time.perf_counter() - t0 < seconds:
        loop.tick()
    t1 = time.perf_counter()
    window_s = t1 - t0
    ticks = loop.ticks - ticks0
    act1, slots1 = loop.occupancy_counts()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else 0)
    in_window = loop.done[n_warm:]
    lat = sorted(d[1] for d in in_window)
    p95 = lat[max(0, -(-95 * len(lat) // 100) - 1)]

    out = {"e2e": {"sessions_per_s": len(in_window) / window_s,
                   "session_p95_s": p95, "setup_s": setup_s},
           "attempted": len(in_window), "failed": 0,
           "memory_peak_bytes": peak, "trace": None, "ctx": {}}
    if trace:
        n_trace = int(mix["trace_ticks"])
        launches0 = ops.gmm_estep_nodes.launches
        S = int(mix["max_fleet"])
        rung = max(mix["caps"])

        def window():
            for _ in range(n_trace):
                loop.tick()
            return n_trace * k

        tr = harness.traced(window)
        out["trace"] = tr
        out["ctx"] = {
            "trace": tr, "iterations": tr["iterations"],
            "estep_calls": ops.gmm_estep_nodes.launches - launches0,
            "estep_least_s": gmm_work.least_seconds(
                gmm_work.estep_work(S * N, rung, K, D)),
            # every group stepped makes one E-step call a fleet
            # iteration: the iteration's least time is a group's times
            # the calls an iteration
            "iter_least_s": gmm_work.least_seconds(gmm_work.iteration_work(
                S * N, rung, K, D,
                graph_bytes=gmm_work.dense_graph_bytes(N)))
            * (ops.gmm_estep_nodes.launches - launches0) / (n_trace * k),
            "iter_s": window_s / (ticks * k),
            "occupancy": ((act1 - act0) / (slots1 - slots0)
                          if slots1 > slots0 else None),
            "fleet_iter_ms": window_s * 1e3 / (ticks * k)}

    # the check: a sample of the window's sessions against the reference
    picks = pick_sample(mix, seed, in_window)
    sessions = [in_window[i][0] for i in picks]
    u, v, m_init = loop.u, loop.v, loop.m_init
    del loop
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    refs = reference_sessions(cfg, mix, seed, sessions, m_init, u, v,
                              torch.float64, dev)
    got = [in_window[i][3].to(dev) for i in picks]
    out["checks"] = session_checks(sessions, got, refs, wl["limits"], mix,
                                   K, D)
    return out


def session_checks(sessions: list, got: list, refs: list, limits: dict,
                   mix: dict, K: int, D: int) -> list:
    """(name, value, limit): the worst sampled session's median-node gap
    and its 99th-percentile gap; each session's node-gap quantiles go
    to standard error for the record."""
    for s, a, b in zip(sessions, got, refs):
        print(f"vbbench gaps session {s} {session_params(mix, s)}: "
              + json.dumps(gmm_vb.gap_quantiles(a, b, K, D))
              + f" program finite {bool(torch.isfinite(a).all())}"
              f" reference finite {bool(torch.isfinite(b).all())}",
              file=sys.stderr)
    return [("session_gap", max(gmm_vb.median_gap(a, b, K, D)
                                for a, b in zip(got, refs)),
             limits["session_gap"]),
            ("session_tail", max(gmm_vb.tail_gap(a, b, K, D)
                                 for a, b in zip(got, refs)),
             limits["session_tail"])]
