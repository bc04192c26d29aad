"""The paper's Sec. V experiments (Figs. 3, 4, 7-10, 13; Tables I, II).

Port of `benchmarks/paper_figures.py`: one function per figure or table,
at the reference's reduced sizes by default and the paper's with
`full=True`.  Each returns rows of (name, us per iteration, derived
string), the derived string in the reference's format (`best_tau=...`,
`dsvb/cvb_kl_ratio=...`, ...), and stores its curves and summary in the
`results` dict the caller passes (the reference's
experiments/benchmarks/*.json payloads; nothing is written to disk).
fig4 runs dSVB at the tau that fig3 stored in the same `results`, else
0.05, as the reference does with its saved snapshot.

`backend` ("fused" by default: the hand-written E-step kernel on the card)
and `device` (None = CUDA) go to every estimator.  `max_iters` caps every
run's iteration count (the derived computations keep the figure's nominal
count, as the reference's do), for short checks.

Run on the CPU, at a cut iteration count:

    PYTHONPATH=src python -m repro_torch.experiments.paper_figures \\
        --device cpu --max-iters 50 --only fig3_tau_sweep
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import algorithms
from repro_torch.data import datasets, synthetic
from repro_torch.experiments import common

K, D = 3, 2


def _paper_data(full):
    n_nodes = 50 if full else 20
    n_per = 100 if full else 80
    return synthetic.paper_synthetic(n_nodes=n_nodes, n_per_node=n_per,
                                     seed=1), n_nodes


def _store(results):
    return {} if results is None else results


def _cap(n_iters, max_iters):
    return n_iters if max_iters is None else min(n_iters, max_iters)


def fig3_tau_sweep(full=False, *, backend="fused", device=None,
                   max_iters=None, results=None):
    """Fig. 3: dSVB cost vs forgetting rate tau — optimum in [0.1, 0.3]."""
    data, n = _paper_data(full)
    s = common.setup_gmm(data, K, D, graph_seed=3, device=device)
    n_iters = 2000 if full else 500
    run_iters = _cap(n_iters, max_iters)
    kw = dict(K=K, D=D, ref_phi=s["ref_phis"], init_q=s["init_q"],
              backend=backend, device=device)
    taus = [0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.8]
    curve = {}
    for tau in taus:
        run, wall = common.timed(
            algorithms.run_dsvb, s["x"], s["mask"], s["W"], s["prior"],
            n_iters=run_iters, tau=tau, **kw)
        curve[tau] = {"kl_mean": float(run.kl_mean[-1]),
                      "kl_std": float(run.kl_std[-1])}
    cvb, _ = common.timed(algorithms.run_cvb, s["x"], s["mask"], s["prior"],
                          n_iters=_cap(min(300, n_iters), max_iters), **kw)
    best_tau = min(curve, key=lambda t: curve[t]["kl_mean"])
    _store(results)["fig3_tau_sweep"] = {
        "curve": curve, "n_iters": n_iters, "cvb_kl": float(cvb.kl_mean[-1]),
        "best_tau": best_tau}
    return [("fig3_tau_sweep", common.us_per_iter(wall, run_iters),
             f"best_tau={best_tau}")]


def fig4_convergence(full=False, *, backend="fused", device=None,
                     max_iters=None, results=None):
    """Fig. 4: dSVB converges to ~cVB; nsg-dVB biased."""
    data, n = _paper_data(full)
    s = common.setup_gmm(data, K, D, graph_seed=3, device=device)
    n_iters = 3000 if full else 1500
    run_iters = _cap(n_iters, max_iters)
    kw = dict(n_iters=run_iters, K=K, D=D, ref_phi=s["ref_phis"],
              init_q=s["init_q"], backend=backend, device=device)
    # dSVB at fig3's swept optimum when fig3 ran first, else 0.05
    tau = float((results or {}).get("fig3_tau_sweep", {})
                .get("best_tau", 0.05))
    dsvb, wall = common.timed(algorithms.run_dsvb, s["x"], s["mask"],
                              s["W"], s["prior"], tau=tau, **kw)
    cvb, _ = common.timed(algorithms.run_cvb, s["x"], s["mask"], s["prior"],
                          **kw)
    nsg, _ = common.timed(algorithms.run_nsg_dvb, s["x"], s["mask"], s["W"],
                          s["prior"], **kw)
    nonc, _ = common.timed(algorithms.run_noncoop, s["x"], s["mask"],
                           s["prior"], **kw)
    sub = slice(0, run_iters, max(1, run_iters // 200))
    _store(results)["fig4_convergence"] = {
        "iters": list(range(run_iters))[sub],
        **{name: r.kl_mean.cpu().numpy()[sub].tolist()
           for name, r in (("dsvb", dsvb), ("cvb", cvb), ("nsg_dvb", nsg),
                           ("noncoop", nonc))},
        "tau": tau,
        "final": {name: float(r.kl_mean[-1])
                  for name, r in (("dsvb", dsvb), ("cvb", cvb),
                                  ("nsg_dvb", nsg), ("noncoop", nonc))}}
    ratio = float(dsvb.kl_mean[-1]) / max(float(cvb.kl_mean[-1]), 1e-9)
    return [("fig4_convergence", common.us_per_iter(wall, run_iters),
             f"dsvb/cvb_kl_ratio={ratio:.2f} tau={tau}")]


def fig7_rho_sweep(full=False, *, backend="fused", device=None,
                   max_iters=None, results=None):
    """Fig. 7: small rho converges faster; too small risks leaving Omega."""
    data, n = _paper_data(full)
    s = common.setup_gmm(data, K, D, graph_seed=3, device=device)
    n_iters = 1000 if full else 300
    run_iters = _cap(n_iters, max_iters)
    rhos = [0.25, 0.5, 1.0, 2.0, 8.0]
    curve = {}
    for rho in rhos:
        run, wall = common.timed(
            algorithms.run_dvb_admm, s["x"], s["mask"], s["adj"], s["prior"],
            n_iters=run_iters, K=K, D=D, rho=rho, ref_phi=s["ref_phis"],
            init_q=s["init_q"], backend=backend, device=device)
        tr = run.kl_mean.cpu().numpy()
        # iterations to reach 1.5x the final cVB-quality level
        target = float(tr[-1]) * 1.5 + 0.5
        t_hit = int(np.argmax(tr < target)) if np.any(tr < target) else -1
        curve[rho] = {"kl_final": float(tr[-1]), "iters_to_1p5x": t_hit,
                      "kl_std": float(run.kl_std[-1])}
    _store(results)["fig7_rho_sweep"] = {"curve": curve, "n_iters": n_iters}
    fastest = min(curve, key=lambda r: curve[r]["iters_to_1p5x"]
                  if curve[r]["iters_to_1p5x"] >= 0 else 1e9)
    return [("fig7_rho_sweep", common.us_per_iter(wall, run_iters),
             f"fastest_rho={fastest}")]


def fig8_admm_vs_dsvb(full=False, *, backend="fused", device=None,
                      max_iters=None, results=None):
    """Fig. 8: dVB-ADMM (adaptive penalty) against dSVB to the same KL."""
    data, n = _paper_data(full)
    s = common.setup_gmm(data, K, D, graph_seed=3, device=device)
    n_iters = 1500 if full else 600
    run_iters = _cap(n_iters, max_iters)
    kw = dict(n_iters=run_iters, K=K, D=D, ref_phi=s["ref_phis"],
              init_q=s["init_q"], backend=backend, device=device)
    dsvb, _ = common.timed(algorithms.run_dsvb, s["x"], s["mask"], s["W"],
                           s["prior"], tau=0.2, **kw)
    admm, wall = common.timed(algorithms.run_dvb_admm, s["x"], s["mask"],
                              s["adj"], s["prior"], rho=0.5,
                              adaptive_rho=True, **kw)
    a, d = admm.kl_mean.cpu().numpy(), dsvb.kl_mean.cpu().numpy()
    target = float(a[-1]) * 1.2 + 0.5
    t_admm = int(np.argmax(a < target)) if np.any(a < target) else n_iters
    t_dsvb = int(np.argmax(d < target)) if np.any(d < target) else n_iters
    speedup = max(t_dsvb, 1) / max(t_admm, 1)
    _store(results)["fig8_admm_vs_dsvb"] = {
        "kl_admm_final": float(a[-1]), "kl_dsvb_final": float(d[-1]),
        "iters_admm": t_admm, "iters_dsvb": t_dsvb, "speedup": speedup,
        "std_admm": float(admm.kl_std[-1]),
        "std_dsvb": float(dsvb.kl_std[-1])}
    return [("fig8_admm_vs_dsvb", common.us_per_iter(wall, run_iters),
             f"admm_speedup={speedup:.1f}x")]


def fig9_imbalance(full=False, *, backend="fused", device=None,
                   max_iters=None, results=None):
    """Fig. 9: unequal per-node data sizes (40..160) — performance holds."""
    n_nodes = 50 if full else 20
    # paper Fig. 9: sizes 40..160, samples from the WHOLE mixture
    data = synthetic.paper_synthetic(n_nodes=n_nodes, n_per_node=100,
                                     seed=2, unequal_sizes=True,
                                     imbalanced=False)
    s = common.setup_gmm(data, K, D, graph_seed=4, device=device)
    n_iters = 1500 if full else 500
    run_iters = _cap(n_iters, max_iters)
    kw = dict(n_iters=run_iters, K=K, D=D, ref_phi=s["ref_phis"],
              init_q=s["init_q"], backend=backend, device=device)
    cvb, _ = common.timed(algorithms.run_cvb, s["x"], s["mask"], s["prior"],
                          **kw)
    dsvb, _ = common.timed(algorithms.run_dsvb, s["x"], s["mask"], s["W"],
                           s["prior"], tau=0.2, **kw)
    admm, wall = common.timed(algorithms.run_dvb_admm, s["x"], s["mask"],
                              s["adj"], s["prior"], rho=0.5, **kw)
    _store(results)["fig9_imbalance"] = {
        "cvb": float(cvb.kl_mean[-1]), "dsvb": float(dsvb.kl_mean[-1]),
        "admm": float(admm.kl_mean[-1])}
    ratio = float(admm.kl_mean[-1]) / max(float(cvb.kl_mean[-1]), 1e-9)
    return [("fig9_imbalance", common.us_per_iter(wall, run_iters),
             f"admm/cvb_kl_ratio={ratio:.2f}")]


def fig10_network_size(full=False, *, backend="fused", device=None,
                       max_iters=None, results=None):
    """Fig. 10: N = 30/80/100 (reduced: 15/30/45) — converges at any
    size, more slowly for larger networks."""
    sizes = [30, 80, 100] if full else [15, 30, 45]
    n_iters = 2000 if full else 600
    run_iters = _cap(n_iters, max_iters)
    out = {}
    for n in sizes:
        data = synthetic.paper_synthetic(n_nodes=n, n_per_node=60, seed=3)
        s = common.setup_gmm(data, K, D, graph_seed=5, device=device)
        run, wall = common.timed(
            algorithms.run_dvb_admm, s["x"], s["mask"], s["adj"], s["prior"],
            n_iters=run_iters, K=K, D=D, rho=0.5, ref_phi=s["ref_phis"],
            init_q=s["init_q"], backend=backend, device=device)
        tr = run.kl_mean.cpu().numpy()
        target = float(tr[-1]) * 1.5 + 0.5
        out[n] = {"kl_final": float(tr[-1]),
                  "iters_to_1p5x": int(np.argmax(tr < target))}
    _store(results)["fig10_network_size"] = out
    return [("fig10_network_size", common.us_per_iter(wall, run_iters),
             "iters_to_conv=" + "/".join(
                 str(out[n]["iters_to_1p5x"]) for n in sizes))]


def _clustering_table(name, data, Kc, Dc, n_iters, rho, tau, graph_seed,
                      backend, device, results):
    s = common.setup_gmm(data, Kc, Dc, graph_seed=graph_seed, beta0=0.05,
                         w0=5.0, device=device)
    kw = dict(n_iters=n_iters, K=Kc, D=Dc, init_q=s["init_q"],
              backend=backend, device=device)
    x, mask, prior = s["x"], s["mask"], s["prior"]
    acc = {}
    cvb, _ = common.timed(algorithms.run_cvb, x, mask, prior, **kw)
    acc["cvb"] = common.accuracy(data, cvb.phi, Kc, Dc)
    nonc, _ = common.timed(algorithms.run_noncoop, x, mask, prior, **kw)
    acc["noncoop"] = common.accuracy(data, nonc.phi, Kc, Dc)
    nsg, _ = common.timed(algorithms.run_nsg_dvb, x, mask, s["W"], prior,
                          **kw)
    acc["nsg_dvb"] = common.accuracy(data, nsg.phi, Kc, Dc)
    dsvb, _ = common.timed(algorithms.run_dsvb, x, mask, s["W"], prior,
                           tau=tau, **kw)
    acc["dsvb"] = common.accuracy(data, dsvb.phi, Kc, Dc)
    admm, wall = common.timed(algorithms.run_dvb_admm, x, mask, s["adj"],
                              prior, rho=rho, **kw)
    acc["dvb_admm"] = common.accuracy(data, admm.phi, Kc, Dc)
    _store(results)[name] = acc
    return acc, wall, n_iters


def _table_row(name, res, wall, n_iters):
    return [(name, common.us_per_iter(wall, n_iters),
             f"acc cvb={res['cvb']:.3f} admm={res['dvb_admm']:.3f} "
             f"dsvb={res['dsvb']:.3f} nsg={res['nsg_dvb']:.3f} "
             f"noncoop={res['noncoop']:.3f}")]


def table1_atmosphere(full=False, *, backend="fused", device=None,
                      max_iters=None, results=None):
    """Table I: atmosphere surrogate (1600 x 3, 2 classes, 20 nodes)."""
    data = datasets.atmosphere_surrogate(n_nodes=20, seed=0)
    res, wall, n_iters = _clustering_table(
        "table1_atmosphere", data, 2, 3,
        _cap(400 if not full else 1000, max_iters), rho=1.0, tau=0.2,
        graph_seed=11, backend=backend, device=device,
        results=results)
    return _table_row("table1_atmosphere", res, wall, n_iters)


def table2_ionosphere(full=False, *, backend="fused", device=None,
                      max_iters=None, results=None):
    """Table II: ionosphere surrogate (340 x 34, 2 classes, 20 nodes)."""
    data = datasets.ionosphere_surrogate(n_nodes=20, seed=0)
    res, wall, n_iters = _clustering_table(
        "table2_ionosphere", data, 2, 34,
        _cap(300 if not full else 800, max_iters), rho=16.0, tau=0.2,
        graph_seed=12, backend=backend, device=device,
        results=results)
    return _table_row("table2_ionosphere", res, wall, n_iters)


def fig13_coil20(full=False, *, backend="fused", device=None,
                 max_iters=None, results=None):
    """Fig. 13: accuracy vs number of clusters K on the COIL-20
    surrogate (D = 52)."""
    Ks = list(range(2, 11, 2)) if full else [2, 4, 6]
    out = {}
    for Kc in Ks:
        data = datasets.coil20_surrogate(Kc, n_nodes=10, seed=Kc)
        res, wall, n_iters = _clustering_table(
            f"fig13_coil20_K{Kc}", data, Kc, 52,
            _cap(250 if not full else 600, max_iters), rho=16.0, tau=0.2,
            graph_seed=13, backend=backend, device=device,
            results=results)
        out[Kc] = res
    _store(results)["fig13_coil20"] = out
    last = out[Ks[-1]]
    return [("fig13_coil20", common.us_per_iter(wall, n_iters),
             f"K={Ks[-1]} acc admm={last['dvb_admm']:.3f} "
             f"cvb={last['cvb']:.3f} noncoop={last['noncoop']:.3f}")]


ALL = [fig3_tau_sweep, fig4_convergence, fig7_rho_sweep, fig8_admm_vs_dsvb,
       fig9_imbalance, fig10_network_size, table1_atmosphere,
       table2_ionosphere, fig13_coil20]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes (default: the reduced ones)")
    ap.add_argument("--backend", default="fused",
                    choices=("fused", "reference"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="cap every run's iterations")
    ap.add_argument("--only", default=None,
                    help="comma-separated figure names")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    results = {}
    print("name,us_per_call,derived")
    for fn in ALL:
        if only is not None and fn.__name__ not in only:
            continue
        for name, us, derived in fn(args.full, backend=args.backend,
                                    device=args.device,
                                    max_iters=args.max_iters,
                                    results=results):
            print(f"{name},{us:.1f},{derived}", flush=True)


if __name__ == "__main__":
    main()
