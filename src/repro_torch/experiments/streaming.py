"""Streaming minibatch dSVB on the paper's 50-node GMM: the minibatch and
SVRG benchmarks.

Port of `benchmarks/minibatch_bench.py` and `benchmarks/svrg_bench.py`,
with the port's own reshuffling streams (data/stream.py), so the KL values
differ from the reference's while the bars are the benchmarks' own:

* `minibatch_bench` — B = 20 of each node's 100 points, at EQUAL E-step
  FLOPs: the full-batch run takes `iters_full` iterations, the streaming
  run 100/20 times as many.  Bar: `kl_ratio_equal_flops <= 1.10`.
* `svrg_bench` — plain streaming, SVRG streaming and full batch at EQUAL
  iterations.  Bars: `kl_ratio_equal_iters_svrg <= 1.3` and no worse than
  plain; SVRG at B = capacity equal bit for bit to the full-batch run.

Each returns rows of (name, us per iteration, derived string) and stores
its numbers in `results`; a bar that does not hold raises.  `backend`
("fused" by default) and `device` (None = CUDA) go to every run.

    PYTHONPATH=src python -m repro_torch.experiments.streaming --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import engine, expfam
from repro_torch.core import model as model_lib
from repro_torch.data import stream, synthetic
from repro_torch.experiments import common

K, D = 3, 2
N_NODES, N_PER, BATCH = 50, 100, 20


def _setup(backend, device):
    data = synthetic.paper_synthetic(n_nodes=N_NODES, n_per_node=N_PER,
                                     seed=0)
    s = common.setup_gmm(data, K, D, seed=0, graph_seed=0, device=device)
    mdl = model_lib.GMMModel(s["prior"], K, D, backend=backend,
                             device=device)
    phi0 = expfam.pack_natural(s["init_q"]).expand(N_NODES, mdl.flat_dim)

    def go(n_iters, minibatch):
        run, wall = common.timed(
            engine.run_vb, mdl, (s["x"], s["mask"]), engine.Diffusion(s["W"]),
            n_iters=n_iters, init_phi=phi0, ref_phi=s["ref_phis"],
            minibatch=minibatch, device=mdl.device)
        return (float(run.kl_mean[-1]), run.phi,
                common.us_per_iter(wall, n_iters))

    return go


def minibatch_bench(full=False, *, backend="fused", device=None,
                    results=None):
    """Streaming (B = 20) against full-batch dSVB at equal E-step FLOPs."""
    go = _setup(backend, device)
    iters_full = 1200 if full else 400
    iters_stream = iters_full * (N_PER // BATCH)       # equal E-step FLOPs
    kl_full, _, us_full = go(iters_full, None)
    spec = stream.MinibatchSpec(batch_size=BATCH, seed=0)
    kl_stream, _, us_stream = go(iters_stream, spec)
    kl_stream_eqiter, _, _ = go(iters_full, spec)
    flops_frac = BATCH / N_PER
    ratio_eqflops = kl_stream / kl_full
    ratio_eqiter = kl_stream_eqiter / kl_full
    out = {"n_nodes": N_NODES, "n_per_node": N_PER, "batch_size": BATCH,
           "iters_full": iters_full, "iters_stream": iters_stream,
           "final_kl_full": kl_full, "final_kl_stream": kl_stream,
           "final_kl_stream_equal_iters": kl_stream_eqiter,
           "kl_ratio_equal_flops": ratio_eqflops,
           "kl_ratio_equal_iters": ratio_eqiter,
           "estep_flops_frac_per_iter": flops_frac,
           "us_per_iter_full": us_full, "us_per_iter_stream": us_stream}
    if results is not None:
        results["minibatch_bench"] = out
    # the benchmark's bar: within 10% of full batch at <= 25% of the
    # per-iteration E-step FLOPs
    if not (flops_frac <= 0.25 and ratio_eqflops <= 1.10):
        raise AssertionError(f"minibatch bar missed: {out}")
    return [
        ("minibatch_vb_full", us_full,
         f"n_iters={iters_full} final_kl={kl_full:.2f}"),
        ("minibatch_vb_stream", us_stream,
         f"B={BATCH} n_iters={iters_stream} final_kl={kl_stream:.2f}"),
        ("minibatch_vb", us_stream,
         f"kl_ratio_equal_flops={ratio_eqflops:.3f} "
         f"flops_frac={flops_frac:.2f} "
         f"kl_ratio_equal_iters={ratio_eqiter:.2f}"),
    ]


def svrg_bench(full=False, *, backend="fused", device=None, results=None):
    """SVRG streaming against plain streaming and full batch at equal
    iterations."""
    go = _setup(backend, device)
    n_iters = 1200 if full else 400
    kl_full, phi_full, us_full = go(n_iters, None)
    kl_plain, _, us_plain = go(n_iters, stream.MinibatchSpec(BATCH, seed=0))
    kl_svrg, _, us_svrg = go(n_iters, stream.MinibatchSpec(
        BATCH, seed=0, control_variate="svrg"))
    # SVRG at batch_size = capacity is the full-batch run, bit for bit
    _, phi_degen, _ = go(n_iters, stream.MinibatchSpec(
        N_PER, seed=0, control_variate="svrg"))
    degen_bitexact = bool(torch.equal(phi_degen, phi_full))
    ratio_plain = kl_plain / kl_full
    ratio_svrg = kl_svrg / kl_full
    out = {"n_nodes": N_NODES, "n_per_node": N_PER, "batch_size": BATCH,
           "n_iters": n_iters, "final_kl_full": kl_full,
           "final_kl_stream_plain": kl_plain,
           "final_kl_stream_svrg": kl_svrg,
           "kl_ratio_equal_iters_plain": ratio_plain,
           "kl_ratio_equal_iters_svrg": ratio_svrg,
           "full_batch_degeneracy_bitexact": degen_bitexact,
           "us_per_iter_full": us_full, "us_per_iter_plain": us_plain,
           "us_per_iter_svrg": us_svrg}
    if results is not None:
        results["svrg_bench"] = out
    if not (degen_bitexact and ratio_svrg <= 1.3
            and ratio_svrg <= ratio_plain):
        raise AssertionError(f"svrg bars missed: {out}")
    return [
        ("svrg_vb_plain", us_plain,
         f"B={BATCH} n_iters={n_iters} "
         f"kl_ratio_equal_iters={ratio_plain:.3f}"),
        ("svrg_vb", us_svrg,
         f"B={BATCH} n_iters={n_iters} "
         f"kl_ratio_equal_iters={ratio_svrg:.3f} "
         f"degen_bitexact={degen_bitexact}"),
    ]


ALL = [minibatch_bench, svrg_bench]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="1200 full-batch iterations (default 400)")
    ap.add_argument("--backend", default="fused",
                    choices=("fused", "reference"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark names")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    print("name,us_per_call,derived")
    for fn in ALL:
        if only is not None and fn.__name__ not in only:
            continue
        for name, us, derived in fn(args.full, backend=args.backend,
                                    device=args.device):
            print(f"{name},{us:.1f},{derived}", flush=True)


if __name__ == "__main__":
    main()
