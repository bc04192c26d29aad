"""Topology scale sweep: the dense oracle against the sparse edge-list
combines at N in {50, 1k, 10k} sensors (20 points a node).

Port of `benchmarks/topology_scale_bench.py`.  For each network size it
times one VB iteration (us an iteration on the host clock, the device
synchronised, a short warm-up run first) and records the Eq. 46
KL-vs-iterations trajectory of sparse diffusion (Eq. 47 weights),
pairwise gossip (p = 0.3, seed 5) and hierarchical fusion
(`two_level_partition(N, N//16, N//128)`), plus the dense-matrix
diffusion oracle up to N = 1000 (at 10k the dense f64 mixing matrix
alone is 800 MB, which is the point of the sparse path).  The reference
asserts that the lowered sparse combine holds no (N, N) tensor; here
every operator's input and output shapes over one VB iteration are
recorded (`op_shapes`, a dispatch mode) and none may have two dimensions
>= N.

    python -m repro_torch.experiments.topology_scale --device cpu \\
        --max-iters 10
    python -m repro_torch.experiments.topology_scale --full   # on the card

It prints one line per row (name, us an iteration, the derived string)
and writes nothing.  The gossip coins are the port's (the reference's
come from `jax.random`): `gossip_mask_fn` takes another source, e.g. the
reference's activations in the parity test.
"""
from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import device as device_lib
from repro_torch.core import engine, expfam, gmm, network, refperm
from repro_torch.core.model import GMMModel
from repro_torch.data import synthetic
from repro_torch.experiments import common

K, D = 3, 2
N_PER = 20
N_SWEEP = (50, 1_000, 10_000)
DENSE_MAX = 1_000            # largest N the dense oracle still runs at
GOSSIP_P, GOSSIP_SEED = 0.3, 5


def n_iters(n: int, full: bool) -> int:
    """The reference's iteration counts."""
    if n <= 50:
        return 400 if full else 100
    if n <= 1_000:
        return 120 if full else 40
    return 60 if full else 16


def setup(n: int, device):
    """(data, model, Eq. 46 reference stack, SparseGraph) at N = n."""
    data = synthetic.paper_synthetic(n_nodes=n, n_per_node=N_PER, seed=0)
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        dtype=torch.float64, device=device)
    mdl = GMMModel(prior, K, D, device=device)
    x_all, labels = data.flat
    ref = gmm.ground_truth_posterior(x_all.to(device), labels.to(device),
                                     prior, K)
    g, _pos = network.random_geometric_edges(n, seed=0)
    return data, mdl, refperm.permuted_refs(ref), g


def topologies(n: int, g, gossip_mask_fn=None) -> list:
    """[(name, topology)] of the sweep at N = n."""
    sw = network.sparse_nearest_neighbor_weights(g)
    n_gw = max(1, n // 16)
    gw, rg = network.two_level_partition(n, n_gw, max(1, n_gw // 8))
    topos = [
        ("sparse_diffusion", engine.Diffusion(sw)),
        ("gossip", engine.PairwiseGossip(g, p_activate=GOSSIP_P,
                                         seed=GOSSIP_SEED,
                                         active_mask_fn=gossip_mask_fn)),
        ("hierarchical", engine.HierarchicalFusion(gw, rg)),
    ]
    if n <= DENSE_MAX:
        W = network.nearest_neighbor_weights(torch.from_numpy(
            g.to_dense()))
        topos.insert(0, ("dense_diffusion", engine.Diffusion(W)))
    return topos


class _ShapeRecord(TorchDispatchMode):
    """Records every aten operator with its input and output shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = [tuple(a.shape) for a in tree_leaves((args, kwargs, out))
                  if isinstance(a, torch.Tensor)]
        self.ops.append((str(func), shapes))
        return out


def op_shapes(fn) -> list:
    """[(operator, [shape, ...])] of every aten operator fn() runs."""
    with _ShapeRecord() as rec:
        fn()
    return rec.ops


def square_ops(ops: list, n: int) -> list:
    """The operators with a tensor of two or more dimensions >= n: an
    (N, N) intermediate, or anything as large."""
    return [(op, s) for op, s in ops
            if any(sum(d >= n for d in shape) >= 2 for shape in s)]


def _session(mdl, data, topo, ref_phis, device):
    return engine.vb_init(mdl, (data.x, data.mask), topo, ref_phi=ref_phis,
                          schedule=engine.Schedule(), device=device)


def _time_run(mdl, data, topo, iters, ref_phis, device):
    engine.vb_run(_session(mdl, data, topo, ref_phis, device), 2)  # warm-up
    run, wall = common.timed(lambda: engine.run_vb(
        mdl, (data.x, data.mask), topo, n_iters=iters, ref_phi=ref_phis,
        schedule=engine.Schedule(), device=device))
    return run.kl_mean.cpu().numpy(), common.us_per_iter(wall, iters)


def run(full: bool = False, *, device=None, max_iters: int | None = None,
        sizes=N_SWEEP, gossip_mask_fn=None):
    """The sweep: (rows [(name, us an iteration, derived)], payload
    {f"{topology}_n{N}": {us_per_iter, n_iters, edges, kl_vs_iters,
    square_ops}}).  `gossip_mask_fn(n)` (optional) returns the gossip
    topology's `active_mask_fn` at N = n."""
    dev = device_lib.resolve(device)
    rows, payload = [], {}
    for n in sizes:
        iters = n_iters(n, full)
        if max_iters is not None:
            iters = min(iters, max_iters)
        data, mdl, ref_phis, g = setup(n, dev)
        mask_fn = None if gossip_mask_fn is None else gossip_mask_fn(n)
        for tname, topo in topologies(n, g, mask_fn):
            kl, us = _time_run(mdl, data, topo, iters, ref_phis, dev)
            name = f"topology_scale_{tname}_n{n}"
            derived = (f"edges={g.n_undirected} n_iters={iters} "
                       f"kl0={kl[0]:.1f} kl_final={kl[-1]:.2f}")
            bad = None
            if tname != "dense_diffusion":
                state = _session(mdl, data, topo, ref_phis, dev)
                bad = square_ops(op_shapes(lambda: engine.vb_step(state)), n)
                if bad:
                    raise AssertionError(f"{name}: an (N, N) tensor in one "
                                         f"iteration: {bad[:3]}")
                if n > DENSE_MAX:
                    derived += (f" no_nxn_ops=True"
                                f" dense_bytes_avoided={8 * n * n}")
            rows.append((name, us, derived))
            payload[f"{tname}_n{n}"] = {
                "us_per_iter": us, "n_iters": iters,
                "edges": g.n_undirected, "kl_vs_iters": kl.tolist(),
                "square_ops": None if bad is None else len(bad)}
    return rows, payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the reference's full iteration counts")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="cap every run's iterations")
    args = ap.parse_args(argv)
    rows, _ = run(args.full, device=args.device, max_iters=args.max_iters)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}", flush=True)


if __name__ == "__main__":
    main()
