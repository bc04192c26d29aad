"""The sparse path at scale: the fused backend on sparse topologies, the
no-(N, N) contract, and experiments/topology_scale against the JAX
benchmark's runs.

* fused (on the CPU the kernel's plain version, f32) against the JAX
  reference backend in f32 at rtol/atol 1e-4 on the Eq. 46 trajectory:
  tests/test_backends.py's bar, at tests/test_sparse_topology.py's N = 16
  instance;
* one VB iteration on every sparse topology at N = 2048 runs no operator
  with a tensor of two dimensions >= N (every aten operator's input and
  output shapes recorded by a dispatch mode); the dense combine does, so
  the probe bites;
* `topology_scale.run` at N = 50, 12 iterations, against the same runs
  of benchmarks/topology_scale_bench.py's setup in JAX: trajectories at
  rtol 1e-9 (f64), derived strings equal (the gossip activations
  injected).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import gmm as jg
from repro.core import model as jm
from repro.core import network as jn
from repro.core import refperm as jr
from repro.data import synthetic as js
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.core import network as tn
from repro_torch.experiments import topology_scale

REPO = Path(__file__).resolve().parents[1]
K, D = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _masks(seed, n_undirected, drop, n, dtype):
    key = jax.random.PRNGKey(seed)
    return [np.array(jn.sparse_link_keep(key, t, n_undirected, drop, dtype))
            for t in range(n)]


def test_fused_backend_sparse_vs_jax_reference():
    """f32 data and iterates, 16 nodes x 30 points, 20 iterations: the
    port's fused backend against JAX's reference backend and against the
    port's reference backend, Diffusion / gossip / hierarchy."""
    jax.config.update("jax_enable_x64", False)
    try:
        n, iters = 16, 20
        data = js.paper_synthetic(n_nodes=n, n_per_node=30, seed=9,
                                  dtype=np.float32)
        prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        dtype=jnp.float32)
        mdl = jm.GMMModel(prior, K, D)
        adj, _ = jn.random_geometric_graph(n, seed=4)
        a = np.asarray(adj)
        g, tg = jn.SparseGraph.from_dense(a), tn.SparseGraph.from_dense(a)
        x_all, labels = data.flat
        ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels,
                                                         prior, K))
        gw, rg = jn.two_level_partition(n, 4, 2)
        tgw, trg = tn.two_level_partition(n, 4, 2)
        masks = _masks(3, g.n_undirected, 1.0 - 0.5, iters, jnp.float32)
        tprior = tx.GMMPosterior(*(_t(v) for v in prior))
        cases = [
            (je.Diffusion(jn.sparse_nearest_neighbor_weights(g)),
             te.Diffusion(tn.sparse_nearest_neighbor_weights(tg))),
            (je.PairwiseGossip(g, p_activate=0.5, seed=3),
             te.PairwiseGossip(tg, p_activate=0.5, seed=3,
                               active_mask_fn=masks.__getitem__)),
            (je.HierarchicalFusion(gw, rg), te.HierarchicalFusion(tgw, trg)),
        ]
        for jtopo, ttopo in cases:
            want = je.run_vb(mdl, (data.x, data.mask), jtopo, n_iters=iters,
                             ref_phi=ref, backend="reference",
                             schedule=je.Schedule())
            got = {}
            for be in ("fused", "reference"):
                got[be] = te.run_vb(
                    tm.GMMModel(tprior, K, D, device="cpu"),
                    (_t(data.x), _t(data.mask)), ttopo, n_iters=iters,
                    ref_phi=_t(ref), backend=be, schedule=te.Schedule(),
                    device="cpu")
            assert got["fused"].phi.dtype == torch.float32
            for be in ("fused", "reference"):
                np.testing.assert_allclose(got[be].kl_mean.numpy(),
                                           np.asarray(want.kl_mean),
                                           rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got["fused"].kl_mean.numpy(),
                                       got["reference"].kl_mean.numpy(),
                                       rtol=1e-4, atol=1e-4)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_no_square_tensor_in_a_sparse_iteration():
    n = 2048
    ring = tn.SparseGraph.ring(n)
    sw = tn.sparse_nearest_neighbor_weights(ring)
    gw, rg = tn.two_level_partition(n, 64, 8)
    prior = tx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    mdl = tm.GMMModel(prior, K, D, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, 4, D)))
    mask = torch.ones(n, 4, dtype=torch.float64)
    topos = [
        te.Diffusion(sw, link_drop=0.1),
        te.RingDiffusion(graph=ring, link_drop=0.2),
        te.PairwiseGossip(ring, p_activate=0.3),
        te.HierarchicalFusion(gw, rg),
        te.ADMMConsensus(ring, adaptive_rho=True, per_block=True,
                         link_drop=0.2),
    ]
    for topo in topos:
        kw = {} if isinstance(topo, te.ADMMConsensus) else dict(
            schedule=te.Schedule())
        state = te.vb_init(mdl, (x, mask), topo, device="cpu", **kw)
        ops = topology_scale.op_shapes(lambda: te.vb_step(state))
        assert len(ops) > 20
        assert topology_scale.square_ops(ops, n) == [], type(topo).__name__
    # the probe bites: the dense combine multiplies an (N, N) matrix
    dense = te.Diffusion(torch.eye(n, dtype=torch.float64))
    v = torch.zeros(n, 8, dtype=torch.float64)
    assert topology_scale.square_ops(
        topology_scale.op_shapes(lambda: dense.combine(v)), n)


def test_topology_scale_matches_jax_benchmark():
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks import topology_scale_bench as jb
    finally:
        sys.path.remove(str(REPO))
    n, iters = 50, 12
    data, mdl, ref_phis, g = jb._setup(n)
    masks = _masks(topology_scale.GOSSIP_SEED, g.n_undirected,
                   1.0 - topology_scale.GOSSIP_P, iters, jnp.float64)
    rows, payload = topology_scale.run(
        sizes=(n,), max_iters=iters, device="cpu",
        gossip_mask_fn=lambda _n: masks.__getitem__)
    sw = jn.sparse_nearest_neighbor_weights(g)
    gw, rg = jn.two_level_partition(n, max(1, n // 16),
                                    max(1, n // 16 // 8))
    jtopos = {
        "dense_diffusion": je.Diffusion(jn.nearest_neighbor_weights(
            jnp.asarray(g.to_dense()))),
        "sparse_diffusion": je.Diffusion(sw),
        "gossip": je.PairwiseGossip(g, p_activate=0.3, seed=5),
        "hierarchical": je.HierarchicalFusion(gw, rg),
    }
    assert [r[0] for r in rows] == [f"topology_scale_{k}_n{n}"
                                    for k in jtopos]
    for (name, us, derived), (tname, topo) in zip(rows, jtopos.items()):
        kl = np.asarray(je.run_vb(mdl, (data.x, data.mask), topo,
                                  n_iters=iters, ref_phi=ref_phis,
                                  schedule=je.Schedule()).kl_mean)
        got = payload[f"{tname}_n{n}"]
        np.testing.assert_allclose(got["kl_vs_iters"], kl, rtol=1e-9)
        assert derived == (f"edges={g.n_undirected} n_iters={iters} "
                           f"kl0={kl[0]:.1f} kl_final={kl[-1]:.2f}")
        assert us > 0.0 and got["edges"] == g.n_undirected
        assert got["square_ops"] == (None if tname == "dense_diffusion"
                                     else 0)
    assert topology_scale.n_iters(10_000, True) == 60
    assert topology_scale.n_iters(1_000, False) == 40
