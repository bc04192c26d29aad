"""The port's sparse topologies against repro.core.engine's.

The tests/test_sparse_topology.py instance (50 nodes x 20 points, f64,
reference backend, the graph of `random_geometric_graph(50, seed=4)` in
edge-list form, every node starting at the prior as there: from a
perturbed start plain Algorithm 2 diverges on this imbalanced instance,
KL ~1e7 within 25 iterations, where no 1e-9 comparison means anything).
Bars, each stated where it is checked:

* port sparse vs JAX sparse, whole runs: rtol/atol 1e-9 on phi, the
  Eq. 46 trajectory, the consensus error, every carry leaf and every
  ConsensusDiagnostics field (the f64 engine bar of
  tests/test_torch_engine.py).  Where links drop or gossip activates,
  the reference's `jax.random` masks are injected (`link_mask_fn`,
  `PairwiseGossip(active_mask_fn=)`): torch cannot reproduce them.
* port sparse vs port dense, one combine: 1e-12 relative (the same sums
  in another order).
* split/resume on the port: bit for bit.
"""
from types import SimpleNamespace

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
from repro_torch.core import algorithms as ta
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.core import network as tn

K, D, N, N_ITERS = 3, 2, 50, 25
TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def inst():
    data = js.paper_synthetic(n_nodes=N, n_per_node=20, seed=2)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    adj, _ = jn.random_geometric_graph(N, seed=4)
    a = np.asarray(adj, np.float64)
    x_all, labels = data.flat
    ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels, prior,
                                                     K))
    jmdl = jm.GMMModel(prior, K, D)
    tprior = tx.GMMPosterior(*(_t(v) for v in prior))
    return SimpleNamespace(
        data=data, prior=prior, adj=a, ref=ref, jmdl=jmdl,
        jg=jn.SparseGraph.from_dense(a), tg=tn.SparseGraph.from_dense(a),
        phi0=jnp.broadcast_to(jx.pack_natural(prior), (N, jmdl.flat_dim)),
        x=_t(data.x), mask=_t(data.mask), tprior=tprior, tref=_t(ref),
        tmdl=tm.GMMModel(tprior, K, D, device="cpu"),
        tphi0=tx.pack_natural(tprior).expand(N, jmdl.flat_dim))


def _jrun(s, topo, n_iters=N_ITERS, **kw):
    return je.run_vb(s.jmdl, (s.data.x, s.data.mask), topo, n_iters=n_iters,
                     init_phi=s.phi0, ref_phi=s.ref, **kw)


def _trun(s, topo, n_iters=N_ITERS, **kw):
    return te.run_vb(s.tmdl, (s.x, s.mask), topo, n_iters=n_iters,
                     init_phi=s.tphi0, ref_phi=s.tref, device="cpu", **kw)


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _same_run(b, a, carry=None, jcarry=None):
    """Port run b against JAX run a at the 1e-9 bar: phi, kl_nodes,
    consensus_err, every ConsensusDiagnostics field, every carry leaf."""
    _close(b.phi, a.phi, what="phi")
    _close(b.kl_nodes, a.kl_nodes, what="kl_nodes")
    _close(b.consensus_err, a.consensus_err, atol=1e-20,
           what="consensus_err")
    if a.consensus_diag is not None:
        for f in je.ConsensusDiagnostics._fields:
            _close(getattr(b.consensus_diag, f),
                   getattr(a.consensus_diag, f), what=f)
    if jcarry is not None:
        la = jax.tree_util.tree_leaves(jcarry)
        lb = [carry] if isinstance(carry, torch.Tensor) else list(carry)
        assert len(la) == len(lb)
        for i, (x, y) in enumerate(zip(lb, la)):
            _close(x, y, what=f"carry[{i}]")


def _jax_masks(seed, n_undirected, drop, n=N_ITERS):
    """The reference's iteration-t sparse link masks (its `keep_edges`)."""
    key = jax.random.PRNGKey(seed)
    return [np.asarray(jn.sparse_link_keep(key, t, n_undirected, drop,
                                           jnp.float64))
            for t in range(n)]


ESTIMATORS = ["cvb", "noncoop", "nsg_dvb", "dsvb", "dvb_admm"]


@pytest.mark.parametrize("est", ESTIMATORS)
def test_five_estimators_sparse_vs_jax(inst, est):
    """algorithms.run_* take the sparse forms (SparseWeights for nsg-dVB
    and dSVB, a SparseGraph for dVB-ADMM) and match the reference's
    sparse run_vb."""
    s = inst
    jsw = jn.sparse_nearest_neighbor_weights(s.jg)
    tsw = tn.sparse_nearest_neighbor_weights(s.tg)
    jtopo, graph, kw = {
        "cvb": (je.FusionCenter(), (), dict(schedule=je.ONE_SHOT,
                                           metric_nodes=1)),
        "noncoop": (je.Isolated(), (), dict(schedule=je.ONE_SHOT,
                                           replication=1.0)),
        "nsg_dvb": (je.Diffusion(jsw), (tsw,), dict(schedule=je.ONE_SHOT)),
        "dsvb": (je.Diffusion(jsw), (tsw,), dict(schedule=je.Schedule())),
        "dvb_admm": (je.ADMMConsensus(s.jg), (s.tg,), {}),
    }[est]
    a = _jrun(s, jtopo, **kw)
    b = ta.ALGORITHMS[est](s.x, s.mask, *graph, s.tprior, n_iters=N_ITERS,
                           K=K, D=D, ref_phi=s.tref,
                           device="cpu")
    _close(b.phi, a.phi, what="phi")
    _close(b.kl_nodes, a.kl_nodes, what="kl_nodes")
    if est == "dvb_admm":
        for f in je.ConsensusDiagnostics._fields:
            _close(getattr(b.consensus_diag, f),
                   getattr(a.consensus_diag, f), what=f)


def _variant(s, name):
    """(JAX topology, port topology, run kwargs) of a sparse variant; link
    failures drawn by the reference and injected into the port."""
    g, tg = s.jg, s.tg
    m = g.n_undirected
    if name == "metropolis":
        return (je.Diffusion(jn.sparse_metropolis_weights(g)),
                te.Diffusion(tn.sparse_metropolis_weights(tg)), True)
    if name == "admm_adaptive_per_block":
        return (je.ADMMConsensus(g, adaptive_rho=True, per_block=True),
                te.ADMMConsensus(tg, adaptive_rho=True, per_block=True),
                False)
    if name == "ring_drop":
        masks = _jax_masks(3, N, 0.4)
        return (je.RingDiffusion(graph=jn.SparseGraph.ring(N),
                                 link_drop=0.4, link_seed=3),
                te.RingDiffusion(graph=tn.SparseGraph.ring(N),
                                 link_mask_fn=masks.__getitem__), True)
    if name == "diffusion_drop":
        masks = _jax_masks(7, m, 0.3)
        return (je.Diffusion(jn.sparse_nearest_neighbor_weights(g),
                             link_drop=0.3, link_seed=7),
                te.Diffusion(tn.sparse_nearest_neighbor_weights(tg),
                             link_mask_fn=masks.__getitem__), True)
    if name == "admm_adaptive_drop":
        masks = _jax_masks(1, m, 0.2)
        return (je.ADMMConsensus(g, adaptive_rho=True, per_block=True,
                                 link_drop=0.2, link_seed=1),
                te.ADMMConsensus(tg, adaptive_rho=True, per_block=True,
                                 link_mask_fn=masks.__getitem__), False)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["metropolis", "admm_adaptive_per_block",
                                  "ring_drop", "diffusion_drop",
                                  "admm_adaptive_drop"])
def test_sparse_variants_vs_jax(inst, name):
    s = inst
    jtopo, ttopo, sched = _variant(s, name)
    kw = dict(schedule=je.Schedule()) if sched else {}
    tkw = dict(schedule=te.Schedule()) if sched else {}
    js_ = je.vb_init(s.jmdl, (s.data.x, s.data.mask), jtopo,
                     init_phi=s.phi0, ref_phi=s.ref, **kw)
    js_, a = je.vb_run(js_, N_ITERS)
    ts_ = te.vb_init(s.tmdl, (s.x, s.mask), ttopo, init_phi=s.tphi0,
                     ref_phi=s.tref, device="cpu", **tkw)
    ts_, b = te.vb_run(ts_, N_ITERS)
    _same_run(b, a, ts_.carry, js_.carry)
    if name.endswith("drop"):
        assert float(b.consensus_err[-1]) > 0.0
    if name == "admm_adaptive_drop":
        assert float(b.consensus_diag.link_frac.min()) < 1.0


def test_sparse_vs_port_dense_one_combine(inst):
    """One combine on random iterates: each sparse form against the
    port's dense form of the same graph, at 1e-12 relative, with links
    dropping (the port's coins, both forms drawing the same ones: the
    dense coin of pair (i, j), i < j, is its own; so the masks are
    handed over explicitly)."""
    s = inst
    rng = np.random.default_rng(0)
    varphi = torch.from_numpy(rng.uniform(1.0, 2.0, size=(N, 27)))
    tg, A = s.tg, torch.from_numpy(s.adj)
    u, v = s.jg.senders, s.jg.receivers
    keep_und = (torch.from_numpy(rng.uniform(size=tg.n_undirected))
                >= 0.3).double()

    def dense_keep(keep):                     # (E_und,) -> (N, N)
        K_ = torch.zeros(N, N, dtype=torch.float64)
        K_[torch.as_tensor(np.asarray(u), dtype=torch.int64),
           torch.as_tensor(np.asarray(v), dtype=torch.int64)] = \
            keep[tg.edge_id]
        return K_

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for build in (tn.sparse_nearest_neighbor_weights,
                  tn.sparse_metropolis_weights):
        sw = build(tg)
        W = (tn.nearest_neighbor_weights(A) if build is
             tn.sparse_nearest_neighbor_weights else tn.metropolis_weights(A))
        assert rel(te.Diffusion(sw).combine(varphi),
                   te.Diffusion(W).combine(varphi)) <= 1e-12
        got = te.Diffusion(sw, link_mask_fn=lambda t: keep_und).combine(
            varphi, t=0)
        want = te.Diffusion(W, link_mask_fn=lambda t: dense_keep(keep_und)
                            ).combine(varphi, t=0)
        assert rel(got, want) <= 1e-12
    # ring: edge list against the two rolls, link (i, i+1) gated alike
    ring = tn.SparseGraph.ring(N)
    e = (torch.from_numpy(rng.uniform(size=N)) >= 0.4).double()
    for w_self in (1.0 / 3.0, 0.0):
        for mk in (None, lambda t: e):
            got = te.RingDiffusion(w_self, graph=ring, link_mask_fn=mk)
            want = te.RingDiffusion(w_self, link_mask_fn=mk)
            assert rel(got.combine(varphi, t=0),
                       want.combine(varphi, t=0)) <= 1e-12
    # ADMM's degrees and neighbour sum, static and with drops
    for mk in (None, "drop"):
        sp = te.ADMMConsensus(tg, link_mask_fn=None if mk is None
                              else (lambda t: keep_und))
        dn = te.ADMMConsensus(A, link_mask_fn=None if mk is None
                              else (lambda t: dense_keep(keep_und)))
        d1, ns1, f1 = sp._graph_ops(varphi, 0)
        d2, ns2, f2 = dn._graph_ops(varphi, 0)
        assert torch.equal(d1, d2)
        assert rel(ns1(varphi), ns2(varphi)) <= 1e-12
        assert abs(float(f1) - float(f2)) <= 1e-15
    # every link active: gossip is dense Eq. 47 diffusion
    got = te.PairwiseGossip(tg, p_activate=1.0).combine(varphi, t=5)
    want = te.Diffusion(tn.nearest_neighbor_weights(A)).combine(varphi)
    assert rel(got, want) <= 1e-12


def test_gossip_vs_jax_with_injected_activations(inst):
    s = inst
    p, seed = 0.4, 11
    masks = _jax_masks(seed, s.jg.n_undirected, 1.0 - p)
    a = _jrun(s, je.PairwiseGossip(s.jg, p_activate=p, seed=seed),
              schedule=je.Schedule())
    b = _trun(s, te.PairwiseGossip(s.tg, p_activate=p, seed=seed,
                                   active_mask_fn=masks.__getitem__),
              schedule=te.Schedule())
    _same_run(b, a)
    # p = 1 is dense Eq. 47 diffusion, over a whole run
    full = _trun(s, te.PairwiseGossip(s.tg, p_activate=1.0),
                 schedule=te.Schedule())
    dense = _trun(s, te.Diffusion(tn.nearest_neighbor_weights(
        torch.from_numpy(s.adj))), schedule=te.Schedule())
    _close(full.phi, dense.phi, what="p=1")
    with pytest.raises(ValueError, match="p_activate"):
        te.PairwiseGossip(s.tg, p_activate=0.0)
    with pytest.raises(ValueError, match="SparseGraph"):
        te.PairwiseGossip(torch.from_numpy(s.adj))
    with pytest.raises(ValueError, match="iteration"):
        te.PairwiseGossip(s.tg).combine(torch.zeros(N, 2))


def test_hierarchical_vs_jax(inst):
    s = inst
    gw, rg = jn.two_level_partition(N, 8, 2)
    tgw, trg = tn.two_level_partition(N, 8, 2)
    _same_run(_trun(s, te.HierarchicalFusion(tgw, trg),
                    schedule=te.Schedule()),
              _jrun(s, je.HierarchicalFusion(gw, rg),
                    schedule=je.Schedule()))
    # the FusionCenter limit: one region, no self or gateway weight
    g1, r1 = tn.two_level_partition(N, 1, 1)
    _close(_trun(s, te.HierarchicalFusion(g1, r1, w_self=0.0,
                                          w_gateway=0.0),
                 schedule=te.ONE_SHOT).phi,
           _trun(s, te.FusionCenter(), schedule=te.ONE_SHOT).phi,
           what="fusion-centre limit")
    # unsorted maps: sensors scattered over gateways, gateways over regions
    rng = np.random.default_rng(5)
    ugw = rng.permutation(np.arange(N) % 8)
    urg = np.array([1, 0, 2, 1, 0, 2, 2, 0])
    ht = te.HierarchicalFusion(torch.from_numpy(ugw), urg, w_self=0.2,
                               w_gateway=0.5)
    _same_run(_trun(s, ht, schedule=te.Schedule()),
              _jrun(s, je.HierarchicalFusion(ugw, urg, w_self=0.2,
                                             w_gateway=0.5),
                    schedule=je.Schedule()))
    for bad, match in (((np.array([0, 2]), np.array([0, 0])), "index"),
                       ((np.array([0, 0]), np.array([0, 0])), "gateway"),
                       ((np.array([0, 1]), np.array([0, 2])), "region"),
                       ((np.array([[0]]), np.array([0])), "1-D")):
        with pytest.raises(ValueError, match=match):
            te.HierarchicalFusion(*bad)
    with pytest.raises(ValueError, match="convex"):
        te.HierarchicalFusion(tgw, trg, w_self=0.7, w_gateway=0.5)


def test_gossip_contracts_disagreement(inst):
    """Repeated gossip averaging reaches consensus inside the convex hull
    of the starting iterates (every row is a convex combination)."""
    topo = te.PairwiseGossip(inst.tg, p_activate=0.3, seed=5)
    x0 = torch.from_numpy(np.random.default_rng(0).normal(size=(N, 5)))
    x = x0
    for t in range(600):
        x = topo.combine(x, t=t)
    assert float((x - x.mean(0, keepdim=True)).abs().max()) < 1e-5
    assert bool((x.amin(0) >= x0.amin(0) - 1e-9).all())
    assert bool((x.amax(0) <= x0.amax(0) + 1e-9).all())


def _split_topologies(s):
    sw = tn.sparse_nearest_neighbor_weights(s.tg)
    gw, rg = tn.two_level_partition(N, 8, 2)
    return {
        "gossip": lambda: te.PairwiseGossip(s.tg, p_activate=0.4, seed=11),
        "hier": lambda: te.HierarchicalFusion(gw, rg),
        "sparse_diffusion_drop": lambda: te.Diffusion(sw, link_drop=0.3,
                                                      link_seed=7),
        "sparse_admm_adaptive_drop": lambda: te.ADMMConsensus(
            s.tg, adaptive_rho=True, link_drop=0.2),
    }


@pytest.mark.parametrize("name", ["gossip", "hier", "sparse_diffusion_drop",
                                  "sparse_admm_adaptive_drop"])
def test_split_resume_bitexact(inst, name):
    """vb_run(s, a + b) == vb_run(vb_run(s, a), b), bit for bit: every
    per-iteration draw is keyed on the absolute t."""
    s = inst
    make = _split_topologies(s)[name]
    kw = {} if "admm" in name else dict(schedule=te.Schedule())

    def fresh():
        return te.vb_init(s.tmdl, (s.x, s.mask), make(), init_phi=s.tphi0,
                          ref_phi=s.tref, device="cpu", **kw)

    a, b = 17, 23
    whole, run = te.vb_run(fresh(), a + b)
    half, run_a = te.vb_run(fresh(), a)
    half, run_b = te.vb_run(half, b)
    assert whole.t == half.t == a + b
    assert torch.equal(whole.phi, half.phi)
    assert torch.equal(run.kl_nodes, torch.cat([run_a.kl_nodes,
                                                run_b.kl_nodes]))
    if whole.carry is not None:
        for x, y in zip(whole.carry, half.carry):
            assert torch.equal(x, y)
        for f in whole.diag._fields:
            assert torch.equal(getattr(whole.diag, f), getattr(half.diag, f))
