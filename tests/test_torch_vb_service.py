"""The port's `VBService` against the JAX `VBService`, at
tests/test_driver.py's size (8 nodes x 10-25 points, seeds 0-4, K=3,
D=2, f64, the reference backend).

Each case submits the same requests to both services (the same numpy
data, arrival slices, budgets and fleet capacity), drives both to drain
(then any follow-up control ops, and drain again) and holds:

* every session's final phi within 1e-12 relative (max |port - JAX| over
  max |JAX|): the JAX fleet is itself ~1e-16 relative off its own solo
  runs (ROADMAP R1), so it is an oracle at this bar, not a bit-exact one;
* each session's t, converged, done and evicted, EQUAL;
* `DriverStats`' slices / admitted / evicted / queue_depth / active /
  capacity / compiles / occupancy and the per-bucket breakdown, EQUAL
  (after submission, and at the end).

Link failures, gossip activations and epoch permutations are the
reference's draws, injected into the port through `link_mask_fn`,
`active_mask_fn` and `MinibatchSpec.perm_fn` (torch cannot reproduce
`jax.random`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import model as jm
from repro.core import network as jn
from repro.data import stream as jstream
from repro.data import synthetic as js
from repro.serving import vb_service as jsvc
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.core import network as tn
from repro_torch.data import stream as tstream
from repro_torch.serving import vb_service as tsvc

K, D, N = 3, 2, 8
REL = 1e-12
MAX_T = 500


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a pool of threads
    synchronising on each small op runs ~10x slower when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def env():
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    tprior = tx.GMMPosterior(*(_t(v) for v in prior))
    adj, _ = jn.random_geometric_graph(N, seed=4)
    adj = np.asarray(adj)
    W = np.asarray(jn.nearest_neighbor_weights(jnp.asarray(adj)))
    return dict(jm=jm.GMMModel(prior, K, D),
                tm=tm.GMMModel(tprior, K, D, device="cpu"), adj=adj, W=W,
                jg=jn.SparseGraph.from_dense(adj),
                tg=tn.SparseGraph.from_dense(adj))


def _data(n_per, seed, free=0):
    d = js.paper_synthetic(n_nodes=N, n_per_node=n_per, seed=seed)
    mask = np.array(d.mask)
    if free:
        mask[:, -free:] = 0.0                    # room for arrivals
    return np.asarray(d.x), mask


def _jax_masks(seed, n, drop, ring=False):
    key = jax.random.PRNGKey(seed)
    draw = jn.ring_link_keep if ring else jn.sparse_link_keep
    return [np.asarray(draw(key, t, n, drop, jnp.float64))
            for t in range(MAX_T)]


def _ref_perms(seed, T):
    """perm_fn handing the port the reference's epoch permutations (each
    epoch drawn once: the hook is called per slot)."""
    keys = jstream.node_keys(N, seed)
    return functools.lru_cache(maxsize=None)(lambda e: np.asarray(
        jstream._epoch_perms(keys, jnp.asarray(e, jnp.int32), T)))


def _case(name, e):
    """(service kwargs, [request spec], [follow-up op]).  A request spec
    is (data, (jax topology, port topology), n_iters, (jax schedule, port
    schedule) or None, (jax minibatch, port minibatch) or None, tol,
    arrive_at)."""
    ring = (je.RingDiffusion(), te.RingDiffusion())
    if name == "ring_join_leave":
        budgets = [16, 24, 40, 16, 24]
        return (dict(slice_iters=8, max_fleet=3),
                [(_data(10, s), ring, n, None, None, 0.0,
                  2 if s == 4 else None)
                 for s, n in enumerate(budgets)], [])
    if name == "mixed_shapes":
        return (dict(slice_iters=6, max_fleet=4),
                [(_data(n, s), ring, 18, None, None, 0.0, None)
                 for s, n in enumerate([9, 10, 13, 16])], [])
    if name == "mixed_tau":
        return (dict(slice_iters=5, max_fleet=4),
                [(_data(12, 0), ring, 15,
                  (je.Schedule(tau=tau), te.Schedule(tau=tau)), None, 0.0,
                  None) for tau in (0.2, 0.05, 1.0)], [])
    if name == "admm_mixed_rho":
        return (dict(slice_iters=5, max_fleet=4),
                [(_data(n, n), (je.ADMMConsensus(jnp.asarray(e["adj"]),
                                                 rho=r),
                                te.ADMMConsensus(_t(e["adj"]), rho=r)),
                  12, None, None, 0.0, None)
                 for n, r in [(10, 0.3), (13, 0.8), (16, 0.5)]], [])
    if name == "admm_adaptive_and_fusion":
        topo = (je.ADMMConsensus(jnp.asarray(e["adj"]), adaptive_rho=True),
                te.ADMMConsensus(_t(e["adj"]), adaptive_rho=True))
        fusion = (je.FusionCenter(), te.FusionCenter())
        one = (je.ONE_SHOT, te.ONE_SHOT)
        # cVB (the fusion centre's one-shot jump) amplifies the engines'
        # last-ulp difference ~7x every 5 iterations: the port's and the
        # reference's SOLO runs of seed 2 are 4e-14 apart at 10
        # iterations, 5e-13 at 15, 1.4e-11 at 22; so its budgets stay at
        # 10 and 12 here (the fleet is bit-equal to the port's own solo
        # run: tests/test_torch_vb_driver.py)
        return (dict(slice_iters=6, max_fleet=2),
                [(_data(10, s), topo if s % 2 else fusion,
                  10 + 6 * s if s % 2 else 10 + s,
                  None if s % 2 else one, None, 0.0, None)
                 for s in range(4)], [])
    if name == "ring_link_masks":
        masks = _jax_masks(3, N, 0.2, ring=True)
        topo = (je.RingDiffusion(link_drop=0.2, link_seed=3),
                te.RingDiffusion(link_mask_fn=masks.__getitem__))
        return (dict(slice_iters=7, max_fleet=2),
                [(_data(12, s), topo, n, None, None, 0.0, None)
                 for s, n in enumerate([14, 21, 10])], [])
    if name == "gossip":
        m = e["jg"].n_undirected
        masks = _jax_masks(11, m, 0.5)
        topo = (je.PairwiseGossip(e["jg"], p_activate=0.5, seed=11),
                te.PairwiseGossip(e["tg"], p_activate=0.5, seed=11,
                                  active_mask_fn=masks.__getitem__))
        return (dict(slice_iters=5, max_fleet=3),
                [(_data(n, s), topo, 15, None, None, 0.0, None)
                 for s, n in enumerate([10, 13, 16])], [])
    if name == "sparse_diffusion_drop":
        m = e["jg"].n_undirected
        masks = _jax_masks(7, m, 0.3)
        topo = (je.Diffusion(jn.sparse_nearest_neighbor_weights(e["jg"]),
                             link_drop=0.3, link_seed=7),
                te.Diffusion(tn.sparse_nearest_neighbor_weights(e["tg"]),
                             link_mask_fn=masks.__getitem__))
        return (dict(slice_iters=5, max_fleet=3),
                [(_data(n, s), topo, 12 + 4 * s, None, None, 0.0, None)
                 for s, n in enumerate([10, 12, 16])], [])
    if name == "minibatch":
        # SVRG, B = 5 of 10: an epoch every 2 iterations, each one an
        # anchor refresh; minibatch sessions are never padded (their
        # group is labelled "exact")
        spec = (jstream.MinibatchSpec(5, seed=2, control_variate="svrg"),
                tstream.MinibatchSpec(5, 2, "svrg",
                                      perm_fn=_ref_perms(2, 10)))
        return (dict(slice_iters=3, max_fleet=2),
                [(_data(10, s), ring, n, None, spec, 0.0, None)
                 for s, n in enumerate([12, 9])], [])
    if name == "early_stop_extend_push":
        return (dict(slice_iters=5, max_fleet=2),
                [(_data(10, 0), ring, 400, None, None, 1e-2, None),
                 (_data(10, 1, free=4), ring, 300, None, None, 1e-2,
                  None)],
                [("extend_budget", 0, 10),
                 ("push_data", 1, 1,
                  np.random.default_rng(0).normal(size=(3, D)))])
    raise KeyError(name)


CASES = ["ring_join_leave", "mixed_shapes", "mixed_tau", "admm_mixed_rho",
         "admm_adaptive_and_fusion", "ring_link_masks", "gossip",
         "sparse_diffusion_drop", "minibatch", "early_stop_extend_push"]


def _stats_view(st):
    return (st.slices, st.compiles, st.admitted, st.evicted,
            st.queue_depth, st.active, st.capacity,
            round(st.occupancy, 12), round(st.padding_waste, 12),
            st.checkpoints,
            tuple((b.label, b.bucket_capacity, b.slots, b.admitted,
                   b.active, round(b.occupancy, 12),
                   round(b.data_pad_frac, 12)) for b in st.buckets))


def _compare(jsv, tsv, jr, tr):
    assert _stats_view(tsv.stats()) == _stats_view(jsv.stats())
    for a, b in zip(jr, tr):
        js_, ts_ = jsv.status(a), tsv.status(b)
        assert (ts_.t, ts_.budget, ts_.converged, ts_.done, ts_.evicted,
                ts_.queued) == (js_.t, js_.budget, js_.converged, js_.done,
                                js_.evicted, js_.queued), (a, b)
        want = np.asarray(js_.phi)
        err = np.abs(ts_.phi.numpy() - want).max() / np.abs(want).max()
        assert err <= REL, (a, err)


@pytest.mark.parametrize("name", CASES)
def test_port_service_matches_jax_service(env, name):
    kw, specs, ops = _case(name, env)
    jsv = jsvc.VBService(**kw)
    tsv = tsvc.VBService(device="cpu", **kw)
    jr, tr = [], []
    for data, topo, n, sched, mb, tol, at in specs:
        common = dict(n_iters=n, tol=tol)
        jkw, tkw = dict(common), dict(common)
        if sched is not None:
            jkw["schedule"], tkw["schedule"] = sched
        if mb is not None:
            jkw["minibatch"], tkw["minibatch"] = mb
        jr.append(jsv.submit(jsvc.VBRequest(
            model=env["jm"], data=tuple(jnp.asarray(a) for a in data),
            topology=topo[0], **jkw), arrive_at=at))
        tr.append(tsv.submit(tsvc.VBRequest(
            model=env["tm"], data=tuple(_t(a) for a in data),
            topology=topo[1], **tkw), arrive_at=at))
    assert _stats_view(tsv.stats()) == _stats_view(jsv.stats())
    jsv.run()
    tsv.run()
    _compare(jsv, tsv, jr, tr)
    for op in ops:
        i = op[1]
        getattr(jsv, op[0])(jr[i], *op[2:])
        getattr(tsv, op[0])(tr[i], *op[2:])
        _compare(jsv, tsv, jr, tr)
        jsv.run()
        tsv.run()
        _compare(jsv, tsv, jr, tr)
