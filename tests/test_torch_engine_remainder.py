"""The port's engine remainder against repro.core.engine: RingDiffusion,
time-varying links (link_drop / link_mask_fn) on Diffusion, RingDiffusion
and ADMMConsensus, and the adaptive-penalty ADMM subsystem.

The tests/test_engine.py GMM instance (8 nodes x 20 points, K=3, D=2, the
reference's `_perturbed_init` draws handed to the port's
`perturbed_init`), reference backend, float64: final phi, the Eq. 46
trajectory and every ConsensusDiagnostics field at rtol 1e-9 (as
tests/test_torch_engine.py).  torch cannot reproduce `jax.random`, so the
reference's link masks are drawn with `repro.core.network` and injected
into both packages through `link_mask_fn`.  The clip and reset paths are
driven by a forced projection on the Normal-Gamma instance
(tests/test_consensus_adaptive.py's `_ClampedLinReg`): on the GMM
instance the Eq. 38b clip does not fire (ROADMAP R3).  The port's own
link coins and the split-run contract are checked exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as ja
from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import gmm as jg
from repro.core import linreg as jlin
from repro.core import model as jm
from repro.core import network as jn
from repro.core import refperm as jr
from repro.data import synthetic as js
from repro_torch.core import algorithms as ta
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import linreg as tlin
from repro_torch.core import model as tm
from repro_torch.core import network as tn

K, D, N_NODES, N_ITERS = 3, 2, 8, 30
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def inst():
    data = js.paper_synthetic(n_nodes=N_NODES, n_per_node=20, seed=2)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    adj, _ = jn.random_geometric_graph(N_NODES, seed=4)
    W = jn.nearest_neighbor_weights(adj)
    u = jax.random.uniform(jax.random.PRNGKey(3), (K, D), jnp.float64)
    init_q = ja._perturbed_init(prior, data.x, jax.random.PRNGKey(3))
    x_all, labels = data.flat
    ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels, prior,
                                                     K))
    tprior = tx.GMMPosterior(*(_t(a) for a in prior))
    t_init = ta.perturbed_init(tprior, _t(data.x), np.asarray(u))
    for a, b in zip(t_init, init_q):      # perturbed_init with the draws
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    j = dict(x=data.x, mask=data.mask, prior=prior, adj=adj, W=W, ref=ref,
             phi0=jnp.broadcast_to(jx.pack_natural(init_q),
                                   (N_NODES, jx.flat_dim(K, D))))
    t = dict(x=_t(data.x), mask=_t(data.mask), prior=tprior, adj=_t(adj),
             W=_t(W), ref=_t(ref),
             phi0=tx.pack_natural(t_init).expand(N_NODES, -1).clone())
    return j, t


def _masks(kind, n, n_iters, p=0.3, seed=5):
    """The reference's keep masks for iterations 0..n_iters-1."""
    key = jax.random.PRNGKey(seed)
    fn = jn.link_keep_matrix if kind == "matrix" else jn.ring_link_keep
    return np.stack([np.asarray(fn(key, t, n, p, jnp.float64))
                     for t in range(n_iters)])


def _runs(inst, make_topology, schedule=None, n_iters=N_ITERS):
    """The same run in both packages; make_topology(pkg, args)."""
    j, t = inst
    out = []
    for pkg, a in (("jax", j), ("torch", t)):
        eng, mdl = (je, jm.GMMModel(a["prior"], K, D)) if pkg == "jax" \
            else (te, tm.GMMModel(a["prior"], K, D, device="cpu"))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        if schedule is not None:
            kw["schedule"] = eng.Schedule(tau=schedule)
        out.append(eng.run_vb(mdl, (a["x"], a["mask"]),
                              make_topology(pkg, a), n_iters=n_iters,
                              init_phi=a["phi0"], ref_phi=a["ref"], **kw))
    return out


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _same_run(a, b, rtol=RTOL):
    _close(b.phi, a.phi, rtol)
    _close(b.kl_mean, a.kl_mean, rtol)
    _close(b.consensus_err, a.consensus_err, rtol)
    if a.consensus_diag is not None:
        for f in je.ConsensusDiagnostics._fields:
            _close(getattr(b.consensus_diag, f),
                   getattr(a.consensus_diag, f), rtol, atol=1e-300)


# ---------------------------------------------------------------------------
# RingDiffusion and time-varying links
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w_self,links", [(1.0 / 3.0, False), (0.5, True),
                                          (0.0, True)])
def test_ring_diffusion_matches_reference(inst, w_self, links):
    """dSVB on the ring; with injected (N,) ring masks, including
    w_self = 0, where a node with both links down keeps its iterate."""
    masks = _masks("ring", N_NODES, N_ITERS, p=0.5) if links else None

    def topo(pkg, a):
        if pkg == "jax":
            fn = None if masks is None else \
                (lambda t: jnp.asarray(masks)[t])
            return je.RingDiffusion(w_self, link_mask_fn=fn)
        fn = None if masks is None else (lambda t: masks[t])
        return te.RingDiffusion(w_self, link_mask_fn=fn)

    _same_run(*_runs(inst, topo, schedule=0.2))


def test_diffusion_link_masks_match_reference(inst):
    masks = _masks("matrix", N_NODES, N_ITERS)
    runs = _runs(inst, lambda pkg, a: (
        je.Diffusion(a["W"], link_mask_fn=lambda t: jnp.asarray(masks)[t])
        if pkg == "jax" else
        te.Diffusion(a["W"], link_mask_fn=lambda t: masks[t])),
        schedule=0.2)
    _same_run(*runs)


@pytest.mark.parametrize("opts", [
    {},                                                   # Algorithm 2
    {"adaptive_rho": True},
    {"adaptive_rho": True, "per_block": True},
], ids=["plain", "adaptive", "adaptive_per_block"])
def test_admm_link_masks_match_reference(inst, opts):
    """The live adjacency, degrees and link_frac of iteration t's graph."""
    masks = _masks("matrix", N_NODES, N_ITERS)
    runs = _runs(inst, lambda pkg, a: (
        je.ADMMConsensus(a["adj"], link_mask_fn=lambda t:
                         jnp.asarray(masks)[t], **opts)
        if pkg == "jax" else
        te.ADMMConsensus(a["adj"], link_mask_fn=lambda t: masks[t],
                         **opts)))
    _same_run(*runs)
    assert float(runs[1].consensus_diag.link_frac.min()) < 1.0


# ---------------------------------------------------------------------------
# The adaptive-penalty subsystem on the GMM instance
# ---------------------------------------------------------------------------
ADAPTIVE = {
    "adaptive_rho": dict(adaptive_rho=True),
    "per_block": dict(adaptive_rho=True, per_block=True),
    "per_block_only": dict(per_block=True, adaptive_rho=False,
                           dual_warmup=False, dual_reset=None),
    "warmup": dict(dual_warmup=True, warmup_window=3, warmup_tol=0.5,
                   dual_reset=None),
    "reset": dict(adaptive_rho=False, dual_warmup=False, dual_reset=0.5),
    "knobs": dict(adaptive_rho=True, dual_warmup=False, adapt_every=1,
                  mu=5.0, tau_incr=3.0, tau_decr=1.5, rho_min=0.1,
                  rho_max=5.0),
    "lam_max": dict(adaptive_rho=True, lam_max=0.5),
}
#: where lam_max clips, a dual sits at +-lam_max |phi*_i|, so it carries
#: phi*'s last-ulp rounding (the two packages' E-steps associate sums
#: differently) and the ADMM recursion amplifies it: 1.1e-9 after 30
#: iterations; those runs are held at 1e-8
RTOL_CLIPPED_DUALS = 1e-8


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_adaptive_admm_matches_reference(inst, name):
    opts = ADAPTIVE[name]
    runs = _runs(inst, lambda pkg, a: (je if pkg == "jax" else te)
                 .ADMMConsensus(a["adj"], rho=0.5, **opts))
    _same_run(*runs, rtol=RTOL_CLIPPED_DUALS if "lam_max" in opts
              else RTOL)
    d = runs[1].consensus_diag
    if opts.get("per_block"):
        assert d.rho.shape == (N_ITERS, 5)


def test_admm_wrapper_options_match_reference(inst):
    """run_dvb_admm passes the adaptive options through (the
    adaptive_rho=True configuration of fig8)."""
    j, t = inst
    kw = dict(n_iters=N_ITERS, K=K, D=D, rho=0.5, adaptive_rho=True,
              per_block=True)
    a = ja.run_dvb_admm(j["x"], j["mask"], j["adj"], j["prior"],
                        init_q=ja._perturbed_init(j["prior"], j["x"],
                                                  jax.random.PRNGKey(3)),
                        ref_phi=j["ref"], **kw)
    u = jax.random.uniform(jax.random.PRNGKey(3), (K, D), jnp.float64)
    b = ta.run_dvb_admm(t["x"], t["mask"], t["adj"], t["prior"],
                        init_q=ta.perturbed_init(t["prior"], t["x"],
                                                 np.asarray(u)),
                        ref_phi=t["ref"], device="cpu", **kw)
    _same_run(a, b)


# ---------------------------------------------------------------------------
# clip and reset through a forced projection (_ClampedLinReg)
# ---------------------------------------------------------------------------
class _JClamped(jm.LinRegModel):
    def project_to_domain(self, phi):
        return jnp.clip(phi, -1.0, 1.0)


class _TClamped(tm.LinRegModel):
    def project_to_domain(self, phi):
        return torch.clamp(phi, -1.0, 1.0)


@pytest.mark.parametrize("opts", [
    dict(adaptive_rho=False, dual_warmup=False, dual_reset=0.0),
    dict(adaptive_rho=False, dual_warmup=False, dual_reset=0.5),
    dict(adaptive_rho=True, adapt_every=2),
    dict(adaptive_rho=True, per_block=True, adapt_every=1,
         dual_warmup=False),
], ids=["reset0", "reset_half", "adaptive", "per_block"])
def test_clip_and_reset_match_reference(opts):
    """Every iteration clips (a projection onto [-1, 1]): reset_count
    equals clip_count, the kappa ramp restarts, and every field equals the
    reference's."""
    adj = np.asarray([[0.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]])
    jmdl = _JClamped(jlin.prior(2))
    tmdl = _TClamped(tlin.prior(2), device="cpu")
    base = np.asarray(jmdl.init_phi())
    phi_star = np.stack([base + 5.0, base - 5.0, base + 0.5])
    a = je.run_vb(jmdl, jnp.asarray(phi_star),
                  je.ADMMConsensus(jnp.asarray(adj), **opts), n_iters=15)
    b = te.run_vb(tmdl, torch.from_numpy(phi_star),
                  te.ADMMConsensus(torch.from_numpy(adj), **opts),
                  n_iters=15, device="cpu")
    _same_run(a, b)
    d = b.consensus_diag
    assert int(d.clip_count.min()) >= 2
    np.testing.assert_array_equal(d.reset_count, d.clip_count)


def test_residual_balanced_rho_matches_reference():
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.01, 50, 40)
    r, s = rng.lognormal(0, 3, 40), rng.lognormal(0, 3, 40)
    kw = dict(mu=3.0, tau_incr=2.5, tau_decr=1.5, rho_min=0.1, rho_max=20.0)
    got = te.residual_balanced_rho(torch.from_numpy(rho),
                                   torch.from_numpy(r), torch.from_numpy(s),
                                   **kw)
    want = je.residual_balanced_rho(jnp.asarray(rho), jnp.asarray(r),
                                    jnp.asarray(s), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the port's own link coins; the split-run contract
# ---------------------------------------------------------------------------
def test_link_coins():
    """Symmetric, one coin per undirected link, diagonal 1; a function of
    (link_seed, t); the drop rate is the probability's."""
    g = tn.link_generator
    k1 = tn.link_keep_matrix(g(7, 3, "cpu"), 200, 0.3, torch.float64)
    k2 = tn.link_keep_matrix(g(7, 3, "cpu"), 200, 0.3, torch.float64)
    k3 = tn.link_keep_matrix(g(7, 4, "cpu"), 200, 0.3, torch.float64)
    assert torch.equal(k1, k2) and not torch.equal(k1, k3)
    assert torch.equal(k1, k1.T) and bool((k1.diagonal() == 1).all())
    off = k1[~torch.eye(200, dtype=torch.bool)]
    assert abs(1.0 - float(off.mean()) - 0.3) < 0.02
    e = tn.ring_link_keep(g(7, 3, "cpu"), 1000, 0.3)
    assert e.shape == (1000,) and abs(1.0 - float(e.mean()) - 0.3) < 0.05
    assert torch.equal(tn.link_keep_matrix(g(1, 0, "cpu"), 5, 0.0),
                       torch.ones(5, 5))


@pytest.mark.parametrize("case", ["ring_drop", "diffusion_drop",
                                  "admm_adaptive_drop"])
def test_split_run_bit_equal(inst, case):
    """vb_run(s, a + b) == vb_run(vb_run(s, a), b), bit for bit, with
    link_drop and the adaptive carry."""
    _, t = inst
    mdl = tm.GMMModel(t["prior"], K, D, device="cpu")
    topo = {"ring_drop": lambda: te.RingDiffusion(link_drop=0.4,
                                                  link_seed=3),
            "diffusion_drop": lambda: te.Diffusion(t["W"], link_drop=0.3,
                                                   link_seed=1),
            "admm_adaptive_drop": lambda: te.ADMMConsensus(
                t["adj"], adaptive_rho=True, per_block=True, adapt_every=2,
                link_drop=0.3, link_seed=2)}[case]()
    sched = te.Schedule() if case == "admm_adaptive_drop" \
        else te.Schedule(tau=0.2)

    def start():
        return te.vb_init(mdl, (t["x"], t["mask"]), topo, schedule=sched,
                          init_phi=t["phi0"], ref_phi=t["ref"],
                          device="cpu")

    whole, run = te.vb_run(start(), 12)
    half, r1 = te.vb_run(start(), 5)
    split, r2 = te.vb_run(half, 7)
    assert torch.equal(whole.phi, split.phi)
    assert torch.equal(run.kl_mean, torch.cat([r1.kl_mean, r2.kl_mean]))
    if run.consensus_diag is not None:
        for f in te.ConsensusDiagnostics._fields:
            assert torch.equal(getattr(run.consensus_diag, f), torch.cat(
                [getattr(r1.consensus_diag, f),
                 getattr(r2.consensus_diag, f)])), f
        assert float(run.consensus_diag.link_frac.min()) < 1.0
        for a, b in zip(whole.carry, split.carry):
            assert torch.equal(a, b)


def test_link_options_validate():
    adj = torch.ones(3, 3) - torch.eye(3)
    with pytest.raises(ValueError, match="OR"):
        te.Diffusion(adj, link_drop=0.1, link_mask_fn=lambda t: adj)
    with pytest.raises(ValueError, match="probability"):
        te.ADMMConsensus(adj, link_drop=1.5)
    with pytest.raises(ValueError, match="iteration index"):
        te.RingDiffusion(link_drop=0.2).combine(torch.zeros(3, 2))
    # the wrappers pass link_drop through
    prior = tx.noninformative_prior(2, 2, beta0=0.1, w0_scale=10.0)
    x = torch.randn(3, 10, 2, dtype=torch.float64)
    mask = torch.ones(3, 10, dtype=torch.float64)
    run = ta.run_dvb_admm(x, mask, adj, prior, n_iters=4, K=2, D=2,
                          link_drop=0.9, link_seed=4, adaptive_rho=True,
                          device="cpu")
    assert run.consensus_diag.link_frac.shape == (4,)
    assert ta.run_dsvb(x, mask, adj / 3 + torch.eye(3) / 3, prior,
                       n_iters=2, K=2, D=2, link_drop=0.5,
                       device="cpu").phi.shape == (3, tx.flat_dim(2, 2))
