"""The port's HMM and PPCA instances (repro_torch.models.hmm/ppca) against
repro.models.hmm/ppca, at tests/test_model_zoo.py's sizes (6 nodes; HMM
10 chains of length 8, K=3, D=2; PPCA 24 points, D=5, Q=2), float64.

* The numpy-seeded samplers give arrays equal to the reference's.
* `_emission_loglik`, `forward_backward`, `latent_posterior` and
  `local_optimum` match the reference on shared inputs at 1e-10.
* Diffusion and ADMM runs through the port's engine match the paper
  loops of tests/test_model_zoo.py written longhand (Eqs. 27a/27b and
  38a/38b/39/40) over the reference's `local_optimum` at the 1e-10
  golden bar, and the same loops over the port's model.  The random
  restarts (`perturbed_init`) draw from `jax.random`: their draws are
  injected.
* Streaming: full-batch specs are bit-identical, SVRG streaming is finite
  and its split run is exact; ground truth is recovered.
* F5: `backend="fused"` on either model warns once ("falling back to the
  reference backend") and equals the reference-backend run bit for bit.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jn
from repro.models import hmm as jh
from repro.models import ppca as jp
from repro_torch import telemetry
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.data import stream as tstream
from repro_torch.models import hmm as th
from repro_torch.models import ppca as tp

K, D_HMM, N_NODES = 3, 2, 6
D_PPCA, Q = 5, 2
GOLDEN = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph():
    adj, _ = jn.random_geometric_graph(N_NODES, seed=3)
    return adj, jn.metropolis_weights(adj)


@pytest.fixture(scope="module")
def hmm_setup():
    x, mask, _, _, _ = jh.sample_chains(N_NODES, 10, 8, K=K, D=D_HMM, seed=0)
    prior = jh.noninformative_prior(K, D_HMM, beta0=0.1, w0_scale=10.0)
    init_q = jh.perturbed_init(prior, jnp.asarray(x), jax.random.PRNGKey(7))
    mdl = jh.HMMModel(prior)
    adj, W = _graph()
    phi0 = jnp.broadcast_to(mdl.pack(init_q), (N_NODES, mdl.flat_dim))
    u = jax.random.uniform(jax.random.PRNGKey(7), (K, D_HMM), jnp.float64)
    tx_, tmask = th.sample_chains(N_NODES, 10, 8, K=K, D=D_HMM, seed=0)[:2]
    tprior = tckpt.hmm_posterior_from_numpy(*map(np.asarray, prior),
                                            device="cpu")
    tmdl = th.HMMModel(tprior, device="cpu")
    tphi0 = tmdl.pack(th.perturbed_init(tprior, tx_, np.asarray(u))
                      ).expand(N_NODES, -1).clone()
    return dict(j=(mdl, (jnp.asarray(x), jnp.asarray(mask)), phi0),
                t=(tmdl, (tx_, tmask), tphi0), adj=adj, W=W)


@pytest.fixture(scope="module")
def ppca_setup():
    x, mask, _ = jp.sample_sensors(N_NODES, 24, D=D_PPCA, Q=Q, seed=1)
    mdl = jp.PPCAModel(jp.prior(D_PPCA, Q))
    init_q = jp.perturbed_init(mdl.prior, jax.random.PRNGKey(5))
    phi0 = jnp.broadcast_to(mdl.pack(init_q), (N_NODES, mdl.flat_dim))
    noise = jax.random.normal(jax.random.PRNGKey(5), (D_PPCA, Q),
                              jnp.float64)
    tx_, tmask = tp.sample_sensors(N_NODES, 24, D=D_PPCA, Q=Q, seed=1)[:2]
    tprior = tckpt.ng_posterior_from_numpy(*map(np.asarray, mdl.prior),
                                           device="cpu")
    for a, b in zip(tprior, tp.prior(D_PPCA, Q)):
        assert torch.equal(a, b)
    tmdl = tp.PPCAModel(tprior, device="cpu")
    tphi0 = tmdl.pack(tp.perturbed_init(tmdl.prior, np.asarray(noise))
                      ).expand(N_NODES, -1).clone()
    adj, W = _graph()
    return dict(j=(mdl, (jnp.asarray(x), jnp.asarray(mask)), phi0),
                t=(tmdl, (tx_, tmask), tphi0), adj=adj, W=W)


@pytest.fixture
def setups(hmm_setup, ppca_setup):
    return {"hmm": hmm_setup, "ppca": ppca_setup}


def _close(got, want, tol=GOLDEN):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# samplers and the per-node functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["hmm", "ppca"])
def test_samplers_equal_reference(which):
    if which == "hmm":
        got = th.sample_chains(4, 3, 5, K=4, D=3, seed=11, self_loop=0.7)
        want = jh.sample_chains(4, 3, 5, K=4, D=3, seed=11, self_loop=0.7)
    else:
        got = tp.sample_sensors(4, 17, D=6, Q=3, seed=11, noise=0.2)
        want = jp.sample_sensors(4, 17, D=6, Q=3, seed=11, noise=0.2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_forward_backward_and_emissions_match_reference(hmm_setup):
    rng = np.random.default_rng(3)
    L, Kc = 9, 4
    log_emit = rng.normal(size=(3, 2, L, Kc)) * 3
    log_pi = np.log(rng.dirichlet(np.ones(Kc), size=(3, 2)))
    log_A = np.log(rng.dirichlet(np.ones(Kc), size=(3, 2, Kc))) - 0.1
    gamma, xi = th.forward_backward(_t(log_emit), _t(log_pi), _t(log_A))
    assert gamma.shape == (3, 2, L, Kc) and xi.shape == (3, 2, L - 1, Kc, Kc)
    for i in range(3):
        for s in range(2):
            g, x = jh.forward_backward(jnp.asarray(log_emit[i, s]),
                                       jnp.asarray(log_pi[i, s]),
                                       jnp.asarray(log_A[i, s]))
            _close(gamma[i, s], g)
            _close(xi[i, s], x)
    # the emission terms of the setup's posterior, chain by chain
    mdl, (x, _), phi0 = hmm_setup["j"]
    tmdl, (tx_, _), tphi0 = hmm_setup["t"]
    q, tq = mdl.unpack(phi0[0]), tmdl.unpack(tphi0[0])
    nw = tx.NWParams(m=tq.m, beta=tq.beta, W=tq.W, nu=tq.nu)
    got = th._emission_loglik(tx_[0], nw)                     # (S, L, K)
    for s in range(tx_.shape[1]):
        _close(got[s], jh._emission_loglik(
            x[0, s], jh.NWParams(m=q.m, beta=q.beta, W=q.W, nu=q.nu)))


def test_latent_posterior_matches_reference(ppca_setup):
    mdl, (x, _), phi0 = ppca_setup["j"]
    tmdl, (tx_, _), tphi0 = ppca_setup["t"]
    sigma, mu = tp.latent_posterior(tx_, tmdl.unpack(tphi0))
    for i in range(N_NODES):
        s, m = jp.latent_posterior(x[i], mdl.unpack(phi0[i]))
        _close(sigma[i], s)
        _close(mu[i], m)


@pytest.mark.parametrize("which", ["hmm", "ppca"])
def test_local_optimum_matches_reference(which, setups):
    s = setups[which]
    mdl, data, phi0 = s["j"]
    tmdl, tdata, tphi0 = s["t"]
    _close(tphi0, phi0)                       # the injected restarts
    # a scaled ragged mask, as a streaming minibatch hands it over
    w = np.ones(data[1].shape)
    w[:, -3:] = 0.0
    w[1, :] *= 2.5
    want = mdl.local_optimum((data[0], jnp.asarray(w)), phi0, 6.0)
    got = tmdl.local_optimum((tdata[0], _t(w)), tphi0, 6.0)
    _close(got, want)
    assert tmdl.flat_dim == mdl.flat_dim
    np.testing.assert_array_equal(tmdl.block_labels(), mdl.block_labels())


# ---------------------------------------------------------------------------
# the paper loops longhand (tests/test_model_zoo.py) against the engine
# ---------------------------------------------------------------------------
def _legacy_dsvb(local_opt, W, phi0, *, n_iters, tau=0.2, d0=1.0):
    phi = phi0
    for t in range(n_iters):
        phi_star = local_opt(phi)
        eta = 1.0 / (d0 + tau * (t + 1.0))                       # Eq. 29
        varphi = phi + eta * (phi_star - phi)                    # Eq. 27a
        phi = W @ varphi                                         # Eq. 27b
    return phi


def _legacy_admm(local_opt, project, adj, phi0, *, n_iters, rho=0.5,
                 xi=0.05):
    deg = adj.sum(1)
    phi, lam = phi0, phi0 * 0.0
    for t in range(n_iters):
        phi_star = local_opt(phi)
        phi_hat = (phi_star - 2.0 * lam
                   + rho * (deg[:, None] * phi + adj @ phi))     # Eq. 38a
        phi_hat = phi_hat / (1.0 + 2.0 * rho * deg)[:, None]
        phi_new = project(phi_hat)                               # Eq. 38b
        kappa = 1.0 - 1.0 / (1.0 + xi * (t + 1.0)) ** 2          # Eq. 40
        resid = deg[:, None] * phi_new - adj @ phi_new
        lam = lam + kappa * rho / 2.0 * resid                    # Eq. 39
        phi = phi_new
    return phi


@pytest.mark.parametrize("topology", ["diffusion", "admm"])
@pytest.mark.parametrize("which", ["hmm", "ppca"])
def test_engine_matches_legacy_loop(which, topology, setups):
    s = setups[which]
    mdl, data, phi0 = s["j"]
    tmdl, tdata, tphi0 = s["t"]
    rep = float(N_NODES)
    jlo = jax.jit(lambda p: mdl.local_optimum(data, p, rep))
    tlo = lambda p: tmdl.local_optimum(tdata, p, rep)            # noqa: E731
    if topology == "diffusion":
        want = _legacy_dsvb(jlo, s["W"], phi0, n_iters=8)
        mine = _legacy_dsvb(tlo, _t(s["W"]), tphi0, n_iters=8)
        topo = te.Diffusion(_t(s["W"]))
    else:
        want = _legacy_admm(jlo, jax.vmap(mdl.project_to_domain), s["adj"],
                            phi0, n_iters=8)
        mine = _legacy_admm(tlo, tmdl.project_to_domain, _t(s["adj"]),
                            tphi0, n_iters=8)
        topo = te.ADMMConsensus(_t(s["adj"]))
    got = te.run_vb(tmdl, tdata, topo, n_iters=8, init_phi=tphi0,
                    device="cpu").phi
    _close(got, want)
    _close(mine, want)


def test_hmm_recovers_transitions():
    """Diffusion VB on sticky ground-truth chains recovers the transition
    matrix (tests/test_model_zoo.py's check, the port's run)."""
    x, mask, _, A_true, means = th.sample_chains(N_NODES, 20, 20, K=K,
                                                 D=D_HMM, seed=0)
    mdl = th.HMMModel(th.noninformative_prior(K, D_HMM, beta0=0.1,
                                              w0_scale=10.0), device="cpu")
    u = jax.random.uniform(jax.random.PRNGKey(7), (K, D_HMM), jnp.float64)
    phi0 = mdl.pack(th.perturbed_init(mdl.prior, x, np.asarray(u)))
    _, W = _graph()
    out = te.run_vb(mdl, (x, mask), te.Diffusion(_t(W)), n_iters=80,
                    init_phi=phi0.expand(N_NODES, -1), device="cpu")
    q = mdl.unpack(out.phi[0])
    perm = [int(torch.argmin(((q.m - mu) ** 2).sum(-1))) for mu in means]
    assert sorted(perm) == list(range(K)), "label collapse"
    A_est = (q.trans / q.trans.sum(-1, keepdim=True)).numpy()
    assert np.max(np.abs(A_est[np.ix_(perm, perm)] - A_true.numpy())) < 0.1


def test_ppca_recovers_subspace(ppca_setup):
    tmdl, tdata, tphi0 = ppca_setup["t"]
    W_true = tp.sample_sensors(N_NODES, 24, D=D_PPCA, Q=Q, seed=1)[2]
    out = te.run_vb(tmdl, tdata, te.Diffusion(_t(ppca_setup["W"])),
                    n_iters=30, init_phi=tphi0, device="cpu")
    m = tmdl.unpack(out.phi[0]).m.numpy()
    u_est = np.linalg.svd(m, full_matrices=False)[0]
    u_true = np.linalg.svd(W_true.numpy(), full_matrices=False)[0]
    assert np.min(np.linalg.svd(u_est.T @ u_true, compute_uv=False)) > 0.99


# ---------------------------------------------------------------------------
# streaming + SVRG
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cv", [None, "svrg"])
@pytest.mark.parametrize("which", ["hmm", "ppca"])
def test_full_batch_spec_is_bit_identical(which, cv, setups):
    tmdl, tdata, tphi0 = setups[which]["t"]
    topo = te.Diffusion(_t(setups[which]["W"]))
    cap = tdata[0].shape[1]
    a = te.run_vb(tmdl, tdata, topo, n_iters=6, init_phi=tphi0,
                  device="cpu")
    b = te.run_vb(tmdl, tdata, topo, n_iters=6, init_phi=tphi0,
                  device="cpu", minibatch=tstream.MinibatchSpec(cap, 0, cv))
    assert torch.equal(a.phi, b.phi)


@pytest.mark.parametrize("which", ["hmm", "ppca"])
def test_svrg_streaming_finite_and_split_exact(which, setups):
    """SVRG at half the capacity over two epochs and more: finite, and a
    run split across the first anchor refresh equals the whole run."""
    tmdl, tdata, tphi0 = setups[which]["t"]
    topo = te.Diffusion(_t(setups[which]["W"]))
    cap = tdata[0].shape[1]
    spec = tstream.MinibatchSpec(cap // 2, seed=3, control_variate="svrg")

    def start():
        return te.vb_init(tmdl, tdata, topo, init_phi=tphi0, device="cpu",
                          minibatch=spec)

    n = 5
    whole, run = te.vb_run(start(), n)
    split, _ = te.vb_run(start(), 1)
    split, _ = te.vb_run(split, n - 1)
    assert bool(torch.isfinite(whole.phi).all())
    assert bool(torch.isfinite(run.kl_nodes).all())
    assert whole.stream.epoch == 2
    assert torch.equal(whole.phi, split.phi)
    assert torch.equal(whole.stream.anchor_phi, split.stream.anchor_phi)
    assert torch.equal(whole.stream.anchor_full, split.stream.anchor_full)
    # the streamed run is a different trajectory from the full batch
    full = te.run_vb(tmdl, tdata, topo, n_iters=n, init_phi=tphi0,
                     device="cpu")
    assert not torch.equal(full.phi, whole.phi)


# ---------------------------------------------------------------------------
# F5: the fused backend falls back for models its kernel cannot run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["hmm", "ppca"])
def test_fused_backend_falls_back_with_one_warning(which, setups):
    tmdl, tdata, tphi0 = setups[which]["t"]
    topo = te.Diffusion(_t(setups[which]["W"]))
    plain = te.run_vb(tmdl, tdata, topo, n_iters=4, init_phi=tphi0,
                      device="cpu")
    telemetry.reset()          # the warn-once keys
    with pytest.warns(UserWarning, match="falling back to the reference"):
        fb = te.run_vb(tmdl, tdata, topo, n_iters=4, init_phi=tphi0,
                       backend="fused", device="cpu")
    assert torch.equal(plain.phi, fb.phi)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # once per (backend, model)
        again = te.run_vb(tmdl, tdata, topo, n_iters=4, init_phi=tphi0,
                          backend="fused", device="cpu")
    assert torch.equal(plain.phi, again.phi)
