"""The port's Normal-Gamma instance (core/linreg.py, blocks.NormalGammaBlock,
model.LinRegModel) against the JAX package's, f64 on shared numpy inputs.

Tolerances: the closed forms (pack/unpack, local optimum, pooled posterior,
KL, block quantities) rtol 1e-10; the consensus runs' iterates rtol 1e-9
(hundreds of f64 iterations of the same recursion); the linreg_generality
row of BENCH_engine.json: dSVB's max KL to the pooled posterior equal to
three digits (9.73e-01); ADMM's at the f64 noise floor (the row's 1.02e-12
and today's JAX run's 6.25e-13 are rounding, not a value), held below
1e-11.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linreg as jlin
from repro.core import model as jmodel
from repro.core import network as jnet
from repro_torch.core import blocks, engine, linreg, network
from repro_torch.core import model as model_lib


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


D, N_NODES, NI = 4, 12, 30
W_TRUE = np.array([1.5, -2.0, 0.5, 3.0])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N_NODES, NI, D))
    y = X @ W_TRUE + rng.normal(size=(N_NODES, NI)) * 0.5
    return X, y


@pytest.fixture(scope="module")
def setup(data):
    X, y = data
    q0 = linreg.prior(D)
    mask = torch.ones(N_NODES, NI, dtype=torch.float64)
    phi_star = linreg.local_optimum(torch.from_numpy(X), torch.from_numpy(y),
                                    mask, q0, float(N_NODES))
    ref = linreg.pooled_posterior(torch.from_numpy(X.reshape(-1, D)),
                                  torch.from_numpy(y.reshape(-1)), q0)
    adj, _ = network.random_geometric_graph(N_NODES, seed=1)
    return q0, phi_star, ref, adj


def _close(a, b, rtol=1e-10, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_closed_forms_match_reference(data, setup):
    X, y = data
    q0, phi_star, ref, _ = setup
    jq0 = jlin.prior(D)
    jmask = jnp.ones((NI,))
    want = np.stack([np.asarray(jlin.local_optimum(
        jnp.asarray(X[i]), jnp.asarray(y[i]), jmask, jq0, float(N_NODES)))
        for i in range(N_NODES)])
    _close(phi_star, want)
    jref = jlin.pooled_posterior(jnp.asarray(X.reshape(-1, D)),
                                 jnp.asarray(y.reshape(-1)), jq0)
    for a, b in zip(ref, jref):
        _close(a, b)
    q = linreg.unpack(phi_star, D)
    for i in (0, 7):
        jq = jlin.unpack(jnp.asarray(want[i]), D)
        for a, b in zip(q, jq):
            _close(a[i], b)
        _close(linreg.log_partition(q)[i], jlin.log_partition(jq))
        for a, b in zip(linreg.expected_stats(q), jlin.expected_stats(jq)):
            _close(a[i], b)
        _close(linreg.kl(linreg.NGPosterior(*(t[i] for t in q)), ref),
               jlin.kl(jq, jref))
    assert linreg.block_labels(3).tolist() == jlin.block_labels(3).tolist()
    for a, b in zip(linreg.unpack(linreg.pack(ref), D), ref):
        _close(a, b, rtol=1e-9)


def test_grad_log_partition_is_expected_stats(setup):
    """Eq. 10a for the Normal-Gamma family, by autograd — pins the layout."""
    _, _, ref, _ = setup
    phi = linreg.pack(ref).clone().requires_grad_(True)
    linreg.log_partition(linreg.unpack(phi, D)).backward()
    e1, e2, e3, e4 = linreg.expected_stats(ref)
    want = torch.cat([e1[None], e2[None], e3, e4.reshape(-1)])
    _close(phi.grad, want, rtol=1e-6, atol=1e-9)


def test_block_and_model_match_reference(setup):
    q0, phi_star, ref, _ = setup
    blk, jblk = blocks.NormalGammaBlock(D), jmodel.blocks.NormalGammaBlock(D)
    x, xr = phi_star[3], linreg.pack(ref)
    jx, jxr = jnp.asarray(x.numpy()), jnp.asarray(xr.numpy())
    assert blk.dim == jblk.dim and blk.labels().tolist() == \
        jblk.labels().tolist()
    _close(blk.kl(x, xr), jblk.kl(jx, jxr))
    _close(blk.expected_stats(blk.unpack(x)),
           jblk.expected_stats(jblk.unpack(jx)))
    _close(blk.log_partition(blk.unpack(x)),
           jblk.log_partition(jblk.unpack(jx)))
    mdl = model_lib.LinRegModel(q0, device="cpu")
    jmdl = jmodel.LinRegModel(jlin.prior(D))
    _close(mdl.init_phi(), jmdl.init_phi())
    _close(mdl.kl(phi_star, xr), np.asarray([jmdl.kl(jnp.asarray(p), jxr)
                                             for p in phi_star.numpy()]))
    assert mdl.block_labels().tolist() == jmdl.block_labels().tolist()
    assert torch.equal(mdl.project_to_domain(phi_star), phi_star)
    assert model_lib.LinRegModel.from_flat_dim(linreg.flat_dim(5),
                                               device="cpu").D == 5
    with pytest.raises(ValueError, match="no 'fused' compute backend"):
        mdl.with_backend("fused")
    assert mdl.with_backend("reference") is mdl
    # raw (X, y, mask) data give the precomputed phi* stack
    X = torch.randn(3, 7, D, dtype=torch.float64)
    y = torch.randn(3, 7, dtype=torch.float64)
    m = torch.ones(3, 7, dtype=torch.float64)
    got = mdl.local_optimum((X, y, m), None, 3.0)
    _close(got, linreg.local_optimum(X, y, m, q0, 3.0))
    assert mdl.data_mask((X, y, m)) is m
    with pytest.raises(ValueError, match="phi"):
        mdl.data_mask(phi_star)


def test_cvb_average_is_exact_pooled_posterior(setup):
    _, phi_star, ref, _ = setup
    q = linreg.unpack(linreg.run_cvb(phi_star), D)
    _close(q.m, ref.m, rtol=1e-8)
    _close(q.a, ref.a, rtol=1e-8)
    _close(q.b, ref.b, rtol=1e-6)


@pytest.mark.parametrize("estimator", ["dsvb", "admm"])
def test_consensus_runs_match_reference(setup, estimator):
    _, phi_star, ref, adj = setup
    jphi = jnp.asarray(phi_star.numpy())
    jadj = jnp.asarray(adj.numpy())
    if estimator == "dsvb":
        W = network.nearest_neighbor_weights(adj)
        got = linreg.run_dsvb(phi_star, W, n_iters=200, tau=0.1,
                              device="cpu")
        want = jlin.run_dsvb(jphi, jnet.nearest_neighbor_weights(jadj),
                             n_iters=200, tau=0.1)
    else:
        got = linreg.run_admm(phi_star, adj, n_iters=200, rho=0.5,
                              device="cpu")
        want = jlin.run_admm(jphi, jadj, n_iters=200, rho=0.5)
    _close(got, want, rtol=1e-9, atol=1e-12)
    kls = linreg.kl(linreg.unpack(got, D),
                    linreg.NGPosterior(*(t.expand(N_NODES, *t.shape)
                                         for t in ref)))
    assert float(kls.max()) < (0.05 if estimator == "admm" else 0.5)


def test_linreg_generality_row():
    """benchmarks/linreg_bench.py at its default size through the port:
    dSVB 9.73e-01 as the committed row; ADMM at the noise floor."""
    Dg, n_nodes, ni = 6, 20, 40
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=Dg)
    X = rng.normal(size=(n_nodes, ni, Dg))
    y = X @ w_true + rng.normal(size=(n_nodes, ni)) * 0.4
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    q0 = linreg.prior(Dg)
    phi_star = linreg.local_optimum(
        X, y, torch.ones(n_nodes, ni, dtype=torch.float64), q0,
        float(n_nodes))
    ref = linreg.pooled_posterior(X.reshape(-1, Dg), y.reshape(-1), q0)
    refs = linreg.NGPosterior(*(t.expand(n_nodes, *t.shape) for t in ref))
    adj, _ = network.random_geometric_graph(n_nodes, seed=1)
    W = network.nearest_neighbor_weights(adj)
    phi_d = linreg.run_dsvb(phi_star, W, n_iters=400, tau=0.1, device="cpu")
    phi_a = linreg.run_admm(phi_star, adj, n_iters=400, rho=0.5,
                            device="cpu")
    kl_d = float(linreg.kl(linreg.unpack(phi_d, Dg), refs).max())
    kl_a = float(linreg.kl(linreg.unpack(phi_a, Dg), refs).max())
    assert f"{kl_d:.2e}" == "9.73e-01"
    assert kl_a < 1e-11


def test_engine_takes_the_phi_stack(setup):
    """run_vb on the (N, P) phi* stack: diagnostics off returns no
    consensus record; on, the ADMM record has one row per iteration."""
    _, phi_star, _, adj = setup
    mdl = model_lib.LinRegModel(D=D, device="cpu")
    run = engine.run_vb(mdl, phi_star, engine.ADMMConsensus(adj,
                                                            project=False),
                        n_iters=5, init_phi=phi_star, device="cpu")
    assert run.consensus_diag.rho.shape == (5,)
    assert run.phi.shape == phi_star.shape
