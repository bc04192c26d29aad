"""The port's engine and five estimators against repro.core.algorithms.

The tests/test_engine.py instance (8 nodes x 20 points, the same
`init_q` handed to both packages): on the reference backend in float64
the port must match at rtol 1e-9 on final phi, kl_mean, consensus_err and
ADMM's ConsensusDiagnostics; the fused backend (plain kernel on the CPU
vs the Pallas kernel in interpret mode) in float32 at rtol 1e-4, the bar
of tests/test_backends.py.  Also: the absolute-t split-run contract, and
a JAX checkpoint resumed in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import algorithms as ja
from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import gmm as jg
from repro.core import model as jm
from repro.core import network as jn
from repro.core import refperm as jr
from repro.data import synthetic as js
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import algorithms as ta
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm

K, D, N_NODES, N_ITERS = 3, 2, 8, 15
ESTIMATORS = ["cvb", "noncoop", "nsg_dvb", "dsvb", "dvb_admm"]


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _instance(dtype):
    """(jax args, torch args) of the tests/test_engine.py instance."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    data = js.paper_synthetic(n_nodes=N_NODES, n_per_node=20, seed=2,
                              dtype=npd)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                    dtype=jd)
    adj, _ = jn.random_geometric_graph(N_NODES, seed=4)
    adj = adj.astype(jd)
    W = jn.nearest_neighbor_weights(adj).astype(jd)
    init_q = ja._perturbed_init(prior, data.x, jax.random.PRNGKey(3))
    x_all, labels = data.flat
    ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels, prior,
                                                     K))
    j = dict(x=data.x, mask=data.mask, prior=prior, adj=adj, W=W,
             init_q=init_q, ref=ref)
    t = dict(x=_t(data.x), mask=_t(data.mask),
             prior=tx.GMMPosterior(*(_t(a) for a in prior)), adj=_t(adj),
             W=_t(W), init_q=tx.GMMPosterior(*(_t(a) for a in init_q)),
             ref=_t(ref))
    return j, t


def _run(pkg, a, est, **kw):
    mod = ja if pkg == "jax" else ta
    graph = {"nsg_dvb": (a["W"],), "dsvb": (a["W"],),
             "dvb_admm": (a["adj"],)}.get(est, ())
    if pkg == "torch":
        kw["device"] = "cpu"
    return mod.ALGORITHMS[est](a["x"], a["mask"], *graph, a["prior"],
                               n_iters=N_ITERS, K=K, D=D,
                               init_q=a["init_q"], ref_phi=a["ref"], **kw)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def f64():
    return _instance(torch.float64)


@pytest.mark.parametrize("est", ESTIMATORS)
def test_reference_backend_f64(f64, est):
    j, t = f64
    a, b = _run("jax", j, est), _run("torch", t, est)
    assert b.phi.dtype == torch.float64
    _close(b.phi, a.phi, 1e-9)
    _close(b.kl_mean, a.kl_mean, 1e-9)
    _close(b.kl_nodes, a.kl_nodes, 1e-9)
    # cVB's consensus error is exactly 0 up to the rounding of a mean of
    # identical rows: compared against the scale of phi^2
    _close(b.consensus_err, a.consensus_err, 1e-9,
           atol=1e-24 * float(np.max(np.asarray(a.phi) ** 2)))
    if est == "dvb_admm":
        for f in je.ConsensusDiagnostics._fields:
            _close(getattr(b.consensus_diag, f),
                   getattr(a.consensus_diag, f), 1e-9)


@pytest.mark.parametrize("est", ESTIMATORS)
def test_fused_backend_f32(est):
    j, t = _instance(torch.float32)
    a = _run("jax", j, est, backend="fused")
    b = _run("torch", t, est, backend="fused")
    assert b.phi.dtype == torch.float32
    _close(b.kl_mean, a.kl_mean, 1e-4, atol=1e-4)
    _close(b.kl_nodes, a.kl_nodes, 1e-4, atol=1e-4)
    _close(b.phi, a.phi, 1e-4, atol=1e-4)


def _session(t, **kw):
    mdl = tm.GMMModel(t["prior"], K, D, device="cpu")
    phi0 = tx.pack_natural(t["init_q"]).expand(N_NODES, mdl.flat_dim)
    return te.vb_init(mdl, (t["x"], t["mask"]), te.ADMMConsensus(t["adj"]),
                      init_phi=phi0, ref_phi=t["ref"], device="cpu", **kw)


def test_split_run_bit_equal(f64):
    """vb_run(s, 7 + 8) == vb_run(vb_run(s, 7), 8), bit for bit."""
    _, t = f64
    for make in (lambda: _session(t),
                 lambda: te.vb_init(
                     tm.GMMModel(t["prior"], K, D, device="cpu"),
                     (t["x"], t["mask"]), te.Diffusion(t["W"]),
                     ref_phi=t["ref"], device="cpu")):
        whole, run = te.vb_run(make(), 15)
        half, run_a = te.vb_run(make(), 7)
        half, run_b = te.vb_run(half, 8)
        assert whole.t == half.t == 15
        assert torch.equal(whole.phi, half.phi)
        assert (whole.carry is None) == (half.carry is None)
        if whole.carry is not None:
            assert torch.equal(whole.carry, half.carry)
            for f in whole.diag._fields:
                assert torch.equal(getattr(whole.diag, f),
                                   getattr(half.diag, f))
        assert torch.equal(run.kl_nodes,
                           torch.cat([run_a.kl_nodes, run_b.kl_nodes]))
    assert torch.equal(te.vb_step(make()).phi, te.vb_run(make(), 1)[0].phi)


def test_resume_reference_checkpoint(f64, tmp_path):
    """A JAX `ckpt.save` of a plain-ADMM VBState at t=7, loaded in the
    port and run 8 more iterations, equals the reference's uninterrupted
    15-iteration run."""
    j, t = f64
    mdl = jm.GMMModel(j["prior"], K, D)
    phi0 = jnp.broadcast_to(jx.pack_natural(j["init_q"]),
                            (N_NODES, mdl.flat_dim))

    def jsession():
        return je.vb_init(mdl, (j["x"], j["mask"]),
                          je.ADMMConsensus(j["adj"]), init_phi=phi0,
                          ref_phi=j["ref"])

    s7, _ = je.vb_run(jsession(), 7)
    path = jckpt.save(str(tmp_path / "admm_t7.npz"), s7)
    s15, whole = je.vb_run(jsession(), 15)

    resumed = tckpt.load_reference_checkpoint(path, _session(t))
    assert resumed.t == 7
    end, run = te.vb_run(resumed, 8)
    assert end.t == 15
    _close(end.phi, s15.phi, 1e-9)
    _close(end.carry, s15.carry, 1e-9)
    for f in te.ConsensusDiagnostics._fields:
        _close(getattr(end.diag, f), getattr(s15.diag, f), 1e-9)
    _close(run.kl_nodes, whole.kl_nodes[7:], 1e-9)

    arrays = tckpt.read_npz(path)
    arrays[".phi"] = arrays[".phi"][:, :5]
    with pytest.raises(ValueError, match="shape"):
        tckpt.state_from_arrays(arrays, _session(t))
    del arrays[".carry"]
    with pytest.raises(KeyError, match="carry"):
        tckpt.state_from_arrays(arrays, _session(t))
    prior = tckpt.posterior_from_numpy(*map(np.asarray, j["prior"]),
                                       device="cpu")
    for got, want in zip(prior, t["prior"]):
        assert torch.equal(got, want)


def test_schedule_helpers():
    for tt in (0.0, 3.0, 40.0):
        assert te.eta_schedule(tt, 0.2, 1.0) == pytest.approx(
            float(je.eta_schedule(jnp.asarray(tt), 0.2, 1.0)), rel=1e-15)
        assert te.kappa_schedule(tt, 0.05) == pytest.approx(
            float(je.kappa_schedule(jnp.asarray(tt), 0.05)), rel=1e-15)
    assert te.Schedule().eta(4) == pytest.approx(
        float(je.Schedule().eta(jnp.asarray(4.0))), rel=1e-15)
    assert te.ONE_SHOT.eta(9) == 1.0
