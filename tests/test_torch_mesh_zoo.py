"""The port's mesh executor on the HMM and PPCA instances, on 4 gloo
ranks, float64, on the CPU.

tests/test_model_zoo.py's executor instance: 8 nodes, the graph of seed
3 with Metropolis weights; the HMM on 8 chains of length 8 (K=3, D=2,
seed 0), PPCA on 16 points (D=5, Q=2, seed 1); the reference's random
restarts (`jax.random`) handed to the port as `init_phi`.  Diffusion,
the ring, ADMM and the fusion centre, 8 iterations; streaming SVRG over
diffusion (B = half the capacity, capacity + 2 iterations).

* Against the port's single-array run: phi, the KLs and the consensus
  error within 1e-8 (the reference's executor bar).
* Against the JAX package's single-array `engine.run_vb` (the four
  topologies): phi at 1e-10, the bar of tests/test_torch_model_zoo.py.
  The SVRG runs meet JAX in tests/test_torch_mesh_zoo_svrg.py (the
  reference compiles each for 9-16 s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core import network as jn
from repro.models import hmm as jh
from repro.models import ppca as jp
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import engine as te
from repro_torch.data import stream as tstream
from repro_torch.models import hmm as th
from repro_torch.models import ppca as tp
from test_torch_mesh_collectives import launch_ranks

N, N_ITERS = 8, 8
EXECUTOR_BAR = 1e-8
GOLDEN = 1e-10
MODELS = ["hmm", "ppca"]
TOPOLOGIES = ["diffusion", "ring", "admm", "fusion"]

BUILDERS = r'''
def zoo_topologies(engine, adj, W):
    return [("diffusion", engine.Diffusion(W), {}),
            ("ring", engine.RingDiffusion(), {}),
            ("admm", engine.ADMMConsensus(adj), {}),
            ("fusion", engine.FusionCenter(),
             dict(schedule=engine.ONE_SHOT))]
'''

MODELS_SRC = r'''
def zoo_models(I, hmm, ppca, ckpt):
    hprior = ckpt.hmm_posterior_from_numpy(
        *(I[f"hmm/prior/{i}"] for i in range(6)), device="cpu")
    pprior = ckpt.ng_posterior_from_numpy(
        *(I[f"ppca/prior/{i}"] for i in range(4)), device="cpu")
    return {"hmm": hmm.HMMModel(hprior, device="cpu"),
            "ppca": ppca.PPCAModel(pprior, device="cpu")}
'''

CODE = BUILDERS + MODELS_SRC + r'''
from repro_torch.checkpoint import ckpt
from repro_torch.core import engine
from repro_torch.data import stream
from repro_torch.models import hmm, ppca

I = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
models = zoo_models(INPUTS, hmm, ppca, ckpt)
for mname, mdl in models.items():
    data, phi0 = (I[f"{mname}/x"], I[f"{mname}/mask"]), I[f"{mname}/phi0"]
    for tname, topo, kw in zoo_topologies(engine, I["adj"], I["W"]):
        r = engine.run_vb(mdl, data, topo, n_iters=8, init_phi=phi0,
                          executor=EX, device="cpu", **kw)
        for f in ("phi", "kl_nodes", "consensus_err"):
            put(f"{mname}/{tname}/{f}", getattr(r, f))
    cap = data[0].shape[1]
    spec = stream.MinibatchSpec(cap // 2, seed=4, control_variate="svrg")
    r = engine.run_vb(mdl, data, engine.Diffusion(I["W"]), n_iters=cap + 2,
                      init_phi=phi0, minibatch=spec, executor=EX,
                      device="cpu")
    put(f"{mname}/svrg/phi", r.phi)
'''


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _ns(source):
    ns = {}
    exec(source, ns)
    return ns


def zoo_setup():
    """The JAX models, data and random restarts; the arrays the ranks
    get."""
    adj, _ = jn.random_geometric_graph(N, seed=3)
    W = jn.metropolis_weights(adj)
    x, mask, _, _, _ = jh.sample_chains(N, 8, 8, K=3, D=2, seed=0)
    hmm = jh.HMMModel(jh.noninformative_prior(3, 2, beta0=0.1,
                                              w0_scale=10.0))
    hq = jh.perturbed_init(hmm.prior, jnp.asarray(x), jax.random.PRNGKey(7))
    px, pmask, _ = jp.sample_sensors(N, 16, D=5, Q=2, seed=1)
    ppca = jp.PPCAModel(jp.prior(5, 2))
    pq = jp.perturbed_init(ppca.prior, jax.random.PRNGKey(5))
    setup = {
        "hmm": (hmm, (jnp.asarray(x), jnp.asarray(mask)),
                jnp.broadcast_to(hmm.pack(hq), (N, hmm.flat_dim))),
        "ppca": (ppca, (jnp.asarray(px), jnp.asarray(pmask)),
                 jnp.broadcast_to(ppca.pack(pq), (N, ppca.flat_dim)))}
    inputs = {"adj": adj, "W": W}
    for name, (mdl, (xs, ms), phi0) in setup.items():
        inputs.update({f"{name}/x": xs, f"{name}/mask": ms,
                       f"{name}/phi0": phi0})
        inputs.update({f"{name}/prior/{i}": a
                       for i, a in enumerate(mdl.prior)})
    return setup, {k: np.array(v) for k, v in inputs.items()}


@pytest.fixture(scope="module")
def jax_setup():
    return zoo_setup()


@pytest.fixture(scope="module")
def ranks(jax_setup, tmp_path_factory):
    """The ranks' run (started here; `result()` waits)."""
    return launch_ranks(CODE, 4, tmp_path_factory.mktemp("zoo4"),
                        inputs=jax_setup[1])


@pytest.fixture(scope="module")
def jax_runs(ranks, jax_setup):
    setup, inputs = jax_setup
    topos = _ns(BUILDERS)["zoo_topologies"](je, jnp.asarray(inputs["adj"]),
                                            jnp.asarray(inputs["W"]))
    return {(m, name): je.run_vb(mdl, data, topo, n_iters=N_ITERS,
                                 init_phi=phi0, **kw)
            for m, (mdl, data, phi0) in setup.items()
            for name, topo, kw in topos}


@pytest.fixture(scope="module")
def port_runs(ranks, jax_setup):
    inputs = jax_setup[1]
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    models = _ns(MODELS_SRC)["zoo_models"](inputs, th, tp, tckpt)
    out = {}
    for m, mdl in models.items():
        data, phi0 = (t[f"{m}/x"], t[f"{m}/mask"]), t[f"{m}/phi0"]
        for name, topo, kw in _ns(BUILDERS)["zoo_topologies"](
                te, t["adj"], t["W"]):
            out[m, name] = te.run_vb(mdl, data, topo, n_iters=N_ITERS,
                                     init_phi=phi0, device="cpu", **kw)
        cap = data[0].shape[1]
        out[m, "svrg"] = te.run_vb(
            mdl, data, te.Diffusion(t["W"]), n_iters=cap + 2,
            init_phi=phi0, device="cpu", minibatch=tstream.MinibatchSpec(
                cap // 2, seed=4, control_variate="svrg"))
    return out


@pytest.mark.parametrize("topology", TOPOLOGIES + ["svrg"])
@pytest.mark.parametrize("model", MODELS)
def test_matches_single_array_executor(ranks, port_runs, model, topology):
    out = ranks.result()
    a = port_runs[model, topology]
    fields = ("phi",) if topology == "svrg" \
        else ("phi", "kl_nodes", "consensus_err")
    for f in fields:
        np.testing.assert_allclose(out[f"{model}/{topology}/{f}"],
                                   getattr(a, f).numpy(), rtol=0,
                                   atol=EXECUTOR_BAR, err_msg=f)


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("model", MODELS)
def test_matches_jax_single_array(ranks, jax_runs, model, topology):
    got = ranks.result()[f"{model}/{topology}/phi"]
    want = np.asarray(jax_runs[model, topology].phi)
    np.testing.assert_allclose(got, want, rtol=GOLDEN, atol=GOLDEN)
