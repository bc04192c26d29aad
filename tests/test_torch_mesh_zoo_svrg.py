"""The port's mesh executor on the HMM and PPCA streams with SVRG
against the JAX package, on 4 gloo ranks, float64, on the CPU.

tests/test_torch_mesh_zoo.py's instance (8 nodes, the graph of seed 3
with Metropolis weights; the HMM on 8 chains of length 8, PPCA on 16
points; the reference's random restarts as `init_phi`) streamed over
diffusion: B = half the capacity, seed 4, `control_variate="svrg"`,
capacity + 2 iterations.  The reference's epoch permutations are handed
to the port (`MinibatchSpec.perm_fn`), the whole (N, capacity) draw, of
which each rank takes its rows.

* Against the port's single-array run: phi and the KLs within 1e-8 (the
  reference's executor bar).
* Against the JAX package's single-array `engine.run_vb`: phi at 1e-10,
  the bar of tests/test_torch_model_zoo.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.data import stream as jstream
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import engine as te
from repro_torch.data import stream as tstream
from repro_torch.models import hmm as th
from repro_torch.models import ppca as tp
from test_torch_mesh_collectives import launch_ranks
from test_torch_mesh_zoo import (EXECUTOR_BAR, GOLDEN, MODELS, MODELS_SRC,
                                 N, _ns, zoo_setup)

SEED = 4

CODE = MODELS_SRC + r'''
from repro_torch.checkpoint import ckpt
from repro_torch.core import engine
from repro_torch.data import stream
from repro_torch.models import hmm, ppca

I = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
for mname, mdl in zoo_models(INPUTS, hmm, ppca, ckpt).items():
    data, phi0 = (I[f"{mname}/x"], I[f"{mname}/mask"]), I[f"{mname}/phi0"]
    cap, perms = data[0].shape[1], I[f"{mname}/perms"]
    spec = stream.MinibatchSpec(cap // 2, seed=4, control_variate="svrg",
                                perm_fn=lambda e, p=perms: p[e])
    r = engine.run_vb(mdl, data, engine.Diffusion(I["W"]), n_iters=cap + 2,
                      init_phi=phi0, minibatch=spec, executor=EX,
                      device="cpu")
    put(f"{mname}/phi", r.phi)
    put(f"{mname}/kl_nodes", r.kl_nodes)
'''


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def jax_setup():
    """`zoo_setup`, plus each model's reference epoch permutations."""
    setup, inputs = zoo_setup()
    keys = jstream.node_keys(N, SEED)
    for m in MODELS:
        cap = inputs[f"{m}/x"].shape[1]
        n_chunks = -(-cap // (cap // 2))
        inputs[f"{m}/perms"] = np.stack([np.asarray(jstream._epoch_perms(
            keys, jnp.asarray(e, jnp.int32), cap))
            for e in range((cap + 2) // n_chunks + 1)])
    return setup, inputs


@pytest.fixture(scope="module")
def ranks(jax_setup, tmp_path_factory):
    """The ranks' run (started here; `result()` waits)."""
    return launch_ranks(CODE, 4, tmp_path_factory.mktemp("zoosvrg4"),
                        inputs=jax_setup[1])


@pytest.fixture(scope="module")
def runs(ranks, jax_setup):
    setup, inputs = jax_setup
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    models = _ns(MODELS_SRC)["zoo_models"](inputs, th, tp, tckpt)
    port, jax_ = {}, {}
    for m, mdl in models.items():
        data, phi0 = (t[f"{m}/x"], t[f"{m}/mask"]), t[f"{m}/phi0"]
        cap, perms = data[0].shape[1], inputs[f"{m}/perms"]
        port[m] = te.run_vb(
            mdl, data, te.Diffusion(t["W"]), n_iters=cap + 2,
            init_phi=phi0, device="cpu", minibatch=tstream.MinibatchSpec(
                cap // 2, seed=SEED, control_variate="svrg",
                perm_fn=lambda e, p=perms: p[e]))
        jmdl, jdata, jphi0 = setup[m]
        jax_[m] = je.run_vb(
            jmdl, jdata, je.Diffusion(jnp.asarray(inputs["W"])),
            n_iters=cap + 2, init_phi=jphi0,
            minibatch=jstream.MinibatchSpec(cap // 2, SEED, "svrg"))
    return port, jax_


@pytest.mark.parametrize("model", MODELS)
def test_svrg_matches_single_array_executor(ranks, runs, model):
    out, port = ranks.result(), runs[0][model]
    for f in ("phi", "kl_nodes"):
        np.testing.assert_allclose(out[f"{model}/{f}"],
                                   getattr(port, f).numpy(), rtol=0,
                                   atol=EXECUTOR_BAR, err_msg=f)


@pytest.mark.parametrize("model", MODELS)
def test_svrg_matches_jax_single_array(ranks, runs, model):
    got = ranks.result()[f"{model}/phi"]
    want = np.asarray(runs[1][model].phi)
    np.testing.assert_allclose(got, want, rtol=GOLDEN, atol=GOLDEN)
