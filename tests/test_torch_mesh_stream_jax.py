"""The port's mesh executor on streaming minibatches with SVRG against
the JAX package, on 4 gloo ranks, float64, on the CPU: the three
topologies of tests/test_torch_mesh_stream.py that file holds against
the port's single-array run only.

Its instance (8 nodes x 24 points, seed 9, the graph of seed 5, B = 8,
seed 3, `control_variate="svrg"`): diffusion (20 iterations), ADMM with
link drops (8: the projected run cut as there) and ADMM with drops and
no projection (25).  Each against the port's single-array run within
1e-8 and the JAX single-array `engine.run_vb` at 1e-9 (the bar of
tests/test_torch_stream.py), the reference's epoch permutations and link
coins handed to the port (`MinibatchSpec.perm_fn`, `link_mask_fn`).
"""
import jax
import jax.numpy as jnp
import pytest

from repro.core import engine as je
from repro.core import model as jm
from repro.data import stream as jstream
from repro_torch.core import engine as te
from repro_torch.data import stream as tstream
from test_torch_mesh_collectives import launch_ranks
from test_torch_mesh_sparse import (WORKER, builders, check, port_model,
                                    tensors)
from test_torch_mesh_stream import B, BUILDERS, K, D, SEED, stream_inputs

NAMES = ["dsvb", "admm-drop", "admm-drop-noproj"]

CODE = BUILDERS + WORKER + r'''
masks = {k: I[f"masks/{k}"] for k in ("matrix", "ring")}
spec = stream.MinibatchSpec(8, 3, "svrg", perm_fn=lambda e: I["perms"][e])
for name, topo, n_iters, kw in stream_topologies(engine, I["adj"], I["W"],
                                                 masks):
    if name in ("dsvb", "admm-drop", "admm-drop-noproj"):
        put_run(name, engine.run_vb(
            mdl, (I["x"], I["mask"]), topo, n_iters=n_iters,
            init_phi=I["phi0"], ref_phi=I["ref"], minibatch=spec,
            executor=EX, device="cpu", **kw))
'''


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def inputs():
    return stream_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The ranks' run (started here; `result()` waits)."""
    return launch_ranks(CODE, 4, tmp_path_factory.mktemp("streamjax4"),
                        inputs=inputs[0])


@pytest.fixture(scope="module")
def runs(ranks, inputs):
    inp, prior = inputs
    t = tensors(inp)
    masks = {k: t[f"masks/{k}"] for k in ("matrix", "ring")}
    perms = inp["perms"]
    spec = tstream.MinibatchSpec(B, SEED, "svrg", perm_fn=lambda e: perms[e])
    port = {name: te.run_vb(port_model(t), (t["x"], t["mask"]), topo,
                            n_iters=n, init_phi=t["phi0"], ref_phi=t["ref"],
                            minibatch=spec, device="cpu", **kw)
            for name, topo, n, kw in builders(BUILDERS)["stream_topologies"](
                te, t["adj"], t["W"], masks) if name in NAMES}
    adj, W = jnp.asarray(inp["adj"]), jnp.asarray(inp["W"])
    drop = dict(link_drop=0.3, link_seed=2)
    jax_topos = {
        "dsvb": (je.Diffusion(W), 20, dict(schedule=je.Schedule())),
        "admm-drop": (je.ADMMConsensus(adj, **drop), 8, {}),
        "admm-drop-noproj": (je.ADMMConsensus(adj, project=False, **drop),
                             25, {})}
    mdl = jm.GMMModel(prior, K, D)
    jspec = jstream.MinibatchSpec(B, SEED, "svrg")
    jax_ = {name: je.run_vb(mdl, (inp["x"], inp["mask"]), topo,
                            n_iters=n, init_phi=inp["phi0"],
                            ref_phi=inp["ref"], minibatch=jspec, **kw)
            for name, (topo, n, kw) in jax_topos.items()}
    return port, jax_


@pytest.mark.parametrize("name", NAMES)
def test_streaming_svrg_matches_jax(ranks, runs, name):
    port, jax_ = runs
    check(ranks.result(), name, port[name], jax_[name])
