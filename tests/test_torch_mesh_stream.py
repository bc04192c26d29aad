"""The port's mesh executor on streaming minibatches with SVRG, on 4
gloo ranks, float64, on the CPU.

tests/test_streaming.py's executor instance (8 nodes x 24 points, seed
9, the graph of seed 5, B = 8, seed 3) with `control_variate="svrg"`:
diffusion, diffusion and the ring with link drops, ADMM with drops (with
and without the projection; the projected runs cut to 8 iterations, as
there) and adaptive ADMM; and the full-batch spec bit-equal to the
full-batch run under the executor.  Each against the port's single-array
run within 1e-8; the diffusion and ring runs with drops and adaptive
ADMM also against the JAX package's at 1e-9 (the bar of
tests/test_torch_stream.py), the reference's epoch permutations and link
coins handed to the port (`MinibatchSpec.perm_fn`, `link_mask_fn`): the
whole (N, T) permutations, of which each rank takes its rows
(`stream.local_spec`).  The other three topologies meet JAX in
tests/test_torch_mesh_stream_jax.py (the reference compiles each SVRG
run for seconds, so the six JAX runs are split over two files).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as je
from repro.core import model as jm
from repro.core import network as jn
from repro.data import stream as jstream
from repro_torch.core import engine as te
from repro_torch.data import stream as tstream
from test_torch_mesh_collectives import launch_ranks
from test_torch_mesh_sparse import (HOOK, WORKER, builders, check,
                                    instance, keep_masks, port_model,
                                    tensors)

K, D = 3, 2
N, T, B, SEED = 8, 24, 8, 3

BUILDERS = HOOK + r'''
def stream_topologies(engine, adj, W, masks):
    m, r = _hook(masks["matrix"]), _hook(masks["ring"])
    sched = dict(schedule=engine.Schedule())
    return [
        ("dsvb", engine.Diffusion(W), 20, sched),
        ("dsvb-drop", engine.Diffusion(W, link_mask_fn=m), 20, sched),
        ("ring-drop", engine.RingDiffusion(link_mask_fn=r), 20, sched),
        ("admm-drop", engine.ADMMConsensus(adj, link_mask_fn=m), 8, {}),
        ("admm-drop-noproj", engine.ADMMConsensus(
            adj, link_mask_fn=m, project=False), 25, {}),
        ("admm-adaptive-drop", engine.ADMMConsensus(
            adj, adaptive_rho=True, link_mask_fn=m), 8, {}),
    ]
'''
NAMES = ["dsvb", "dsvb-drop", "ring-drop", "admm-drop", "admm-drop-noproj",
         "admm-adaptive-drop"]
JAX_NAMES = ["dsvb-drop", "ring-drop", "admm-adaptive-drop"]

CODE = BUILDERS + WORKER + r'''
masks = {k: I[f"masks/{k}"] for k in ("matrix", "ring")}
spec = stream.MinibatchSpec(8, 3, "svrg", perm_fn=lambda e: I["perms"][e])
data = (I["x"], I["mask"])
for name, topo, n_iters, kw in stream_topologies(engine, I["adj"], I["W"],
                                                 masks):
    put_run(name, engine.run_vb(
        mdl, data, topo, n_iters=n_iters, init_phi=I["phi0"],
        ref_phi=I["ref"], minibatch=spec, executor=EX, device="cpu", **kw))
full = engine.run_vb(mdl, data, engine.Diffusion(I["W"]), n_iters=15,
                     executor=EX, device="cpu")
full_spec = engine.run_vb(mdl, data, engine.Diffusion(I["W"]), n_iters=15,
                          minibatch=stream.MinibatchSpec(24), executor=EX,
                          device="cpu")
put("full/phi", full.phi)
put("full_spec/phi", full_spec.phi)
'''


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def stream_inputs():
    """The instance, its link coins and the reference's epoch
    permutations (arrays for the ranks), and the JAX prior."""
    inp, prior = instance(N, T, 9, 5)
    inp["W"] = np.array(jn.nearest_neighbor_weights(inp["adj"]))
    inp["masks/matrix"] = keep_masks(jn.link_keep_matrix, 2, N, 0.3, 25)
    inp["masks/ring"] = keep_masks(jn.ring_link_keep, 2, N, 0.3, 25)
    keys = jstream.node_keys(N, SEED)
    n_chunks = -(-T // B)
    inp["perms"] = np.stack([np.asarray(jstream._epoch_perms(
        keys, jnp.asarray(e, jnp.int32), T))
        for e in range(25 // n_chunks + 1)])
    return inp, prior


@pytest.fixture(scope="module")
def inputs():
    return stream_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The ranks' run (started here; `result()` waits)."""
    return launch_ranks(CODE, 4, tmp_path_factory.mktemp("stream4"),
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
                te, t["adj"], t["W"], masks)}
    adj, W = jnp.asarray(inp["adj"]), jnp.asarray(inp["W"])
    drop = dict(link_drop=0.3, link_seed=2)
    sched = dict(schedule=je.Schedule())
    jax_topos = {
        "dsvb-drop": (je.Diffusion(W, **drop), 20, sched),
        "ring-drop": (je.RingDiffusion(**drop), 20, sched),
        "admm-adaptive-drop": (je.ADMMConsensus(adj, adaptive_rho=True,
                                                **drop), 8, {})}
    mdl = jm.GMMModel(prior, K, D)
    jspec = jstream.MinibatchSpec(B, SEED, "svrg")
    jax_ = {name: je.run_vb(mdl, (inp["x"], inp["mask"]), topo,
                            n_iters=n, init_phi=inp["phi0"],
                            ref_phi=inp["ref"], minibatch=jspec, **kw)
            for name, (topo, n, kw) in jax_topos.items()}
    return port, jax_


@pytest.mark.parametrize("name", NAMES)
def test_streaming_svrg_matches_single_array(ranks, runs, name):
    port, _ = runs
    check(ranks.result(), name, port[name])


@pytest.mark.parametrize("name", JAX_NAMES)
def test_streaming_svrg_matches_jax(ranks, runs, name):
    port, jax_ = runs
    check(ranks.result(), name, port[name], jax_[name])


def test_full_batch_spec_bit_equal_under_the_executor(ranks):
    out = ranks.result()
    np.testing.assert_array_equal(out["full_spec/phi"], out["full/phi"])
