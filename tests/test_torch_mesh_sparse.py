"""The port's mesh executor on the sparse topologies, on 2 gloo ranks,
float64, on the CPU.

tests/test_sparse_topology.py's executor instance (50 nodes x 20 points,
seed 2, the graph of seed 4, 20 iterations): sparse diffusion with and
without link drops, the ring over its edge list with drops, adaptive
per-block ADMM over the edge list, gossip and the hierarchy.  Each
against the port's single-array run within 1e-8 (the reference's
executor bar; phi, the KLs, the consensus error, the diagnostics) and
against the JAX package's single-array `engine.run_vb` at 1e-9 (the bar
of tests/test_torch_sparse_topology.py).  The reference's link coins and
gossip activations come from `jax.random`, which torch does not
reproduce: they are handed to the port (`link_mask_fn`,
`active_mask_fn`), the whole draw, of which each rank's combine uses its
rows.  The helpers here serve tests/test_torch_mesh_stream.py too.
"""
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
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.core import network as tn
from test_torch_mesh_collectives import launch_ranks

K, D = 3, 2
EXECUTOR_BAR = 1e-8
PARITY = 1e-9
SPARSE_N, SPARSE_ITERS = 50, 20

# the port's topologies with the reference's draws injected (the ranks
# and the test process build them alike)
HOOK = r'''
def _hook(m):
    return lambda t: m[t]
'''

BUILDERS = HOOK + r'''


def sparse_topologies(engine, network, adj, masks):
    g = network.SparseGraph.from_dense(adj)
    sw = network.sparse_nearest_neighbor_weights(g)
    gw, rg = network.two_level_partition(adj.shape[0], 8, 2)
    sched = dict(schedule=engine.Schedule())
    return [
        ("sparse-diffusion", engine.Diffusion(sw), sched),
        ("sparse-diffusion-drop",
         engine.Diffusion(sw, link_mask_fn=_hook(masks["drop"])), sched),
        ("sparse-ring", engine.RingDiffusion(
            graph=network.SparseGraph.ring(adj.shape[0]),
            link_mask_fn=_hook(masks["ring"])), sched),
        ("sparse-admm", engine.ADMMConsensus(g, adaptive_rho=True,
                                             per_block=True), {}),
        ("gossip", engine.PairwiseGossip(
            g, p_activate=0.4, seed=5,
            active_mask_fn=_hook(masks["gossip"])), sched),
        ("hier", engine.HierarchicalFusion(gw, rg), sched),
    ]

'''
SPARSE_NAMES = ["sparse-diffusion", "sparse-diffusion-drop", "sparse-ring",
                "sparse-admm", "gossip", "hier"]

# the ranks' model and `put_run`
WORKER = r'''
from repro_torch.core import engine, expfam, network
from repro_torch.core import model as model_lib
from repro_torch.data import stream

I = {k: torch.from_numpy(v) for k, v in INPUTS.items()}
prior = expfam.GMMPosterior(*(I[f"prior/{i}"] for i in range(5)))
mdl = model_lib.GMMModel(prior, 3, 2, device="cpu")


def put_run(name, r):
    put(f"{name}/phi", r.phi)
    put(f"{name}/kl_nodes", r.kl_nodes)
    put(f"{name}/consensus_err", r.consensus_err)
    if r.consensus_diag is not None:
        for f, v in r.consensus_diag._asdict().items():
            put(f"{name}/diag/{f}", v)
'''

SPARSE_CODE = BUILDERS + WORKER + r'''
masks = {k: I[f"masks/{k}"] for k in ("drop", "ring", "gossip")}
for name, topo, kw in sparse_topologies(engine, network, INPUTS["adj"],
                                        masks):
    put_run(name, engine.run_vb(
        mdl, (I["x"], I["mask"]), topo, n_iters=20, init_phi=I["phi0"],
        ref_phi=I["ref"], executor=EX, device="cpu", **kw))
'''

@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def builders(source):
    """The functions a builder source defines."""
    ns = {}
    exec(source, ns)
    return ns


def instance(n_nodes, n_per, seed, graph_seed):
    data = js.paper_synthetic(n_nodes=n_nodes, n_per_node=n_per, seed=seed)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    adj, _ = jn.random_geometric_graph(n_nodes, seed=graph_seed)
    x_all, labels = data.flat
    ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels, prior,
                                                     K))
    phi0 = jnp.broadcast_to(jx.pack_natural(prior),
                            (n_nodes, jx.flat_dim(K, D)))
    out = dict(x=data.x, mask=data.mask, adj=np.asarray(adj, np.float64),
               ref=ref, phi0=phi0)
    out.update({f"prior/{i}": a for i, a in enumerate(prior)})
    return {k: np.array(v) for k, v in out.items()}, prior


def keep_masks(fn, seed, n, drop, n_iters):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(fn(key, t, n, drop, jnp.float64))
                     for t in range(n_iters)])


@pytest.fixture(scope="module")
def sparse_inputs():
    inp, prior = instance(SPARSE_N, 20, 2, 4)
    g = jn.SparseGraph.from_dense(inp["adj"])
    inp["masks/drop"] = keep_masks(jn.sparse_link_keep, 7, g.n_undirected, 0.3,
                              SPARSE_ITERS)
    inp["masks/ring"] = keep_masks(jn.sparse_link_keep, 0, SPARSE_N, 0.2,
                              SPARSE_ITERS)
    inp["masks/gossip"] = keep_masks(jn.sparse_link_keep, 5, g.n_undirected,
                                0.6, SPARSE_ITERS)
    return inp, prior


@pytest.fixture(scope="module")
def ranks(sparse_inputs, tmp_path_factory):
    """The ranks' run (started here; `result()` waits)."""
    return launch_ranks(SPARSE_CODE, 2, tmp_path_factory.mktemp("sparse2"),
                        inputs=sparse_inputs[0])


def tensors(inp):
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def port_model(t):
    return tm.GMMModel(tx.GMMPosterior(*(t[f"prior/{i}"] for i in range(5))),
                       K, D, device="cpu")


@pytest.fixture(scope="module")
def sparse_runs(ranks, sparse_inputs):
    inp, prior = sparse_inputs
    t = tensors(inp)
    masks = {k: t[f"masks/{k}"] for k in ("drop", "ring", "gossip")}
    port = {name: te.run_vb(port_model(t), (t["x"], t["mask"]), topo,
                            n_iters=SPARSE_ITERS, init_phi=t["phi0"],
                            ref_phi=t["ref"], device="cpu", **kw)
            for name, topo, kw in builders(BUILDERS)["sparse_topologies"](
                te, tn, inp["adj"], masks)}
    g = jn.SparseGraph.from_dense(inp["adj"])
    sw = jn.sparse_nearest_neighbor_weights(g)
    gw, rg = jn.two_level_partition(SPARSE_N, 8, 2)
    sched = dict(schedule=je.Schedule())
    jax_topos = {
        "sparse-diffusion": (je.Diffusion(sw), sched),
        "sparse-diffusion-drop": (je.Diffusion(sw, link_drop=0.3,
                                               link_seed=7), sched),
        "sparse-ring": (je.RingDiffusion(graph=jn.SparseGraph.ring(
            SPARSE_N), link_drop=0.2), sched),
        "sparse-admm": (je.ADMMConsensus(g, adaptive_rho=True,
                                         per_block=True), {}),
        "gossip": (je.PairwiseGossip(g, p_activate=0.4, seed=5), sched),
        "hier": (je.HierarchicalFusion(gw, rg), sched)}
    mdl = jm.GMMModel(prior, K, D)
    jax_ = {name: je.run_vb(mdl, (inp["x"], inp["mask"]), topo,
                            n_iters=SPARSE_ITERS, init_phi=inp["phi0"],
                            ref_phi=inp["ref"], **kw)
            for name, (topo, kw) in jax_topos.items()}
    return port, jax_


def check(out, name, port, jax_run=None):
    """The ranks' run against the port's single-array run (executor bar)
    and, given, the JAX single-array run (parity bar)."""
    for field in ("phi", "kl_nodes", "consensus_err"):
        np.testing.assert_allclose(out[f"{name}/{field}"],
                                   getattr(port, field).numpy(),
                                   rtol=0, atol=EXECUTOR_BAR, err_msg=field)
    if port.consensus_diag is not None:
        for f, v in port.consensus_diag._asdict().items():
            np.testing.assert_allclose(out[f"{name}/diag/{f}"], v.numpy(),
                                       rtol=0, atol=EXECUTOR_BAR, err_msg=f)
    if jax_run is None:
        return
    np.testing.assert_allclose(out[f"{name}/phi"], np.asarray(jax_run.phi),
                               rtol=PARITY, atol=PARITY)
    np.testing.assert_allclose(out[f"{name}/kl_nodes"],
                               np.asarray(jax_run.kl_nodes), rtol=PARITY,
                               atol=PARITY)
    if port.consensus_diag is not None:
        for f in port.consensus_diag._fields:
            np.testing.assert_allclose(
                out[f"{name}/diag/{f}"],
                np.asarray(getattr(jax_run.consensus_diag, f)),
                rtol=PARITY, atol=PARITY, err_msg=f)


@pytest.mark.parametrize("name", SPARSE_NAMES)
def test_sparse_topologies(ranks, sparse_runs, name):
    port, jax_ = sparse_runs
    check(ranks.result(), name, port[name], jax_[name])
