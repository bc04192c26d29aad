"""Which serving-fleet slices take the CUDA graph path
(serving/driver.py `_graph_eligible`), on the CPU (8 nodes x 10 points,
K=3, D=2, f64).

* The rule takes the graph only where every condition holds: a CUDA
  device, no mesh executor, full batch, taps closed, a model type and a
  topology whose step never waits for the host.  Each condition alone
  sends the slice to the eager loop: the CPU, an executor, a minibatch,
  open taps, ADMM (its projection's eigh reads its error flags back), a
  parity hook (`link_mask_fn`, `active_mask_fn` call `t.tolist()`), a
  model type that does not declare its step sync-free.
* A CPU fleet records 0 replays and no capture, and each tenant stays
  bit-equal to its solo `vb_run`.
* An eager slice drops a graph the group held (it rebinds the buffers
  the graph read).
* The kernel launch counters round-trip through `ops.launch_counts`,
  and a replay adds what its graph holds.

The graph path itself (capture, replay, bit-equality with the eager
loop) runs on the card: tests/test_torch_kernels_gpu.py.
"""
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core import engine, expfam, network
from repro_torch.core import model as model_lib
from repro_torch.data import stream, synthetic
from repro_torch.kernels import ops
from repro_torch.models.hmm import HMMModel
from repro_torch.models.ppca import PPCAModel
from repro_torch.serving import driver as drv
from repro_torch.serving.vb_service import VBRequest, VBService

K, D, N = 3, 2, 8
CUDA = torch.device("cuda")     # a device name: no card needed to build it


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device="cpu")
    adj, _ = network.random_geometric_graph(N, seed=4)
    data = [synthetic.paper_synthetic(n_nodes=N, n_per_node=10, seed=s)
            for s in range(4)]
    return dict(mdl=model_lib.GMMModel(prior, K, D, device="cpu"), adj=adj,
                W=network.nearest_neighbor_weights(adj),
                g=network.SparseGraph.from_dense(adj),
                data=[(d.x, d.mask) for d in data])


def _eligible(env, **change):
    """The rule on the fleet cell's configuration (GMM, dense Diffusion,
    full batch, no executor, taps closed, on CUDA) with `change`d
    inputs."""
    args = dict(device=CUDA, executor=None, minibatch=None, tap_window=None,
                model=env["mdl"], topology=engine.Diffusion(env["W"]))
    args.update(change)
    return drv._graph_eligible(**args)


@pytest.mark.parametrize("name", ["diffusion", "sparse_diffusion",
                                  "diffusion_drop", "ring", "ring_drop",
                                  "fusion", "isolated", "gossip",
                                  "hierarchical"])
def test_sync_free_configurations_take_the_graph(env, name):
    gw, rg = network.two_level_partition(N, 4, 2)
    topo = {
        "diffusion": lambda: engine.Diffusion(env["W"]),
        "sparse_diffusion": lambda: engine.Diffusion(
            network.sparse_nearest_neighbor_weights(env["g"])),
        "diffusion_drop": lambda: engine.Diffusion(env["W"], link_drop=0.3),
        "ring": engine.RingDiffusion,
        "ring_drop": lambda: engine.RingDiffusion(link_drop=0.3),
        "fusion": engine.FusionCenter,
        "isolated": engine.Isolated,
        "gossip": lambda: engine.PairwiseGossip(env["g"]),
        "hierarchical": lambda: engine.HierarchicalFusion(gw, rg),
    }[name]()
    assert _eligible(env, topology=topo)


def _hook(t):
    return torch.ones(N, N)


@pytest.mark.parametrize("case", [
    "cpu", "mesh_executor", "minibatch", "taps_open", "admm",
    "admm_adaptive", "diffusion_link_mask_fn", "ring_link_mask_fn",
    "gossip_active_mask_fn", "linreg_model", "ppca_model", "hmm_model",
    "undeclared_model"])
def test_each_condition_alone_keeps_the_eager_loop(env, case):
    change = {
        "cpu": dict(device=torch.device("cpu")),
        "mesh_executor": dict(executor=object()),
        "minibatch": dict(minibatch=stream.MinibatchSpec(batch_size=4)),
        "taps_open": dict(tap_window=object()),
        "admm": dict(topology=engine.ADMMConsensus(env["adj"])),
        "admm_adaptive": dict(topology=engine.ADMMConsensus(
            env["adj"], adaptive_rho=True)),
        "diffusion_link_mask_fn": dict(topology=engine.Diffusion(
            env["W"], link_mask_fn=_hook)),
        "ring_link_mask_fn": dict(topology=engine.RingDiffusion(
            link_mask_fn=_hook)),
        "gossip_active_mask_fn": dict(topology=engine.PairwiseGossip(
            env["g"], active_mask_fn=_hook)),
        # the rule reads the model's type alone
        "linreg_model": dict(model=model_lib.LinRegModel(D=2, device="cpu")),
        "ppca_model": dict(model=object.__new__(PPCAModel)),
        "hmm_model": dict(model=object.__new__(HMMModel)),
        "undeclared_model": dict(model=object()),
    }[case]
    assert _eligible(env)
    assert not _eligible(env, **change)


@pytest.mark.parametrize("name", ["ring", "isolated"])
def test_cpu_fleet_records_no_replay_and_matches_solo(env, name):
    """Join and leave with mixed budgets and taus through a 2-slot fleet
    under host telemetry: every slice eager (0 replays, no capture, no
    graph held), each tenant bit-equal to its solo run."""
    topo = {"ring": engine.RingDiffusion, "isolated": engine.Isolated}[name]
    budgets, taus = [12, 20, 8, 16], [0.2, 0.1, 0.5, 0.2]
    telemetry.reset()
    with telemetry.enabled_scope():
        svc = VBService(slice_iters=4, max_fleet=2, device="cpu")
        rids = [svc.submit(VBRequest(
            model=env["mdl"], data=d, topology=topo(), n_iters=n,
            schedule=engine.Schedule(tau=tau)))
            for d, n, tau in zip(env["data"], budgets, taus)]
        out = svc.run()
    rows = {r["name"]: r["value"] for r in telemetry.snapshot()
            if "value" in r}
    telemetry.reset()
    st = svc.stats()
    assert st.compiles == 1 and st.evicted == 4
    assert rows["driver_graph_replays_total"] == 0
    assert "driver_graph_captures_total" not in rows
    assert rows["driver_fleet_iterations_total"] == st.slices * 4
    assert all(g._graph is None for g in svc.driver._groups.values())
    for d, n, tau, rid in zip(env["data"], budgets, taus, rids):
        solo = engine.run_vb(env["mdl"], d, topo(), n_iters=n,
                             schedule=engine.Schedule(tau=tau),
                             device="cpu")
        assert torch.equal(solo.phi, out[rid].phi), rid


def test_eager_slice_drops_a_held_graph(env):
    """A slice on the eager loop (here the CPU's) rebinds the state
    buffers, so a graph the group held would read stale tensors: the
    slice lets it go."""
    svc = VBService(slice_iters=4, max_fleet=2, device="cpu")
    svc.submit(VBRequest(model=env["mdl"], data=env["data"][0],
                         topology=engine.RingDiffusion(), n_iters=8))
    (g,) = svc.driver._groups.values()
    g._graph = ("a graph of the old buffers", {})
    phi = g.phi
    svc.step_slice()
    assert g._graph is None and g.phi is not phi


def test_launch_counts_round_trip_and_replays_add_the_graph():
    ge = ops.gmm_estep_nodes
    saved = ops.launch_counts()
    try:
        ge.launches, ge.variant_launches["registers"] = 10, 7
        before = ops.launch_counts()
        assert before["gmm_estep_nodes"] == 10
        assert before[("gmm_estep_nodes", "registers")] == 7
        ge.launches += 1                    # a capture's launch ...
        ge.variant_launches["registers"] += 1
        after = ops.launch_counts()
        ops.set_launch_counts(before)       # ... which ran nothing
        assert ops.launch_counts() == before
        delta = {k: after[k] - n for k, n in before.items()}
        ops.add_launch_counts(delta, 5)     # five replays
        now = ops.launch_counts()
        assert now["gmm_estep_nodes"] == 15
        assert now[("gmm_estep_nodes", "registers")] == 12
        assert now[("gmm_estep_nodes", "shared")] == before[
            ("gmm_estep_nodes", "shared")]
        assert now["flash_attention"] == before["flash_attention"]
    finally:
        ops.set_launch_counts(saved)
