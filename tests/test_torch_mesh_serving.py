"""The port's serving fleets under the mesh executor
(`VBService(executor=MeshExecutor(group))`) on 4 gloo ranks, float64, on
the CPU; every rank runs the same service and the same calls.

* tests/test_bucketed.py's mesh fleet: rings over 8 nodes, per-node sizes
  9/10/13/16 padded to one rung of 16, taus 0.2/0.1, `max_fleet=4`,
  `slice_iters=6`, 18 iterations: ONE group stepped at one shape, and
  every tenant BIT-equal to its solo single-array `run_vb` on its own
  unpadded data (the contract of the reference's red mesh test, R2).
* The same tenants over Diffusion (Eq. 47 weights) and adaptive ADMM:
  within 1e-8 of their solo runs (the reference's executor bar).
* SVRG streams (B = 8 of 16, unbucketed) over Diffusion: within 1e-8 of
  their solo runs (the stream's per-node leaves sharded in the fleet).
* Early stop (tol) under the executor: the stop delta is averaged over
  the ranks, so each tenant stops at the single-array fleet's t, its phi
  within 1e-8 of that fleet's.
* Checkpoints under the executor: the ring fleet autosaves every slice
  and saves one session mid-run into one directory that all four ranks
  share.  Rank 0 alone writes (no rank races another on a file, no write
  fails), every rank resumes the files into a mesh service, and the test
  process resumes the mid-run file into a single-array service: every
  resumed tenant is bit-equal to its solo run.

Every rank's results are the same bit for bit (the launcher checks it).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import engine, expfam, network
from repro_torch.core import model as model_lib
from repro_torch.data import stream, synthetic
from repro_torch.serving.vb_service import VBRequest, VBService
from test_torch_mesh_collectives import launch_ranks

N_ITERS = 18
EXECUTOR_BAR = 1e-8

# the fleets' requests (the ranks and the test process build them alike)
REQUESTS = r'''
def fleet_requests(engine, expfam, model_lib, network, stream, synthetic,
                   VBRequest):
    prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                        device="cpu")
    mdl = model_lib.GMMModel(prior, 3, 2, device="cpu")
    data = [synthetic.paper_synthetic(n_nodes=8, n_per_node=n, seed=i)
            for i, n in enumerate([9, 10, 13, 16])]
    data = [(d.x, d.mask) for d in data]
    adj, _ = network.random_geometric_graph(8, seed=4)
    W = network.nearest_neighbor_weights(adj)
    taus = [0.2, 0.1, 0.2, 0.1]

    def reqs(topo, **kw):
        return [VBRequest(model=mdl, data=d, topology=topo, n_iters=18,
                          schedule=engine.Schedule(tau=tau), **kw)
                for d, tau in zip(data, taus)]

    full = [synthetic.paper_synthetic(n_nodes=8, n_per_node=16,
                                      seed=10 + i) for i in range(3)]
    spec = stream.MinibatchSpec(8, seed=3, control_variate="svrg")
    return {
        "ring": reqs(engine.RingDiffusion()),
        "diffusion": reqs(engine.Diffusion(W)),
        "admm": [VBRequest(model=mdl, data=d, n_iters=18,
                           topology=engine.ADMMConsensus(
                               adj, rho=rho, adaptive_rho=True))
                 for d, rho in zip(data, [0.3, 0.5, 0.8, 1.0])],
        "svrg": [VBRequest(model=mdl, data=(d.x, d.mask), n_iters=18,
                           topology=engine.Diffusion(W), minibatch=spec)
                 for d in full],
        "tol": reqs(engine.Diffusion(W), tol=0.2),
    }
'''
FLEETS = ["ring", "diffusion", "admm", "svrg", "tol"]

CODE = REQUESTS + r'''
from repro_torch.core import engine, expfam, network
from repro_torch.core import model as model_lib
from repro_torch.data import stream, synthetic
from repro_torch.serving.vb_service import VBRequest, VBService

groups = fleet_requests(engine, expfam, model_lib, network, stream,
                        synthetic, VBRequest)
for name, reqs in groups.items():
    svc = VBService(slice_iters=6, max_fleet=4, executor=EX, device="cpu")
    rids = [svc.submit(r) for r in reqs]
    out = svc.run()
    st = svc.stats()
    put(f"{name}/groups", len(svc._groups))
    put(f"{name}/compiles", st.compiles)
    put(f"{name}/t", [out[r].t for r in rids])
    for i, r in enumerate(rids):
        put(f"{name}/phi/{i}", out[r].phi)

# checkpoints: rank 0 writes, every rank resumes (one shared directory)
ckdir = os.path.join(os.path.dirname(os.environ["MESH_STORE"]), "ckpt")
ring = groups["ring"]
svc = VBService(slice_iters=6, max_fleet=4, executor=EX, device="cpu",
                ckpt_dir=ckdir, ckpt_every=1)
rids = [svc.submit(r) for r in ring]
svc.step_slice()
mid = svc.save_session(rids[0], os.path.join(ckdir, "mid.npz"))
svc.run()                               # its flush waits for rank 0's files
st = svc.stats()
put("rank/ckpt/writes", [st.checkpoints, st.checkpoint_errors])
put("ckpt/rids", rids)
svc2 = VBService(slice_iters=6, max_fleet=4, executor=EX, device="cpu")
back = [svc2.submit(ring[0], restore_from=mid)] + [
    svc2.submit(r, restore_from=os.path.join(ckdir, f"{rid}.npz"))
    for r, rid in zip(ring, rids)]
put("ckpt/t_restored", [svc2.status(r).t for r in back])
res = svc2.run()
put("ckpt/t", [res[r].t for r in back])
for i, r in enumerate(back):
    put(f"ckpt/phi/{i}", res[r].phi)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here too: the ranks hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_ranks(CODE, 4, tmp_path_factory.mktemp("serving4"))


@pytest.fixture(scope="module")
def groups(ranks):
    ns = {}
    exec(REQUESTS, ns)
    return ns["fleet_requests"](engine, expfam, model_lib, network, stream,
                                synthetic, VBRequest)


def _solo(r):
    return engine.run_vb(r.model, r.data, r.topology, n_iters=r.n_iters,
                         schedule=r.schedule, minibatch=r.minibatch,
                         device="cpu").phi.numpy()


@pytest.mark.parametrize("name", FLEETS[:4])
def test_fleet_one_group_matches_solo(ranks, groups, name):
    out = ranks.result()
    assert int(out[f"{name}/groups"]) == 1
    assert int(out[f"{name}/compiles"]) == 1
    assert list(out[f"{name}/t"]) == [N_ITERS] * len(groups[name])
    for i, r in enumerate(groups[name]):
        got, want = out[f"{name}/phi/{i}"], _solo(r)
        if name == "ring":          # the contract: bit-equal
            np.testing.assert_array_equal(got, want, err_msg=str(i))
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=EXECUTOR_BAR, err_msg=str(i))


def test_early_stop_under_the_executor(ranks, groups):
    out = ranks.result()
    svc = VBService(slice_iters=6, max_fleet=4, device="cpu")
    rids = [svc.submit(r) for r in groups["tol"]]
    res = svc.run()
    t = [res[r].t for r in rids]
    assert list(out["tol/t"]) == t
    assert min(t) < N_ITERS                 # some tenant stopped early
    for i, r in enumerate(rids):
        np.testing.assert_allclose(out[f"tol/phi/{i}"], res[r].phi.numpy(),
                                   rtol=0, atol=EXECUTOR_BAR)


def test_checkpoints_under_the_executor(ranks, groups):
    out = ranks.result()
    writes = [list(r["rank/ckpt/writes"]) for r in out["ranks"]]
    # rank 0: 3 slices x 4 autosaves + the mid-run save; the others none
    assert writes == [[13, 0]] + [[0, 0]] * 3
    ckdir = os.path.join(os.path.dirname(ranks.outs[0]), "ckpt")
    rids = [str(r) for r in out["ckpt/rids"]]
    assert sorted(os.listdir(ckdir)) == sorted(
        [f"{r}.npz" for r in rids] + ["mid.npz"])     # no stray temp file
    ring = groups["ring"]
    assert list(out["ckpt/t_restored"]) == [6] + [12] * 4
    assert list(out["ckpt/t"]) == [N_ITERS] * 5
    solo = [_solo(r) for r in ring]
    for i, want in enumerate([solo[0]] + solo):
        np.testing.assert_array_equal(out[f"ckpt/phi/{i}"], want,
                                      err_msg=str(i))
    # the mesh service's mid-run file resumed on the single-array executor
    svc = VBService(slice_iters=6, device="cpu")
    rid = svc.submit(ring[0], restore_from=os.path.join(ckdir, "mid.npz"))
    assert svc.status(rid).t == 6
    got = svc.run()[rid]
    assert got.t == N_ITERS
    np.testing.assert_array_equal(got.phi.numpy(), solo[0])
