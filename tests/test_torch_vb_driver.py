"""The port's continuous-batching driver (serving/driver.py) on its own
contracts, on the CPU (8 nodes x 10-16 points, K=3, D=2, f64).

Bars, each stated where it is held:

* a session served in a fleet against the port's solo `vb_run` of the
  same length: BIT-equal for the elementwise combines (RingDiffusion,
  FusionCenter, Isolated) without padding, within 1e-9 relative for the
  matmul and segmented combines and for padded (bucketed) data;
* the same admissions driven with another slice length: BIT-equal;
* `compiles` (the fleet shapes stepped) is 1 per fixed-capacity group
  through any number of joins and leaves, and grows with `_grow`;
* one local step per fleet iteration: on the fused backend, one
  `gmm_estep_nodes` call over (S N, T, D) an iteration (the CPU runs the
  kernel's plain version, counted here);
* early stop freezes a slot's state and t; `extend_budget` and
  `push_data` un-latch an evicted session; an overflowing push re-buckets
  with an exact replay;
* `save_session` / `restore_from`: bit-exact within the port; across
  packages (a JAX `VBService.save_session` file resumed in the port, the
  port's file resumed by JAX) within 1e-9 of the other package's
  uninterrupted run;
* the background thread, `drain` and the periodic checkpoint writes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import engine, expfam, network
from repro_torch.core import model as model_lib
from repro_torch.data import stream, synthetic
from repro_torch.kernels import gmm_estep as ge
from repro_torch.serving import driver as drv
from repro_torch.serving.vb_service import VBRequest, VBService

K, D, N = 3, 2, 8
CLOSE = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a pool of threads
    synchronising on each small op runs ~10x slower when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device="cpu")
    adj, _ = network.random_geometric_graph(N, seed=4)
    W = network.nearest_neighbor_weights(adj)
    g = network.SparseGraph.from_dense(adj)
    data = [synthetic.paper_synthetic(n_nodes=N, n_per_node=10, seed=s)
            for s in range(5)]
    return dict(prior=prior, mdl=model_lib.GMMModel(prior, K, D,
                                                    device="cpu"),
                adj=adj, W=W, g=g,
                data=[(d.x, d.mask) for d in data])


def _data(n_per, seed):
    d = synthetic.paper_synthetic(n_nodes=N, n_per_node=n_per, seed=seed)
    return d.x, d.mask


def _topology(name, e):
    """(topology, schedule) of a named configuration."""
    gw, rg = network.two_level_partition(N, 4, 2)
    sw = network.sparse_nearest_neighbor_weights(e["g"])
    return {
        "ring": (engine.RingDiffusion(), engine.Schedule()),
        "fusion": (engine.FusionCenter(), engine.ONE_SHOT),
        "isolated": (engine.Isolated(), engine.Schedule(tau=0.1)),
        "diffusion": (engine.Diffusion(e["W"]), engine.Schedule()),
        "diffusion_drop": (engine.Diffusion(e["W"], link_drop=0.3,
                                            link_seed=2), engine.Schedule()),
        "ring_drop": (engine.RingDiffusion(link_drop=0.3, link_seed=5),
                      engine.Schedule()),
        "sparse_diffusion_drop": (engine.Diffusion(sw, link_drop=0.3),
                                  engine.Schedule()),
        "gossip": (engine.PairwiseGossip(e["g"], p_activate=0.5, seed=3),
                   engine.Schedule()),
        "hierarchical": (engine.HierarchicalFusion(gw, rg),
                         engine.Schedule()),
        "admm": (engine.ADMMConsensus(e["adj"]), engine.Schedule()),
        "admm_adaptive_per_block_drop": (engine.ADMMConsensus(
            e["g"], adaptive_rho=True, per_block=True, link_drop=0.2),
            engine.Schedule()),
    }[name]


BIT_EQUAL = ("ring", "fusion", "isolated")


def _serve(e, topo, sched, datasets, budgets, *, slice_iters=8,
           max_fleet=3, minibatch=None, tol=0.0, arrive=None, **kw):
    svc = VBService(slice_iters=slice_iters, max_fleet=max_fleet,
                    device="cpu", **kw)
    rids = [svc.submit(VBRequest(model=e["mdl"], data=d, topology=topo,
                                 n_iters=n, schedule=sched,
                                 minibatch=minibatch, tol=tol),
                       arrive_at=None if arrive is None else arrive[i])
            for i, (d, n) in enumerate(zip(datasets, budgets))]
    return svc, rids, svc.run()


def _solo(e, topo, sched, d, n, minibatch=None, model=None):
    return engine.run_vb(model or e["mdl"], d, topo, n_iters=n,
                         schedule=sched, minibatch=minibatch, device="cpu")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", ["ring", "fusion", "isolated", "diffusion",
                                  "diffusion_drop", "ring_drop",
                                  "sparse_diffusion_drop", "gossip",
                                  "hierarchical", "admm",
                                  "admm_adaptive_per_block_drop"])
def test_fleet_matches_solo(env, name):
    """5 sessions with mixed budgets through a 3-slot fleet (one arriving
    at slice 2, queued behind the full fleet): each ends where its solo
    run of the same length does; one fleet shape stepped."""
    topo, sched = _topology(name, env)
    budgets = [16, 24, 40, 16, 24]
    svc, rids, out = _serve(env, topo, sched, env["data"], budgets,
                            arrive=[0, 0, 0, 0, 2])
    st = svc.stats()
    assert st.compiles == 1 and st.admitted == 5 and st.evicted == 5
    assert st.queue_depth == 0 and st.active == 0
    for d, n, rid in zip(env["data"], budgets, rids):
        s = out[rid]
        assert s.done and s.evicted and s.t == n
        solo = _solo(env, _topology(name, env)[0], sched, d, n)
        if name in BIT_EQUAL:
            assert torch.equal(solo.phi, s.phi), rid
        else:
            assert _rel(s.phi, solo.phi) <= CLOSE, rid


@pytest.mark.parametrize("name", ["ring", "diffusion", "admm"])
def test_bucketed_mixed_shapes_and_taus_match_solo(env, name):
    """Capacities 9/10/13/16 padded to rung 16 and three taus in ONE
    group: each session within 1e-9 of its solo run on its own unpadded
    data (the padding changes the reduction's shape)."""
    topo, _ = _topology(name, env)
    sizes, taus = [9, 10, 13, 16], [0.2, 0.05, 1.0, 0.2]
    scheds = ([engine.Schedule(tau=t) for t in taus] if name != "admm"
              else [engine.Schedule()] * 4)
    svc = VBService(slice_iters=6, max_fleet=4, device="cpu")
    datasets = [_data(n, i) for i, n in enumerate(sizes)]
    rids = [svc.submit(VBRequest(model=env["mdl"], data=d, topology=topo,
                                 n_iters=18, schedule=s))
            for d, s in zip(datasets, scheds)]
    out = svc.run()
    st = svc.stats()
    assert len(svc._groups) == 1 and st.compiles == 1
    (b,) = st.buckets
    assert b.bucket_capacity == 16 and b.label == "GMMModel/N8/cap16"
    assert b.data_pad_frac == pytest.approx((7 + 6 + 3 + 0) / 16 / 4)
    for d, s, rid in zip(datasets, scheds, rids):
        solo = _solo(env, _topology(name, env)[0], s, d, 18)
        assert _rel(out[rid].phi, solo.phi) <= CLOSE, rid


@pytest.mark.parametrize("name,mb", [
    ("ring", None), ("diffusion_drop", None),
    ("admm_adaptive_per_block_drop", None),
    ("ring", stream.MinibatchSpec(4, 2, "svrg")),
    ("gossip", stream.MinibatchSpec(3, 1))])
def test_bit_invariant_to_slice_length(env, name, mb):
    """The same admissions driven in slices of 6 and of 9 iterations
    (other eviction ticks, slots idle at other times): bit-equal phi and
    t, and the streaming sessions bit-equal to their solo runs."""
    topo, sched = _topology(name, env)
    budgets = [12, 18, 24]
    runs = []
    for k in (6, 9):
        svc, rids, out = _serve(env, topo, sched, env["data"][:3], budgets,
                                slice_iters=k, minibatch=mb)
        assert svc.stats().compiles == 1
        runs.append([(out[r].phi, out[r].t) for r in rids])
    for (a, ta), (b, tb) in zip(*runs):
        assert torch.equal(a, b) and ta == tb
    if mb is not None:
        for d, n, (phi, _) in zip(env["data"], budgets, runs[0]):
            solo = _solo(env, _topology(name, env)[0], sched, d, n, mb)
            assert torch.equal(solo.phi, phi)


def test_one_local_step_per_fleet_iteration(env, monkeypatch):
    """The fused backend's E-step runs once an iteration over the whole
    fleet: (3 slots x 8 nodes, T, D), whatever the occupancy."""
    calls = []
    plain = ge.gmm_estep_nodes_plain

    def counted(x, *a, **kw):
        calls.append(tuple(x.shape))
        return plain(x, *a, **kw)

    monkeypatch.setattr(ge, "gmm_estep_nodes_plain", counted)
    mdl = model_lib.GMMModel(env["prior"], K, D, backend="fused",
                             device="cpu")
    svc = VBService(slice_iters=5, max_fleet=3, device="cpu")
    rids = [svc.submit(VBRequest(model=mdl, data=d,
                                 topology=engine.RingDiffusion(),
                                 n_iters=n))
            for d, n in zip(env["data"][:2], (10, 15))]
    calls.clear()
    out = svc.run()
    assert calls == [(3 * N, 16, D)] * 15      # 3 slices of 5, one a step
    for d, n, rid in zip(env["data"], (10, 15), rids):
        solo = engine.run_vb(mdl, d, engine.RingDiffusion(), n_iters=n,
                             device="cpu")
        assert _rel(out[rid].phi, solo.phi) <= CLOSE


def test_compiles_through_join_leave_and_growth(env):
    """A fixed 2-slot fleet through 5 joins and leaves steps one shape;
    power-of-two growth allocates a new shape each time it grows while
    sessions run."""
    topo = engine.RingDiffusion()
    svc, _, _ = _serve(env, topo, engine.Schedule(), env["data"],
                       [8, 16, 8, 24, 8], slice_iters=4, max_fleet=2)
    st = svc.stats()
    assert (st.compiles, st.admitted, st.evicted, st.capacity) \
        == (1, 5, 5, 2)
    grow = VBService(slice_iters=4, device="cpu")   # auto-growth
    for i, d in enumerate(env["data"][:3]):
        grow.submit(VBRequest(model=env["mdl"], data=d, topology=topo,
                              n_iters=12), arrive_at=i)
    grow.run()
    st = grow.stats()
    # capacities 1, 2 and 4 each stepped once
    assert st.capacity == 4 and st.compiles == 3
    with pytest.raises(TypeError, match="MeshExecutor"):
        VBService(executor=object(), device="cpu")


def test_early_stop_freezes_state(env):
    """A session that converges (tol) mid-slice stops advancing t and
    phi: its final state is the solo run's at that t, bit for bit, while
    a longer neighbour in the same fleet keeps running."""
    topo, sched = _topology("ring", env)
    svc = VBService(slice_iters=7, max_fleet=2, device="cpu")
    a = svc.submit(VBRequest(model=env["mdl"], data=env["data"][0],
                             topology=topo, n_iters=400, tol=1e-2))
    b = svc.submit(VBRequest(model=env["mdl"], data=env["data"][1],
                             topology=topo, n_iters=400))
    out = svc.run()
    sa, sb = out[a], out[b]
    assert sa.converged and sa.done and sa.evicted and sa.t < 400
    assert sa.t % 7 != 0                        # stopped inside a slice
    assert sa.delta < 1e-2 and not sb.converged and sb.t == 400
    solo = _solo(env, topo, sched, env["data"][0], sa.t)
    assert torch.equal(solo.phi, sa.phi)


def test_extend_budget_and_push_data_unlatch_evicted(env):
    topo, sched = _topology("ring", env)
    x, mask = env["data"][1]
    mask = mask.clone()
    mask[:, -4:] = 0.0                          # room for arrivals
    svc = VBService(slice_iters=5, max_fleet=2, device="cpu")
    a = svc.submit(VBRequest(model=env["mdl"], data=env["data"][0],
                             topology=topo, n_iters=400, tol=1e-2))
    b = svc.submit(VBRequest(model=env["mdl"], data=(x, mask),
                             topology=topo, n_iters=300, tol=1e-2))
    out = svc.run()
    assert out[a].converged and out[a].evicted
    t_conv, phi_b = out[a].t, out[b].phi.clone()
    svc.extend_budget(a, 10)            # un-latch + re-queue + re-admit
    st = svc.status(a)
    assert not st.converged and not st.done and st.budget == 410
    pts = np.random.default_rng(0).normal(size=(3, D))
    svc.push_data(b, node=1, points=pts)
    assert not svc.status(b).converged
    out = svc.run()
    assert out[a].t >= t_conv and out[a].done
    assert out[b].done and not torch.equal(out[b].phi, phi_b)
    # the pushed points landed in node 1's first free slots (of the
    # buffer padded to rung 16)
    data_b = svc.driver._finished[b]["record"]["data"]
    assert torch.equal(data_b[1][1], torch.cat([
        mask[1, :-4], torch.ones(3, dtype=mask.dtype),
        torch.zeros(7, dtype=mask.dtype)]))
    assert torch.equal(data_b[0][1, 6:9], torch.as_tensor(pts))
    assert svc.stats().admitted == 4


def test_push_data_overflow_rebuckets_with_exact_replay(env):
    """A full rung-8 session receives 3 points mid-flight: the driver
    evicts it, regrows the buffers to rung 16, re-admits, and the final
    phi equals the replayed vb_init/vb_run trajectory (5 iterations on
    the old buffers, 15 on the regrown ones) bit for bit."""
    mdl, topo = env["mdl"], engine.RingDiffusion()
    data = _data(8, 0)                          # rung 8, no free slot
    pts = np.random.default_rng(7).normal(size=(3, D))
    svc = VBService(slice_iters=5, max_fleet=2, device="cpu")
    rid = svc.submit(VBRequest(model=mdl, data=data, topology=topo,
                               n_iters=20))
    assert svc.step_slice() == 1
    svc.push_data(rid, node=1, points=pts)
    out = svc.run()
    assert out[rid].done and out[rid].t == 20
    st = svc.stats()
    assert st.evicted >= 2
    assert [b.bucket_capacity for b in st.buckets] == [16, 8]
    s = engine.vb_init(mdl, data, topo, device="cpu")
    s, _ = engine.vb_run(s, 5)
    grown = mdl.append_node_data(mdl.pad_to_capacity(data, 16), 1, pts)
    s2 = engine.vb_init(mdl, grown, topo, device="cpu")
    s2, _ = engine.vb_run(s2.replace(phi=s.phi, t=s.t, carry=s.carry), 15)
    assert torch.equal(s2.phi, out[rid].phi)
    bare = VBService(slice_iters=5, bucket=None, device="cpu")
    r = bare.submit(VBRequest(model=mdl, data=data, topology=topo,
                              n_iters=5))
    with pytest.raises(ValueError, match="buffer full"):
        bare.push_data(r, node=0, points=pts)


@pytest.mark.parametrize("name", ["ring", "admm_adaptive_per_block_drop"])
def test_save_restore_round_trip_bit_exact(env, tmp_path, name):
    """Save mid-run from a fleet slot, restore into a fresh service and
    finish: bit-equal to the uninterrupted session; a checkpoint of a
    finished session restores finished."""
    topo, sched = _topology(name, env)
    req = VBRequest(model=env["mdl"], data=env["data"][0], topology=topo,
                    schedule=sched, n_iters=20)
    svc = VBService(slice_iters=5, max_fleet=2, device="cpu")
    rid = svc.submit(req)
    svc.submit(req._replace(data=env["data"][1]))
    svc.step_slice()
    path = svc.save_session(rid, str(tmp_path / "mid.npz"))
    whole = svc.run()[rid]
    svc2 = VBService(slice_iters=7, device="cpu")
    r2 = svc2.submit(req, restore_from=path)
    st = svc2.status(r2)
    assert st.t == 5 and not st.done
    got = svc2.run()[r2]
    assert got.t == 20 and torch.equal(got.phi, whole.phi)
    end = svc.save_session(rid, str(tmp_path / "end.npz"), wait=False)
    svc.driver.flush_checkpoints()
    r3 = svc2.submit(req, restore_from=end)
    st3 = svc2.status(r3)
    assert st3.done and st3.evicted and st3.t == 20
    assert torch.equal(st3.phi, whole.phi)


def test_checkpoints_across_packages(env, tmp_path):
    """A JAX `VBService.save_session` file (adaptive ADMM, mid-run)
    resumes in the port's `submit(restore_from=)` and ends within 1e-9 of
    the JAX uninterrupted run; the port's file of the same session
    resumes in the JAX service within 1e-9 too."""
    from repro.core import engine as je
    from repro.core import expfam as jx
    from repro.core import model as jm
    from repro.data import synthetic as js
    from repro.serving import vb_service as jsvc

    jax.config.update("jax_enable_x64", True)
    try:
        prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
        jmdl = jm.GMMModel(prior, K, D)
        d = js.paper_synthetic(n_nodes=N, n_per_node=12, seed=3)
        adj = np.asarray(env["adj"])
        jreq = jsvc.VBRequest(model=jmdl, data=(d.x, d.mask),
                              topology=je.ADMMConsensus(jnp.asarray(adj),
                                                        adaptive_rho=True),
                              n_iters=20)
        treq = VBRequest(model=env["mdl"],
                         data=(torch.from_numpy(np.array(d.x)),
                               torch.from_numpy(np.array(d.mask))),
                         topology=engine.ADMMConsensus(
                             torch.from_numpy(adj), adaptive_rho=True),
                         n_iters=20)
        jsv = jsvc.VBService(slice_iters=5, max_fleet=2)
        jr = jsv.submit(jreq)
        jsv.step_slice()
        jpath = jsv.save_session(jr, str(tmp_path / "jax.npz"))
        jwhole = np.asarray(jsv.run()[jr].phi)
        tsv = VBService(slice_iters=5, max_fleet=2, device="cpu")
        tr = tsv.submit(treq, restore_from=jpath)
        assert tsv.status(tr).t == 5
        tphi = tsv.run()[tr].phi.numpy()
        np.testing.assert_allclose(tphi, jwhole, rtol=CLOSE, atol=CLOSE)
        # the port's own mid-run file, resumed by the JAX service
        tsv2 = VBService(slice_iters=5, max_fleet=2, device="cpu")
        tr2 = tsv2.submit(treq)
        tsv2.step_slice()
        tpath = tsv2.save_session(tr2, str(tmp_path / "port.npz"))
        jsv2 = jsvc.VBService(slice_iters=5, max_fleet=2)
        jr2 = jsv2.submit(jreq, restore_from=tpath)
        assert jsv2.status(jr2).t == 5
        np.testing.assert_allclose(np.asarray(jsv2.run()[jr2].phi), jwhole,
                                   rtol=CLOSE, atol=CLOSE)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_background_thread_drain_and_autosaves(env, tmp_path):
    from repro_torch.checkpoint import ckpt

    ckpt_dir = str(tmp_path / "auto")
    svc = VBService(slice_iters=5, max_fleet=2, ckpt_dir=ckpt_dir,
                    ckpt_every=1, device="cpu")
    svc.start()
    rids = [svc.submit(VBRequest(model=env["mdl"], data=d,
                                 topology=engine.RingDiffusion(),
                                 n_iters=20)) for d in env["data"][:3]]
    svc.drain()
    svc.stop()
    assert svc.driver._thread is None
    stats = svc.stats()
    assert stats.checkpoints > 0 and stats.checkpoint_errors == 0
    for rid in rids:
        st = svc.status(rid)
        assert st.done and st.t == 20 and st.latency_s > 0.0
        assert os.path.exists(os.path.join(ckpt_dir, f"{rid}.npz"))
    path = svc.save_session(rids[0], str(tmp_path / "a.npz"), wait=False)
    svc.driver.flush_checkpoints()
    restored = ckpt.restore(path, svc.driver._finished[rids[0]]["record"])
    assert torch.equal(restored["phi"], svc.status(rids[0]).phi)
    assert int(restored["t"]) == 20 and restored["t"].dtype == torch.int32


def test_concurrent_submitters_with_background_thread(env):
    """Six threads submit and extend sessions while the background
    scheduler runs (a 2-slot fleet, a short switch interval): every
    session is admitted once, ends at its extended budget, and no count
    is lost."""
    import sys
    import threading

    svc = VBService(slice_iters=3, max_fleet=2, device="cpu")
    rids, lock = [], threading.Lock()

    def client(k):
        for j in range(2):
            rid = svc.submit(VBRequest(
                model=env["mdl"], data=env["data"][(k + j) % 5],
                topology=engine.RingDiffusion(), n_iters=4))
            svc.extend_budget(rid, 2)
            with lock:
                rids.append(rid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        svc.start()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        svc.drain()
    finally:
        svc.stop()
        sys.setswitchinterval(old)
    assert svc.driver._thread is None
    st = svc.stats()
    assert len(set(rids)) == 12 and st.queue_depth == 0
    assert st.admitted == st.evicted and st.admitted >= 12
    for rid in rids:
        s = svc.status(rid)
        assert s.done and s.evicted and s.t == s.budget == 6, rid


def test_redraw_bound_is_conservative():
    """`_redraw_possible`: exact for tol = 0 slots, the whole reachable
    range for tol > 0 ones, nothing for latched or spent slots."""
    f = drv._redraw_possible
    t0, budget = np.array([3]), np.array([100])
    conv, exact, loose = np.array([False]), np.array([0.0]), np.array([1.0])
    # n_chunks 4: t = 3 + j, epochs start at 4, 8, ...
    assert [f(t0, budget, conv, exact, j, 4) for j in range(6)] \
        == [False, True, False, False, False, True]
    assert all(f(t0, budget, conv, loose, j, 4) for j in range(1, 6))
    assert not f(t0, budget, np.array([True]), exact, 1, 4)
    assert not f(t0, np.array([4]), conv, exact, 1, 4)    # t = 4: spent
    assert not f(np.array([0]), budget, conv, exact, 0, 4)  # t = 0
