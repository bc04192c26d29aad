"""Sessions and checkpoints: the port's save / restore / latest_step in
the reference's file format, `with_data`, and the per-session constants
(`session_step_fn`, `hyper_names`, `lifted_attr_names`, `session_hyper`).

Bars, each stated where it is checked:

* save -> restore -> continue on the port: bit for bit against the
  uninterrupted run (phi, every carry leaf, the diagnostics, the stream
  state, the Eq. 46 trajectory);
* across packages (a JAX checkpoint resumed in the port, a port
  checkpoint resumed by JAX): rtol 1e-9 against the other package's
  uninterrupted run (f64, reference backend: the f64 engine bar of
  tests/test_torch_engine.py), and the same keys, shapes and dtypes in
  both packages' files;
* `session_step_fn(hyper=...)` with other constants: bit for bit
  against a session built with those constants.
"""
import os
from types import SimpleNamespace

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
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import model as tm
from repro_torch.core import network as tn
from repro_torch.data import stream as tstream

K, D = 3, 2
TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _instance(n, n_per, graph_seed, init_seed=None):
    data = js.paper_synthetic(n_nodes=n, n_per_node=n_per, seed=2)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    adj, _ = jn.random_geometric_graph(n, seed=graph_seed)
    a = np.asarray(adj, np.float64)
    init_q = (prior if init_seed is None else ja._perturbed_init(
        prior, data.x, jax.random.PRNGKey(init_seed)))
    x_all, labels = data.flat
    ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels, prior,
                                                     K))
    jmdl = jm.GMMModel(prior, K, D)
    tprior = tx.GMMPosterior(*(_t(v) for v in prior))
    return SimpleNamespace(
        n=n, data=data, adj=a, jg=jn.SparseGraph.from_dense(a),
        tg=tn.SparseGraph.from_dense(a), jmdl=jmdl, ref=ref,
        phi0=jnp.broadcast_to(jx.pack_natural(init_q), (n, jmdl.flat_dim)),
        x=_t(data.x), mask=_t(data.mask), tprior=tprior, tref=_t(ref),
        tmdl=tm.GMMModel(tprior, K, D, device="cpu"),
        tphi0=_t(jx.pack_natural(init_q)).expand(n, jmdl.flat_dim))


@pytest.fixture(scope="module")
def inst():
    """tests/test_sparse_topology.py's instance: 50 x 20, prior start."""
    return _instance(50, 20, 4)


def _tsession(s, topo, **kw):
    if topo.uses_schedule and "schedule" not in kw:
        kw["schedule"] = te.Schedule()
    return te.vb_init(s.tmdl, (s.x, s.mask), topo, init_phi=s.tphi0,
                      ref_phi=s.tref, device="cpu", **kw)


def _jsession(s, topo, **kw):
    return je.vb_init(s.jmdl, (s.data.x, s.data.mask), topo,
                      init_phi=s.phi0, ref_phi=s.ref, **kw)


def _leaves(state):
    """Every array of a state, by key path (the checkpoint's view)."""
    return {k: v for k, v in tckpt._flatten(state).items()}


def _bit_equal_states(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def _configs(s):
    sw = tn.sparse_nearest_neighbor_weights(s.tg)
    gw, rg = tn.two_level_partition(s.n, 8, 2)
    return {
        "sparse_diffusion_drop": (lambda: te.Diffusion(
            sw, link_drop=0.3, link_seed=7), {}),
        "gossip": (lambda: te.PairwiseGossip(s.tg, p_activate=0.4,
                                             seed=11), {}),
        "hierarchical": (lambda: te.HierarchicalFusion(gw, rg), {}),
        "sparse_admm_adaptive_drop": (lambda: te.ADMMConsensus(
            s.tg, adaptive_rho=True, per_block=True, link_drop=0.2), {}),
        "stream_svrg": (lambda: te.Diffusion(sw), dict(
            minibatch=tstream.MinibatchSpec(6, 3, "svrg"))),
    }


@pytest.mark.parametrize("name", ["sparse_diffusion_drop", "gossip",
                                  "hierarchical",
                                  "sparse_admm_adaptive_drop",
                                  "stream_svrg"])
def test_save_restore_continue_bitexact(inst, tmp_path, name):
    """Save at t = 7 (mid-epoch for the stream: 4 windows an epoch),
    restore into a fresh session, run 8 more: the uninterrupted 15."""
    s = inst
    make, kw = _configs(s)[name]
    whole, run = te.vb_run(_tsession(s, make(), **kw), 15)
    part, run_a = te.vb_run(_tsession(s, make(), **kw), 7)
    path = tckpt.save(str(tmp_path), part, step=7)
    assert path.endswith("ckpt_00000007.npz") and os.path.exists(path)
    assert not os.path.exists(path + ".tmp")
    resumed = tckpt.restore(str(tmp_path), _tsession(s, make(), **kw),
                            step=7)
    _bit_equal_states(resumed, part)
    end, run_b = te.vb_run(resumed, 8)
    assert end.t == whole.t == 15
    _bit_equal_states(end, whole)
    assert torch.equal(run.kl_nodes, torch.cat([run_a.kl_nodes,
                                                run_b.kl_nodes]))
    if name == "stream_svrg":
        keys = tckpt.read_npz(path)
        assert keys[".stream.keys"].dtype == np.int64
        assert keys[".stream.keys"].shape == (s.n,)
        assert int(keys[".stream.epoch"]) == 1


@pytest.mark.parametrize("graph", ["dense", "sparse"])
def test_jax_adaptive_per_block_checkpoint_resumes(tmp_path, graph):
    """A JAX `ckpt.save` of an adaptive + per_block ADMM session at t = 7
    (its carry a 5-tuple, saved as .carry[0] ... .carry[4]) loaded in the
    port and run 8 more iterations equals the reference's uninterrupted
    15 iterations at 1e-9: phi, every carry leaf, every
    ConsensusDiagnostics field, kl_nodes."""
    s = _instance(8, 20, 4, init_seed=3)
    jtopo = lambda: je.ADMMConsensus(s.jg if graph == "sparse" else
                                     jnp.asarray(s.adj), adaptive_rho=True,
                                     per_block=True)
    ttopo = te.ADMMConsensus(s.tg if graph == "sparse" else _t(s.adj),
                             adaptive_rho=True, per_block=True)
    s7, _ = je.vb_run(_jsession(s, jtopo()), 7)
    path = jckpt.save(str(tmp_path / "admm_t7.npz"), s7)
    assert ".carry[4]" in tckpt.read_npz(path)
    s15, whole = je.vb_run(_jsession(s, jtopo()), 15)
    resumed = tckpt.load_reference_checkpoint(path, _tsession(s, ttopo))
    assert resumed.t == 7 and resumed.carry[4].dtype == torch.bool
    end, run = te.vb_run(resumed, 8)
    assert end.t == 15
    np.testing.assert_allclose(end.phi.numpy(), np.asarray(s15.phi),
                               rtol=TOL, atol=TOL)
    for i, (got, want) in enumerate(zip(end.carry, s15.carry)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=f"carry[{i}]")
    for f in te.ConsensusDiagnostics._fields:
        np.testing.assert_allclose(np.asarray(getattr(end.diag, f)),
                                   np.asarray(getattr(s15.diag, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_allclose(run.kl_nodes.numpy(),
                               np.asarray(whole.kl_nodes)[7:], rtol=TOL,
                               atol=TOL)
    arrays = tckpt.read_npz(path)
    del arrays[".carry[2]"]
    with pytest.raises(KeyError, match=r"\.carry\[2\]"):
        tckpt.state_from_arrays(arrays, _tsession(s, ttopo))


def test_port_checkpoint_resumed_by_jax(inst, tmp_path):
    """A port save of a sparse adaptive ADMM session (no link coins, no
    stream) at t = 7 has the keys, shapes and dtypes of JAX's own save
    (the diagnostics' counts: integers in both); JAX
    `ckpt.restore` loads it into a JAX `vb_init` state, and 8 more JAX
    iterations equal JAX's uninterrupted 15 at 1e-9."""
    s = inst
    make_j = lambda: je.ADMMConsensus(s.jg, adaptive_rho=True,
                                      per_block=True)
    t7, _ = te.vb_run(_tsession(s, te.ADMMConsensus(
        s.tg, adaptive_rho=True, per_block=True)), 7)
    path = tckpt.save(str(tmp_path / "port_t7.npz"), t7)
    j7, _ = je.vb_run(_jsession(s, make_j()), 7)
    jpath = jckpt.save(str(tmp_path / "jax_t7.npz"), j7)
    mine, theirs = tckpt.read_npz(path), tckpt.read_npz(jpath)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
        if k in (".diag.clip_count", ".diag.reset_count"):
            # JAX's step sums booleans into its default int (int64 under
            # x64; its init_diag holds int32, the port's int32 throughout)
            assert mine[k].dtype.kind == theirs[k].dtype.kind == "i", k
        else:
            assert mine[k].dtype == theirs[k].dtype, k
    restored = jckpt.restore(path, _jsession(s, make_j()))
    assert int(restored.t) == 7
    end, _ = je.vb_run(restored, 8)
    s15, _ = je.vb_run(_jsession(s, make_j()), 15)
    np.testing.assert_allclose(np.asarray(end.phi), np.asarray(s15.phi),
                               rtol=TOL, atol=TOL)
    for got, want in zip(jax.tree_util.tree_leaves(end.carry),
                         jax.tree_util.tree_leaves(s15.carry)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def test_latest_step(tmp_path):
    d = str(tmp_path / "ckpts")
    assert tckpt.latest_step(d) is None
    os.makedirs(d)
    assert tckpt.latest_step(d) is None
    tree = {"w": torch.arange(3.0)}
    for step in (3, 12, 7):
        tckpt.save(d, tree, step=step)
    open(os.path.join(d, "ckpt_00000099.npz.tmp"), "w").close()
    open(os.path.join(d, "notes.txt"), "w").close()
    assert tckpt.latest_step(d) == 12 == jckpt.latest_step(d)
    assert sorted(os.listdir(d))[:3] == ["ckpt_00000003.npz",
                                         "ckpt_00000007.npz",
                                         "ckpt_00000012.npz"]
    got = tckpt.restore(d, {"w": torch.zeros(3)}, step=tckpt.latest_step(d))
    assert torch.equal(got["w"], tree["w"])


def test_bf16_params_round_trip(tmp_path):
    """A params tree (dicts, a list of layers, bf16 and f32 leaves): port
    save -> port restore bit for bit; JAX restores the port's file and
    the port restores JAX's."""
    g = torch.Generator().manual_seed(0)
    tree = {"blocks": [{"wq": torch.randn(4, 6, generator=g).bfloat16(),
                        "norm": torch.randn(6, generator=g)}
                       for _ in range(2)],
            "embed": torch.randn(10, 4, generator=g).bfloat16()}
    path = tckpt.save(str(tmp_path / "params.npz"), tree)
    like = {"blocks": [{"wq": torch.zeros(4, 6, dtype=torch.bfloat16),
                        "norm": torch.zeros(6)} for _ in range(2)],
            "embed": torch.zeros(10, 4, dtype=torch.bfloat16)}
    back = tckpt.restore(path, like)
    for got, want in zip(tckpt._flatten(back).values(),
                         tckpt._flatten(tree).values()):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert set(tckpt.read_npz(path)) == {
        "['blocks'][0]['norm']", "['blocks'][0]['wq']",
        "['blocks'][1]['norm']", "['blocks'][1]['wq']", "['embed']"}
    jlike = jax.tree_util.tree_map(
        lambda t: jnp.zeros(t.shape, jnp.bfloat16 if t.dtype ==
                            torch.bfloat16 else jnp.float32), like)
    jback = jckpt.restore(path, jlike)
    for got, want in zip(jax.tree_util.tree_leaves(jback),
                         tckpt._flatten(tree).values()):
        assert np.array_equal(np.asarray(got, np.float32),
                              want.float().numpy())
        assert str(got.dtype) == str(want.dtype).removeprefix("torch.")
    jpath = jckpt.save(str(tmp_path / "jparams.npz"), jback)
    again = tckpt.restore(jpath, like)
    for got, want in zip(tckpt._flatten(again).values(),
                         tckpt._flatten(tree).values()):
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, {**like, "embed": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore(path, {**like, "head": torch.zeros(3)})


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_with_data_rebuilds_the_hot_path_copy(inst, backend):
    """A session moved onto new buffers mid-run computes on them: the same
    as a fresh session over the new data from the same state, bit for
    bit.  The session's cached copy of the data for the hot path
    (`stream_data`, f32 for the fused kernel) and the streaming mask are
    rebuilt; a stale copy would go on computing on the old buffers."""
    s = inst
    sw = tn.sparse_nearest_neighbor_weights(s.tg)
    mdl = tm.GMMModel(s.tprior, K, D, backend=backend, device="cpu")
    new_x = s.x.flip(1) * 1.1
    new_mask = s.mask.clone()
    new_mask[:, -3:] = 0.0
    for mb in (None, tstream.MinibatchSpec(6, 3)):
        def session(x, mask):
            return te.vb_init(mdl, (x, mask), te.Diffusion(sw),
                              schedule=te.Schedule(), init_phi=s.tphi0,
                              ref_phi=s.tref, minibatch=mb, device="cpu")
        st, _ = te.vb_run(session(s.x, s.mask), 5)
        moved = st.with_data((new_x, new_mask))
        assert moved.session.stream_data[0].data_ptr() != \
            st.session.stream_data[0].data_ptr()
        fresh = session(new_x, new_mask).session
        want = te.vb_run(st.replace(session=fresh), 6)[0]
        got = te.vb_run(moved, 6)[0]
        assert torch.equal(got.phi, want.phi)
        old = te.vb_run(st, 6)[0]
        assert not torch.equal(got.phi, old.phi)
    with pytest.raises(ValueError, match="shapes/dtypes"):
        st.with_data((s.x[:, :10], s.mask[:, :10]))
    with pytest.raises(ValueError, match="shapes/dtypes"):
        st.with_data((s.x.float(), s.mask))
    with pytest.raises(ValueError, match="no session"):
        st.replace(session=None).with_data((s.x, s.mask))


def _topology_pairs(s):
    """(JAX topology, port topology) for every topology kind."""
    gw, rg = jn.two_level_partition(s.n, 8, 2)
    tgw, trg = tn.two_level_partition(s.n, 8, 2)
    A = jnp.asarray(s.adj)
    return [
        (je.FusionCenter(), te.FusionCenter()),
        (je.Isolated(), te.Isolated()),
        (je.Diffusion(jn.nearest_neighbor_weights(A)),
         te.Diffusion(tn.nearest_neighbor_weights(_t(s.adj)))),
        (je.Diffusion(jn.sparse_nearest_neighbor_weights(s.jg)),
         te.Diffusion(tn.sparse_nearest_neighbor_weights(s.tg))),
        (je.RingDiffusion(), te.RingDiffusion()),
        (je.RingDiffusion(graph=jn.SparseGraph.ring(s.n)),
         te.RingDiffusion(graph=tn.SparseGraph.ring(s.n))),
        (je.PairwiseGossip(s.jg, p_activate=0.3),
         te.PairwiseGossip(s.tg, p_activate=0.3)),
        (je.HierarchicalFusion(gw, rg), te.HierarchicalFusion(tgw, trg)),
        (je.ADMMConsensus(A, rho=0.7, xi=0.02),
         te.ADMMConsensus(_t(s.adj), rho=0.7, xi=0.02)),
        (je.ADMMConsensus(s.jg, adaptive_rho=True, xi=0.03),
         te.ADMMConsensus(s.tg, adaptive_rho=True, xi=0.03)),
    ]


def test_hyper_helpers_equal_jax(inst):
    s = inst
    schedules = [(je.Schedule(), te.Schedule()),
                 (je.Schedule(tau=0.35, d0=2.0), te.Schedule(tau=0.35,
                                                            d0=2.0)),
                 (je.ONE_SHOT, te.ONE_SHOT),
                 (je.Schedule(eta_fixed=0.5), te.Schedule(eta_fixed=0.5))]
    for jtopo, ttopo in _topology_pairs(s):
        assert te.lifted_attr_names(ttopo) == je.lifted_attr_names(jtopo)
        for jsch, tsch in schedules:
            names = te.hyper_names(ttopo, tsch)
            assert names == je.hyper_names(jtopo, jsch)
            got = te.session_hyper(ttopo, tsch, torch.float64)
            want = je.session_hyper(jtopo, jsch, jnp.float64)
            assert tuple(got) == tuple(want) == names
            for k in names:
                assert got[k].dtype == torch.float64 and got[k].dim() == 0
                assert float(got[k]) == float(want[k])


def _with(topo, **kw):
    for k, v in kw.items():
        setattr(topo, k, v)
    return topo


def test_session_step_fn_hyper_bit_equal(inst):
    """Stepping with `hyper` set to other constants equals, bit for bit, a
    session built with those constants; hyper=None is `vb_run`."""
    s = inst
    sw = tn.sparse_nearest_neighbor_weights(s.tg)
    sched, other_sched = te.Schedule(), te.Schedule(tau=0.35, d0=2.0)
    cases = [   # (topology factory, the same with other constants)
        (lambda: te.Diffusion(sw), None),
        (lambda: te.PairwiseGossip(s.tg, p_activate=0.4, seed=2), None),
        (lambda: te.ADMMConsensus(s.tg),
         lambda: te.ADMMConsensus(s.tg, rho=0.8, xi=0.11)),
        # adaptive: rho lives in the carry, only xi is lifted
        (lambda: te.ADMMConsensus(s.tg, adaptive_rho=True, link_drop=0.2),
         lambda: te.ADMMConsensus(s.tg, adaptive_rho=True, link_drop=0.2,
                                  xi=0.11)),
    ]
    for make, make_other in cases:
        if make_other is None:                  # the schedule's tau, d0
            kw, kw_other, other = (dict(schedule=sched),
                                   dict(schedule=other_sched), make())
        else:
            kw, kw_other, other = {}, {}, make_other()
        state = _tsession(s, make(), **kw)
        built = te.vb_run(_tsession(s, other, **kw_other), 6)[0]
        hyper = te.session_hyper(other, kw_other.get("schedule", sched),
                                 torch.float64)
        fn = te.session_step_fn(state.session)
        for h, want in ((hyper, built.phi),
                        (None, te.vb_run(state, 6)[0].phi)):
            phi, carry, st = state.phi, state.carry, state.stream
            for t in range(6):
                phi, carry, st, _ = fn(state.session.data, phi, carry, st,
                                       t, hyper=h)
            assert torch.equal(phi, want), (type(other).__name__, h)
        # other buffers go through with_data: the same run on them
        data2 = (s.x * 0.9, s.mask)
        phi, carry, st = state.phi, state.carry, state.stream
        for t in range(3):
            phi, carry, st, _ = fn(data2, phi, carry, st, t)
        assert torch.equal(phi, te.vb_run(state.with_data(data2), 3)[0].phi)
