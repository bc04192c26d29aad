"""The port's streaming layer (repro_torch.data.stream, run_vb(minibatch=))
against repro.data.stream and repro.core.engine.

* The counter-based hash (core/network.py) against a numpy uint64 version
  of the same function written here: the link coins and the epoch
  permutations are pure integer functions, so they are equal exactly.
* The sampler's own contracts on the port's streams: permutations, the
  carried `advance` equal to the stateless `minibatch_select`, the
  identity gather at full batch, ragged-node scaling and the 5-standard-
  error unbiasedness test of tests/test_streaming.py at its size.
* Parity: `jax.random.permutation` cannot be reproduced, so the
  reference's permutations are injected through `MinibatchSpec.perm_fn`;
  the five estimators streamed (plain and SVRG) then match JAX
  `run_vb(minibatch=...)` on the reference backend in float64 at rtol
  1e-9 (the tests/test_engine.py instance, 8 nodes x 20 points), and the
  fused backend (plain kernel version on the CPU) matches the reference
  backend at rtol/atol 1e-4.  A reference checkpoint saved mid-epoch
  continues to the epoch's end at rtol 1e-9.  A bf16 stream rounds the
  scaled mask as the reference does.
* Full-batch specs are bit-identical to the full-batch run on every
  estimator and both backends, and a split run equals the whole run bit
  for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import algorithms as ja
from repro.core import backends as jb
from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import gmm as jg
from repro.core import model as jm
from repro.core import network as jn
from repro.core import refperm as jr
from repro.data import stream as jstream
from repro.data import synthetic as js
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import algorithms as ta
from repro_torch.core import backends as tb
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import linreg as tlin
from repro_torch.core import model as tm
from repro_torch.core import network as tn
from repro_torch.data import stream as tstream

K, D, N_NODES, N_PER, N_ITERS = 3, 2, 8, 20, 15
ESTIMATORS = ["cvb", "noncoop", "nsg_dvb", "dsvb", "dvb_admm"]
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: under the suite's six workers the
    default pool (a thread per core in each worker) oversubscribes the
    cores, and these small ops spend most of their time synchronising
    the pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the counter-based hash against numpy uint64
# ---------------------------------------------------------------------------
M32 = np.uint64(0xFFFFFFFF)


def _np_mix32(x):
    x = np.asarray(x, np.uint64) & M32
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & M32
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & M32
    return x ^ (x >> np.uint64(16))


def _np_absorb(h, *words):
    for w in words:
        h = _np_mix32(np.asarray(h, np.uint64)
                      ^ (np.asarray(w, np.uint64) & M32))
    return h


def _np_seed_state(seed):
    h = _np_mix32(np.uint64(seed & 0xFFFFFFFF) ^ np.uint64(0x9E3779B9))
    return _np_mix32(h ^ np.uint64((seed >> 32) & 0xFFFFFFFF))


def _np_hash32(seed, *words):
    return _np_mix32(_np_absorb(_np_seed_state(seed), *words))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3, -5])
def test_hash_matches_numpy_uint64(seed):
    rng = np.random.default_rng(abs(seed) + 1)
    words = rng.integers(0, 2 ** 32, (3, 500), dtype=np.uint64)
    got = tn.hash32(seed, *(torch.from_numpy(w.astype(np.int64))
                            for w in words))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  _np_hash32(seed, *words))
    assert int(tn.hash32(seed, 1, 2)) == int(_np_hash32(seed, 1, 2))
    # the link coins: coin i N + j of the (N, N) matrix, coin i of the ring
    n, t, drop = 9, 4, 0.35
    u = _np_hash32(seed, tn.STREAM_LINKS, t,
                   np.arange(n * n, dtype=np.uint64)).reshape(n, n)
    u = np.triu(u.astype(np.float64) / 2.0 ** 32, 1)
    keep = np.maximum((u + u.T >= drop).astype(np.float64), np.eye(n))
    gen = tn.link_generator(seed, t, "cpu")
    np.testing.assert_array_equal(
        tn.link_keep_matrix(gen, n, drop, torch.float64).numpy(), keep)
    ring = _np_hash32(seed, tn.STREAM_LINKS, t,
                      np.arange(n, dtype=np.uint64)) / 2.0 ** 32 >= drop
    np.testing.assert_array_equal(tn.ring_link_keep(gen, n, drop).numpy(),
                                  ring.astype(np.float32))
    # the epoch permutations: the stable sort of hash32(seed, PERMS, node,
    # epoch, slot) over the slots
    N, T, epoch = 5, 37, 3
    words = _np_hash32(seed, tn.STREAM_PERMS,
                       np.arange(N, dtype=np.uint64)[:, None], epoch,
                       np.arange(T, dtype=np.uint64)[None, :])
    want = np.argsort(words, axis=1, kind="stable")
    keys = tstream.node_keys(N, seed)
    np.testing.assert_array_equal(tstream.epoch_perms(keys, epoch, T).numpy(),
                                  want)


def test_epoch_perms_are_permutations():
    for seed, N, T in ((0, 4, 1), (3, 6, 20), (11, 3, 4096)):
        keys = tstream.node_keys(N, seed)
        seen = []
        for epoch in range(3):
            perm = tstream.epoch_perms(keys, epoch, T)
            assert perm.shape == (N, T) and perm.dtype == torch.int64
            assert torch.equal(perm.sort(1).values,
                               torch.arange(T).expand(N, T))
            seen.append(perm)
        if T > 4:        # epochs, nodes and seeds draw different orders
            assert not torch.equal(seen[0], seen[1])
            assert not torch.equal(seen[0][0], seen[0][1])
            assert not torch.equal(
                seen[0], tstream.epoch_perms(tstream.node_keys(N, seed + 1),
                                             0, T))


@pytest.mark.parametrize("B", [4, 5, 12])
def test_advance_equals_minibatch_select(B):
    """Over two epochs the carried sampler gives the stateless sampler's
    indices and masks exactly, and redraws only at an epoch change."""
    N, T = 5, 12
    mask = torch.from_numpy(
        (np.arange(T)[None] < np.array([3, 8, 12, 1, 10])[:, None])
        .astype(np.float64))
    keys = tstream.node_keys(N, 4)
    st = tstream.init_state(N, 4, T)
    n_chunks = -(-T // B)
    for t in range(2 * n_chunks):
        st_new, idx, mb = tstream.advance(st, mask, t, B)
        idx2, mb2 = tstream.minibatch_select(keys, mask, t, B)
        assert torch.equal(idx, idx2) and torch.equal(mb, mb2)
        assert st_new.epoch == t // n_chunks
        assert (st_new.perm is st.perm) == (st_new.epoch == st.epoch)
        st = st_new


def test_full_batch_degeneracy_is_identity_gather():
    x = torch.randn(4, 20, 2, dtype=torch.float64)
    mask = (torch.rand(4, 20) > 0.3).double()
    keys = tstream.node_keys(4, 7)
    idx, mb = tstream.minibatch_select(keys, mask, 5, 20)
    assert torch.equal(idx, torch.arange(20).expand(4, 20))
    assert torch.equal(mb, mask)
    mdl = tm.GMMModel(tx.noninformative_prior(K, D), device="cpu")
    xb, mbb = mdl.take_minibatch((x, mask), idx, mb)
    assert torch.equal(xb, x) and mbb is mb


def test_selection_scaling_on_ragged_nodes():
    """tests/test_streaming.py's ragged case on the port's streams: the
    windows of an epoch cover the slots (exactly once when B divides T),
    the indices are sorted, and every selected valid point weighs T/B."""
    n, T, B = 5, 12, 4
    n_valid = [3, 8, 12, 1, 10]
    mask = torch.from_numpy((np.arange(T)[None] < np.array(n_valid)[:, None])
                            .astype(np.float64))
    keys = tstream.node_keys(n, seed=1)
    seen = [[] for _ in range(n)]
    for t in range(T // B):
        idx, mb = tstream.minibatch_select(keys, mask, t, B)
        assert idx.shape == (n, B) and mb.shape == (n, B)
        for i, v in enumerate(n_valid):
            assert bool((idx[i].diff() >= 0).all())
            assert bool((idx[i][mb[i] > 0] < v).all())
            np.testing.assert_allclose(mb[i][mb[i] > 0].numpy(), T / B)
            seen[i].extend(idx[i].tolist())
    for i in range(n):
        assert sorted(seen[i]) == list(range(T))
    B2 = 5                 # wrapped windows still cover every slot
    seen2 = set()
    for t in range(-(-T // B2)):
        idx, _ = tstream.minibatch_select(keys, mask, t, B2)
        seen2.update(idx[0].tolist())
    assert seen2 == set(range(T))


# ---------------------------------------------------------------------------
# the tests/test_engine.py instance, both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inst():
    data = js.paper_synthetic(n_nodes=N_NODES, n_per_node=N_PER, seed=2)
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    adj, _ = jn.random_geometric_graph(N_NODES, seed=4)
    W = jn.nearest_neighbor_weights(adj)
    u = jax.random.uniform(jax.random.PRNGKey(3), (K, D), jnp.float64)
    init_q = ja._perturbed_init(prior, data.x, jax.random.PRNGKey(3))
    x_all, labels = data.flat
    ref = jr.permuted_refs(jg.ground_truth_posterior(x_all, labels, prior,
                                                     K))
    tprior = tx.GMMPosterior(*(_t(a) for a in prior))
    t_init = ta.perturbed_init(tprior, _t(data.x), np.asarray(u))
    j = dict(x=data.x, mask=data.mask, prior=prior, adj=adj, W=W, ref=ref,
             phi0=jnp.broadcast_to(jx.pack_natural(init_q),
                                   (N_NODES, jx.flat_dim(K, D))))
    t = dict(x=_t(data.x), mask=_t(data.mask), prior=tprior, adj=_t(adj),
             W=_t(W), ref=_t(ref),
             phi0=tx.pack_natural(t_init).expand(N_NODES, -1).clone())
    return j, t


def _estimator(pkg, est, a):
    """(topology, run_vb keywords) of an estimator (tests/test_streaming.py
    `_estimators`)."""
    E = je if pkg == "jax" else te
    return {
        "cvb": (E.FusionCenter(), dict(schedule=E.ONE_SHOT)),
        "noncoop": (E.Isolated(), dict(schedule=E.ONE_SHOT,
                                       replication=1.0)),
        "nsg_dvb": (E.Diffusion(a["W"]), dict(schedule=E.ONE_SHOT)),
        "dsvb": (E.Diffusion(a["W"]), dict(schedule=E.Schedule())),
        "dvb_admm": (E.ADMMConsensus(a["adj"]), {}),
    }[est]


def _ref_perms(seed, T=N_PER):
    """perm_fn handing the port the reference's epoch permutations."""
    keys = jstream.node_keys(N_NODES, seed)
    return lambda e: np.asarray(jstream._epoch_perms(
        keys, jnp.asarray(e, jnp.int32), T))


def _trun(t, est, backend="reference", n_iters=N_ITERS, **kw):
    topo, tkw = _estimator("torch", est, t)
    mdl = tm.GMMModel(t["prior"], K, D, backend=backend, device="cpu")
    return te.run_vb(mdl, (t["x"], t["mask"]), topo, n_iters=n_iters,
                     init_phi=t["phi0"], ref_phi=t["ref"], device="cpu",
                     **tkw, **kw)


@pytest.mark.parametrize("cv", [None, "svrg"])
@pytest.mark.parametrize("est", ESTIMATORS)
def test_streamed_estimators_match_reference(inst, est, cv):
    """B = 6 of 20 (epochs of 4 windows, the last wrapping) over 15
    iterations: four epochs, three SVRG anchor refreshes.  dVB-ADMM runs
    6 (two epochs, one refresh): its Eq. 38b eigen-clip is a
    discontinuous branch that this noisy trajectory reaches at t = 6, and
    ulp-level differences then flip it (tests/test_streaming.py keeps
    such runs short for the same reason); without the projection it runs
    the whole horizon."""
    j, t = inst
    seed, B = 5, 6
    n_iters = 6 if est == "dvb_admm" else N_ITERS
    topo, jkw = _estimator("jax", est, j)
    want = je.run_vb(jm.GMMModel(j["prior"], K, D), (j["x"], j["mask"]),
                     topo, n_iters=n_iters, init_phi=j["phi0"],
                     ref_phi=j["ref"],
                     minibatch=jstream.MinibatchSpec(B, seed, cv), **jkw)
    got = _trun(t, est, n_iters=n_iters, minibatch=tstream.MinibatchSpec(
        B, seed, cv, perm_fn=_ref_perms(seed)))
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi),
                               rtol=RTOL)
    np.testing.assert_allclose(got.kl_nodes.numpy(),
                               np.asarray(want.kl_nodes), rtol=RTOL)
    if est == "dvb_admm":
        for f in je.ConsensusDiagnostics._fields:
            np.testing.assert_allclose(
                getattr(got.consensus_diag, f).numpy(),
                np.asarray(getattr(want.consensus_diag, f)), rtol=RTOL)
        spec = dict(minibatch=jstream.MinibatchSpec(B, seed, cv))
        want = je.run_vb(jm.GMMModel(j["prior"], K, D), (j["x"], j["mask"]),
                         je.ADMMConsensus(j["adj"], project=False),
                         n_iters=N_ITERS, init_phi=j["phi0"], **spec)
        mdl = tm.GMMModel(t["prior"], K, D, device="cpu")
        got = te.run_vb(mdl, (t["x"], t["mask"]),
                        te.ADMMConsensus(t["adj"], project=False),
                        n_iters=N_ITERS, init_phi=t["phi0"], device="cpu",
                        minibatch=tstream.MinibatchSpec(
                            B, seed, cv, perm_fn=_ref_perms(seed)))
        np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi),
                                   rtol=RTOL)


@pytest.mark.parametrize("cv", [None, "svrg"])
@pytest.mark.parametrize("est", ESTIMATORS)
def test_streamed_fused_matches_reference_backend(inst, est, cv):
    """The port's own streams: the fused backend (f32 data, the kernel's
    plain version on the CPU) against the reference backend, on the nodes
    whose reference trajectory stays a posterior (every KL finite and
    >= 0).  Only noncoop-VB with SVRG leaves the domain here: without
    replication or a projection, phi*_B(phi) - phi*_B(anchor) + anchor
    takes four of the eight nodes out of it (negative and NaN KLs, in the
    JAX package too: ROADMAP R7), where f32 and f64 statistics then part
    beyond 1e-4."""
    _, t = inst
    spec = tstream.MinibatchSpec(6, 2, cv)
    a = _trun(t, est, "fused", minibatch=spec).kl_nodes.numpy()
    b = _trun(t, est, "reference", minibatch=spec).kl_nodes.numpy()
    posterior = (np.isfinite(b) & (b >= 0.0)).all(0)
    assert posterior.sum() >= (4 if (est, cv) == ("noncoop", "svrg")
                               else N_NODES)
    np.testing.assert_allclose(a[:, posterior], b[:, posterior], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("est", ESTIMATORS)
def test_full_batch_spec_is_bit_identical(inst, est, backend):
    """batch_size = capacity (or more, clamped) reproduces the full-batch
    run bit for bit, plain and with SVRG requested (its anchors are then
    absent)."""
    _, t = inst
    full = _trun(t, est, backend, n_iters=8)
    for spec in (tstream.MinibatchSpec(N_PER, 3),
                 tstream.MinibatchSpec(N_PER + 7, 3, "svrg")):
        got = _trun(t, est, backend, n_iters=8, minibatch=spec)
        assert torch.equal(got.phi, full.phi)
        assert torch.equal(got.kl_nodes, full.kl_nodes)


def test_minibatch_phi_star_is_unbiased(inst):
    """tests/test_streaming.py's Monte Carlo test on the port's streams:
    the seed-averaged minibatch phi* lies within 5 standard errors of the
    full-batch phi* on every coordinate."""
    _, t = inst
    mdl = tm.GMMModel(t["prior"], K, D, device="cpu")
    data, phi0, rep = (t["x"], t["mask"]), t["phi0"], float(N_NODES)
    full = mdl.local_optimum(data, phi0, rep)
    B, n_seeds = 10, 400
    acc = torch.zeros_like(full)
    acc2 = torch.zeros_like(full)
    for s in range(n_seeds):
        idx, mb = tstream.minibatch_select(tstream.node_keys(N_NODES, s),
                                           t["mask"], 0, B)
        p = mdl.local_optimum(mdl.take_minibatch(data, idx, mb), phi0, rep)
        acc += p
        acc2 += p * p
    mean = acc.numpy() / n_seeds
    var = np.maximum(acc2.numpy() / n_seeds - mean ** 2, 0.0)
    se = np.sqrt(var / n_seeds)
    dev = np.abs(mean - full.numpy())
    assert np.all(dev <= 5.0 * se + 1e-9 * (np.abs(full.numpy()) + 1.0)), \
        float(np.max(dev / (se + 1e-12)))
    assert np.median(se / (np.abs(full.numpy()) + 1.0)) < 0.05


@pytest.mark.parametrize("cv", [None, "svrg"])
def test_split_run_bit_equal(inst, cv):
    """vb_run(s, 5 + 9) == vb_run(vb_run(s, 5), 9) across epoch changes
    and SVRG anchor refreshes, on dSVB and dVB-ADMM."""
    _, t = inst
    for est in ("dsvb", "dvb_admm"):
        topo, kw = _estimator("torch", est, t)

        def start():
            return te.vb_init(
                tm.GMMModel(t["prior"], K, D, device="cpu"),
                (t["x"], t["mask"]), topo, init_phi=t["phi0"],
                ref_phi=t["ref"], device="cpu",
                minibatch=tstream.MinibatchSpec(6, 1, cv), **kw)

        whole, run = te.vb_run(start(), 14)
        half, r1 = te.vb_run(start(), 5)
        split, r2 = te.vb_run(half, 9)
        assert torch.equal(whole.phi, split.phi)
        assert torch.equal(run.kl_nodes, torch.cat([r1.kl_nodes,
                                                    r2.kl_nodes]))
        assert whole.stream.epoch == split.stream.epoch == 13 // 4
        assert torch.equal(whole.stream.perm, split.stream.perm)
        if cv == "svrg":
            assert torch.equal(whole.stream.anchor_full,
                               split.stream.anchor_full)
        else:
            assert whole.stream.anchor_phi is None
        assert torch.equal(te.vb_step(start()).phi,
                           te.vb_run(start(), 1)[0].phi)


def test_resume_reference_checkpoint_mid_epoch(inst, tmp_path):
    """A JAX SVRG streaming session saved at t = 5 (mid-epoch 1 of windows
    of 6 of 20 points: epoch 1 is t = 4..7) resumes in the port with the
    reference's permutation and anchors, and runs to the epoch's end equal
    to the reference's uninterrupted run at rtol 1e-9."""
    j, t = inst
    spec = jstream.MinibatchSpec(6, 9, "svrg")
    mdl = jm.GMMModel(j["prior"], K, D)

    def jsession():
        return je.vb_init(mdl, (j["x"], j["mask"]), je.Diffusion(j["W"]),
                          init_phi=j["phi0"], ref_phi=j["ref"],
                          minibatch=spec)

    s5, _ = je.vb_run(jsession(), 5)
    path = jckpt.save(str(tmp_path / "svrg_t5.npz"), s5)
    s8, whole = je.vb_run(jsession(), 8)

    like = te.vb_init(tm.GMMModel(t["prior"], K, D, device="cpu"),
                      (t["x"], t["mask"]), te.Diffusion(t["W"]),
                      init_phi=t["phi0"], ref_phi=t["ref"], device="cpu",
                      minibatch=tstream.MinibatchSpec(6, 9, "svrg"))
    resumed = tckpt.load_reference_checkpoint(path, like)
    assert resumed.t == 5 and resumed.stream.epoch == 1
    np.testing.assert_array_equal(resumed.stream.perm.numpy(),
                                  np.asarray(s5.stream.perm))
    end, run = te.vb_run(resumed, 3)
    np.testing.assert_allclose(end.phi.numpy(), np.asarray(s8.phi),
                               rtol=RTOL)
    np.testing.assert_allclose(run.kl_nodes.numpy(),
                               np.asarray(whole.kl_nodes)[5:], rtol=RTOL)
    np.testing.assert_allclose(end.stream.anchor_full.numpy(),
                               np.asarray(s8.stream.anchor_full), rtol=RTOL)
    arrays = tckpt.read_npz(path)
    del arrays[".stream.perm"]
    with pytest.raises(KeyError, match="stream.perm"):
        tckpt.state_from_arrays(arrays, like)


def test_minibatch_api_validation(inst):
    _, t = inst
    mdl = tm.GMMModel(t["prior"], K, D, device="cpu")
    data, topo = (t["x"], t["mask"]), te.Diffusion(t["W"])
    with pytest.raises(ValueError, match="batch_size"):
        te.vb_init(mdl, data, topo, minibatch=tstream.MinibatchSpec(0),
                   device="cpu")
    with pytest.raises(ValueError, match="control_variate"):
        te.vb_init(mdl, data, topo, device="cpu",
                   minibatch=tstream.MinibatchSpec(4, control_variate="saga"))

    class _NoStream:
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="take_minibatch"):
        te.vb_init(_NoStream(), data, topo, device="cpu", init_phi=t["phi0"],
                   minibatch=tstream.MinibatchSpec(4))
    s = te.vb_init(mdl, data, topo, device="cpu",
                   minibatch=tstream.MinibatchSpec(10 ** 6, 0, "svrg"))
    assert s.session.minibatch.batch_size == N_PER
    assert s.stream.anchor_phi is None
    # LinRegModel streams raw data but refuses a precomputed phi* stack
    lr = tm.LinRegModel(tlin.prior(2), device="cpu")
    phi_star = torch.stack([lr.init_phi() + 1.0, lr.init_phi() - 1.0])
    with pytest.raises(ValueError, match="phi\\* stack"):
        te.run_vb(lr, phi_star, te.FusionCenter(), n_iters=2,
                  schedule=te.ONE_SHOT, device="cpu",
                  minibatch=tstream.MinibatchSpec(4))


def test_linreg_streaming_full_batch_parity():
    """tests/test_streaming.py's linear-regression case: full batch bit
    for bit, a small batch finite."""
    rng = np.random.default_rng(1)
    Dl, n, ni = 3, 6, 15
    X = torch.from_numpy(rng.normal(size=(n, ni, Dl)))
    y = X @ torch.from_numpy(rng.normal(size=Dl)) + torch.from_numpy(
        rng.normal(size=(n, ni))) * 0.3
    mask = torch.ones(n, ni, dtype=torch.float64)
    lr = tm.LinRegModel(tlin.prior(Dl), device="cpu")
    kw = dict(n_iters=5, schedule=te.ONE_SHOT, device="cpu")
    a = te.run_vb(lr, (X, y, mask), te.FusionCenter(), **kw)
    b = te.run_vb(lr, (X, y, mask), te.FusionCenter(),
                  minibatch=tstream.MinibatchSpec(batch_size=ni), **kw)
    assert torch.equal(a.phi, b.phi)
    c = te.run_vb(lr, (X, y, mask), te.FusionCenter(),
                  minibatch=tstream.MinibatchSpec(batch_size=5), **kw)
    assert bool(torch.isfinite(c.phi).all())
    assert not torch.equal(c.phi, a.phi)


def test_bf16_stream_rounds_the_scaled_mask_as_the_reference(inst):
    """Under PrecisionPolicy(data_dtype=bf16) the scaled mask is cast to
    bf16 with x, as in the reference: T/B = 20/6 becomes 3.328125 (ROADMAP
    R8).  The port's fused local optimum on a streamed minibatch matches
    the JAX fused backend's (Pallas kernel in interpret mode, f64
    post-stage) at 1e-4, and an unrounded weight would not."""
    j, t = inst
    B = 6
    idx, mb = tstream.minibatch_select(tstream.node_keys(N_NODES, 0),
                                       t["mask"], 1, B)
    assert float(mb.max()) == N_PER / B
    assert float(mb.max().to(torch.bfloat16)) == 3.328125
    xb = torch.gather(t["x"], 1, idx[..., None].expand(-1, -1, D))
    policy = tb.PrecisionPolicy(data_dtype=torch.bfloat16)
    mdl = tm.GMMModel(t["prior"], K, D, device="cpu",
                      backend=tb.FusedBackend(precision=policy))
    got = mdl.local_optimum(
        mdl.take_minibatch((t["x"], t["mask"]), idx, mb), t["phi0"], 8.0)
    jpolicy = jb.PrecisionPolicy(data_dtype=jnp.bfloat16,
                                 accum_dtype=jnp.float64,
                                 out_dtype=jnp.float64)
    want = jm.GMMModel(j["prior"], K, D,
                       backend=jb.FusedBackend(precision=jpolicy)
                       ).local_optimum((jnp.asarray(xb.numpy()),
                                        jnp.asarray(mb.numpy())),
                                       j["phi0"], 8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    exact = tm.GMMModel(t["prior"], K, D, device="cpu", backend="fused"
                        ).local_optimum((xb.to(torch.bfloat16).float(), mb),
                                        t["phi0"], 8.0)
    assert not np.allclose(exact.numpy(), np.asarray(want), rtol=1e-4,
                           atol=1e-4)
