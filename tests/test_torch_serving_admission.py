"""Admission helpers of the VB serving stack against the JAX package:
`bucket_for`, `shape_signature`, `static_signature`, and the models'
fixed-capacity buffers (`pad_to_capacity`, `append_node_data`) for the
GMM and the linear-regression model.

Bars: signatures compare structurally (the same equalities hold between
the port's signatures as between the reference's, on the same numpy
arrays); padded and appended buffers are equal to the reference's, value
and dtype; a full buffer or a capacity below the current one raises
ValueError in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je
from repro.core import expfam as jx
from repro.core import linreg as jlin
from repro.core import model as jm
from repro.core import network as jn
from repro.serving import admission as jadm
from repro_torch.core import engine as te
from repro_torch.core import expfam as tx
from repro_torch.core import linreg as tlin
from repro_torch.core import model as tm
from repro_torch.serving import admission as tadm

K, D, N = 3, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are tiny, and a pool of threads
    synchronising on each small op runs ~10x slower when the suite's
    workers share the cores."""
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


def _trees(rng):
    """Pairs of (name, numpy tree): data trees of several layouts."""
    x = rng.normal(size=(4, 25, 2))
    m = np.ones((4, 25))
    return [
        ("gmm25", (x, m)),
        ("gmm32", (rng.normal(size=(4, 32, 2)), np.ones((4, 32)))),
        ("gmm33", (rng.normal(size=(4, 33, 2)), np.ones((4, 33)))),
        ("gmm25_nodes5", (rng.normal(size=(5, 25, 2)), np.ones((5, 25)))),
        ("gmm25_f32", (x.astype(np.float32), m.astype(np.float32))),
        ("linreg", (rng.normal(size=(4, 13, 3)), rng.normal(size=(4, 13)),
                    np.ones((4, 13)))),
        ("row", rng.normal(size=(25,))),
        ("stack", rng.normal(size=(4, 27))),
        ("int", (np.zeros((3,), np.int32),)),
    ]


@pytest.mark.parametrize("growth", [2.0, 1.25])
def test_shape_and_bucket_signatures_match_reference(growth):
    """Every pair of trees: the port's signatures are equal iff the
    reference's are, for `shape_signature` and `bucket_for` (capacity
    axis rounded, node and trailing axes kept)."""
    trees = _trees(np.random.default_rng(0))
    as_j = lambda tr: jax.tree_util.tree_map(jnp.asarray, tr)
    as_t = lambda tr: (tuple(_t(a) for a in tr) if isinstance(tr, tuple)
                       else _t(tr))
    for na, a in trees:
        for nb, b in trees:
            js = jadm.shape_signature(as_j(a)) == jadm.shape_signature(
                as_j(b))
            ts = tadm.shape_signature(as_t(a)) == tadm.shape_signature(
                as_t(b))
            assert js == ts, (na, nb)
            jb = jadm.bucket_for(jadm.shape_signature(as_j(a)),
                                 growth=growth) == jadm.bucket_for(
                jadm.shape_signature(as_j(b)), growth=growth)
            tb = tadm.bucket_for(tadm.shape_signature(as_t(a)),
                                 growth=growth) == tadm.bucket_for(
                tadm.shape_signature(as_t(b)), growth=growth)
            assert jb == tb, (na, nb)
    # the reference's own cases
    a = tadm.shape_signature((torch.zeros(4, 25, 2), torch.zeros(4, 25)))
    b = tadm.shape_signature((torch.zeros(4, 32, 2), torch.zeros(4, 32)))
    assert tadm.bucket_for(a) == tadm.bucket_for(b)
    # numpy arrays and tensors of one shape and dtype sign alike
    assert tadm.shape_signature((np.zeros((4, 25, 2)), np.zeros((4, 25)))) \
        == tadm.shape_signature((torch.zeros(4, 25, 2, dtype=torch.float64),
                                 torch.zeros(4, 25, dtype=torch.float64)))
    assert [tadm.bucket_capacity(n, growth=growth) for n in range(1, 70)] \
        == [jadm.bucket_capacity(n, growth=growth) for n in range(1, 70)]


def _topology_pairs(adj, W):
    """{name: make(package) -> configuration}: each maker builds a fresh
    object on each call."""
    W2 = np.array(W)
    W2[0, 0] += 1e-3
    big = np.zeros((1 << 14, 3))
    return {
        "diffusion_W": lambda p: p.Diffusion(np.array(W) if p is je
                                             else _t(W)),
        "diffusion_W2": lambda p: p.Diffusion(W2 if p is je else _t(W2)),
        "ring": lambda p: p.RingDiffusion(),
        "ring_drop": lambda p: p.RingDiffusion(link_drop=0.2, link_seed=3),
        "ring_drop_seed4": lambda p: p.RingDiffusion(link_drop=0.2,
                                                     link_seed=4),
        "admm_rho03": lambda p: p.ADMMConsensus(
            np.array(adj) if p is je else _t(adj), rho=0.3),
        "admm_rho09": lambda p: p.ADMMConsensus(
            np.array(adj) if p is je else _t(adj), rho=0.9),
        "admm_adaptive": lambda p: p.ADMMConsensus(
            np.array(adj) if p is je else _t(adj), adaptive_rho=True),
        "fusion": lambda p: p.FusionCenter(),
        "schedule": lambda p: p.Schedule(tau=0.3),
        "schedule_other": lambda p: p.Schedule(tau=0.1),
        "big": lambda p: big,
    }


@pytest.mark.parametrize("lifted", [False, True])
def test_static_signature_matches_reference(lifted):
    """Small arrays by content, large ones by identity, NamedTuples by
    value, `ignore` of the lifted attributes: for every pair of
    configurations (each built afresh per call, twice) the port's
    signatures are equal iff the reference's are."""
    adj, _ = jn.random_geometric_graph(N, seed=4)
    W = jn.nearest_neighbor_weights(adj)
    pairs = _topology_pairs(np.asarray(adj), np.asarray(W))

    def sig(mod, lib, name):
        obj = pairs[name](mod)
        ign = (mod.lifted_attr_names(obj)
               if lifted and hasattr(obj, "step") else ())
        return lib.static_signature(obj, ignore=ign)

    names = sorted(pairs)
    for a in names:
        for b in names:
            js = sig(je, jadm, a) == sig(je, jadm, b)
            ts = sig(te, tadm, a) == sig(te, tadm, b)
            assert js == ts, (a, b, js, ts)
    # lifted rho: the two ADMM penalties share a group only when ignored
    assert (sig(te, tadm, "admm_rho03") == sig(te, tadm, "admm_rho09")) \
        == lifted
    assert tadm.DIGEST_MAX_BYTES == jadm.DIGEST_MAX_BYTES
    # a tensor on the content side signs as the array of its bytes does
    small = np.arange(12.0).reshape(3, 4)
    assert tadm.static_signature(small) == tadm.static_signature(_t(small))
    # the same large tensor object signs equal to itself only
    big = torch.zeros(1 << 14, 3)
    assert tadm.static_signature(big) == tadm.static_signature(big)
    assert tadm.static_signature(big) != tadm.static_signature(big.clone())


def _gmm_models():
    prior = jx.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    tprior = tx.GMMPosterior(*(_t(v) for v in prior))
    return jm.GMMModel(prior, K, D), tm.GMMModel(tprior, K, D,
                                                  device="cpu")


def _linreg_models():
    Dl = 3
    return (jm.LinRegModel(jlin.prior(Dl)),
            tm.LinRegModel(tlin.prior(Dl, device="cpu"), device="cpu"))


def _data(kind, rng, T):
    mask = np.ones((N, T))
    mask[:, T - 4:] = 0.0                       # room for arrivals
    mask[2, T - 6:] = 0.0
    if kind == "gmm":
        return (rng.normal(size=(N, T, D)), mask)
    return (rng.normal(size=(N, T, 3)), rng.normal(size=(N, T)), mask)


def _points(kind, rng, m):
    if kind == "gmm":
        return rng.normal(size=(m, D))
    return (rng.normal(size=(m, 3)), rng.normal(size=(m,)))


def _equal(j_tree, t_tree):
    for a, b in zip(j_tree, t_tree):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("kind", ["gmm", "linreg"])
@pytest.mark.parametrize("capacity", [13, 16, 32])
def test_pad_to_capacity_matches_reference(kind, capacity):
    jmdl, tmdl = _gmm_models() if kind == "gmm" else _linreg_models()
    data = _data(kind, np.random.default_rng(capacity), 13)
    got = tmdl.pad_to_capacity(tuple(_t(a) for a in data), capacity)
    want = jmdl.pad_to_capacity(tuple(jnp.asarray(a) for a in data),
                                capacity)
    _equal(want, got)
    assert got[0].shape[1] == capacity
    with pytest.raises(ValueError, match="capacity"):
        tmdl.pad_to_capacity(tuple(_t(a) for a in data), 12)
    with pytest.raises(ValueError):
        jmdl.pad_to_capacity(tuple(jnp.asarray(a) for a in data), 12)


@pytest.mark.parametrize("kind", ["gmm", "linreg"])
@pytest.mark.parametrize("node,m", [(0, 1), (1, 3), (2, 6), (5, 4)])
def test_append_node_data_matches_reference(kind, node, m):
    """Points written into the node's first free mask-zero slots, the
    other nodes and the given buffers untouched; one point more than the
    free slots raises in both packages."""
    jmdl, tmdl = _gmm_models() if kind == "gmm" else _linreg_models()
    rng = np.random.default_rng(node * 10 + m)
    data = _data(kind, rng, 16)
    pts = _points(kind, rng, m)
    tdata = tuple(_t(a) for a in data)
    got = tmdl.append_node_data(tdata, node, pts)
    want = jmdl.append_node_data(tuple(jnp.asarray(a) for a in data), node,
                                 pts)
    _equal(want, got)
    for a, b in zip(tdata, data):               # the inputs stay as given
        np.testing.assert_array_equal(a.numpy(), b)
    free = int((data[-1][node] <= 0).sum())
    over = _points(kind, rng, free + 1)
    with pytest.raises(ValueError, match="buffer full"):
        tmdl.append_node_data(tdata, node, over)
    with pytest.raises(ValueError, match="buffer full"):
        jmdl.append_node_data(tuple(jnp.asarray(a) for a in data), node,
                              over)


def test_linreg_phi_star_stack_not_paddable():
    """A precomputed phi* stack has no sample axis: both packages refuse
    to pad it (the driver then keeps exact-signature grouping)."""
    jmdl, tmdl = _linreg_models()
    P = tlin.flat_dim(3)
    with pytest.raises(ValueError):
        tmdl.pad_to_capacity(torch.zeros(2, P, dtype=torch.float64), 16)
    with pytest.raises(ValueError):
        jmdl.pad_to_capacity(jnp.zeros((2, P)), 16)
    # a single point (1-D X row, scalar y) appends like a batch of one
    rng = np.random.default_rng(0)
    data = _data("linreg", rng, 8)
    one = (rng.normal(size=(3,)), 0.5)
    got = tmdl.append_node_data(tuple(_t(a) for a in data), 1, one)
    want = jmdl.append_node_data(tuple(jnp.asarray(a) for a in data), 1,
                                 one)
    _equal(want, got)
