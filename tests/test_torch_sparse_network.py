"""The port's sparse graph layer against repro.core.network's.

Both packages build graphs with the same numpy code and rng streams, so
the edge lists, degrees, positions and weights must be EXACTLY equal
(values; the port's index arrays are int64 where the reference's are
int32).  `random_geometric_edges` is the port's own cell-list constructor:
its positions, links and link order must be the reference's up to
N = 10,000 (the reference's block construction is too slow past that).  The
link coins are the port's counter-based hash: on `SparseGraph.ring` the
sparse coins must equal `ring_link_keep`'s bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import network as jn
from repro_torch.core import network as tn


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


FIELDS = ("senders", "receivers", "edge_id", "deg")


def _same_graph(got, want):
    assert (got.n_nodes, got.n_undirected) == (want.n_nodes,
                                               want.n_undirected)
    for f in FIELDS:
        a = getattr(got, f)
        assert a.dtype == torch.int64, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("N,seed", [(16, 3), (50, 4), (200, 1)])
def test_sparse_graph_arrays(N, seed):
    adj, _ = jn.random_geometric_graph(N, seed=seed)
    a = np.asarray(adj)
    g, tg = jn.SparseGraph.from_dense(a), tn.SparseGraph.from_dense(a)
    _same_graph(tg, g)
    np.testing.assert_array_equal(tg.to_dense(), g.to_dense())
    assert tg.to_dense().dtype == np.float64
    # from a torch adjacency too
    _same_graph(tn.SparseGraph.from_dense(torch.from_numpy(a.copy())), g)
    # from link lists in a given (coin) order
    rng = np.random.default_rng(seed)
    u, v = np.nonzero(np.triu(a, 1))
    perm = rng.permutation(u.size)
    _same_graph(tn.SparseGraph.from_undirected(v[perm], u[perm], N),
                jn.SparseGraph.from_undirected(v[perm], u[perm], N))
    _same_graph(tn.SparseGraph.ring(N), jn.SparseGraph.ring(N))
    moved = tg.to("cpu")
    _same_graph(moved, g)
    assert repr(tg) == repr(g)


@pytest.mark.parametrize("N,seed", [(50, 4), (1000, 0)])
def test_weight_rules_bit_equal(N, seed):
    g_j, _ = jn.random_geometric_edges(N, seed=seed)
    g_t, _ = tn.random_geometric_edges(N, seed=seed)
    for jw, tw in ((jn.sparse_nearest_neighbor_weights(g_j),
                    tn.sparse_nearest_neighbor_weights(g_t)),
                   (jn.sparse_metropolis_weights(g_j),
                    tn.sparse_metropolis_weights(g_t))):
        for f in ("w_edge", "w_self"):
            got, want = getattr(tw, f), np.asarray(getattr(jw, f))
            assert isinstance(got, np.ndarray) and got.dtype == np.float64
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert tw.graph is g_t


@pytest.mark.parametrize("n,g,r", [(6, 3, 2), (50, 8, 2), (50, 1, 1),
                                   (1000, 62, 7), (17, 17, 17)])
def test_two_level_partition(n, g, r):
    gw, rg = tn.two_level_partition(n, g, r)
    jgw, jrg = jn.two_level_partition(n, g, r)
    assert gw.dtype == rg.dtype == torch.int64
    np.testing.assert_array_equal(gw.numpy(), np.asarray(jgw))
    np.testing.assert_array_equal(rg.numpy(), np.asarray(jrg))


@pytest.mark.parametrize("N,seed", [(16, 3), (50, 0), (50, 7), (100, 1),
                                    (1000, 0), (1000, 5), (10_000, 0)])
def test_random_geometric_edges_match_reference(N, seed):
    """Positions, links and their (coin) order equal the reference's;
    at N <= 100 the edge set also equals the dense constructor's."""
    g, pos = jn.random_geometric_edges(N, seed=seed)
    tg, tpos = tn.random_geometric_edges(N, seed=seed)
    assert tpos.dtype == torch.float64
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    _same_graph(tg, g)
    if N <= 100:
        adj, _ = tn.random_geometric_graph(N, seed=seed)
        np.testing.assert_array_equal(tg.to_dense(), adj.numpy())


def test_random_geometric_edges_explicit_geometry():
    """Explicit side/radius (the radius an exact multiple of the square's
    side, points on cell borders) and a graph that needs retries."""
    for kw in (dict(side=4.0, radius=1.0, seed=2),
               dict(side=3.5, radius=0.8, seed=11),
               dict(side=1.0, radius=1.0, seed=0)):
        g, pos = jn.random_geometric_edges(60, **kw)
        tg, tpos = tn.random_geometric_edges(60, **kw)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
        _same_graph(tg, g)
    u, v = tn._radius_edges(np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0],
                                      [0.0, 1.0]]), 1.0)
    assert (u.tolist(), v.tolist()) == ([0, 0, 1], [1, 3, 2])


def test_random_geometric_edges_100k_connects_first_try():
    """The main path's graph: N = 100,000 at the default radius connects
    on the first sample (no retry), every node has a neighbour, and the
    mean degree is ~1.69 ln N."""
    g, pos = tn.random_geometric_edges(100_000, seed=0, max_tries=1)
    assert g.n_nodes == 100_000 and pos.shape == (100_000, 2)
    assert int(g.deg.min()) >= 1
    assert torch.equal(g.receivers, torch.sort(g.receivers).values)
    mean_deg = 2 * g.n_undirected / g.n_nodes
    assert 17.0 < mean_deg < 21.0


@pytest.mark.parametrize("drop", [0.0, 0.2, 0.5, 1.0])
def test_ring_coin_contract(drop):
    """On SparseGraph.ring(N) the sparse link coins are ring_link_keep's
    (coin k gates link (k, k+1 mod N)); both directions of a link read
    one coin; masks differ between iterations and seeds."""
    N = 37
    ring = tn.SparseGraph.ring(N)
    masks = []
    for seed in (0, 3):
        for t in (0, 1, 17):
            gen = tn.link_generator(seed, t, "cpu")
            keep = tn.sparse_link_keep(gen, ring.n_undirected, drop,
                                       torch.float64)
            assert keep.dtype == torch.float64 and keep.shape == (N,)
            assert torch.equal(keep, tn.ring_link_keep(gen, N, drop,
                                                       torch.float64))
            masks.append(keep)
            d = keep[ring.edge_id]
            # each undirected link appears twice with one coin
            for k in range(N):
                assert d[ring.edge_id == k].unique().numel() == 1
    if drop in (0.0, 1.0):
        assert all(torch.equal(m, masks[0]) for m in masks)
        assert float(masks[0].mean()) == 1.0 - drop
    else:
        assert len({tuple(m.tolist()) for m in masks}) == len(masks)


def test_reference_value_errors():
    cases = [
        (lambda m: m.SparseGraph.from_undirected([0, 1], [1, 1], 3),
         "self-loops"),
        (lambda m: m.SparseGraph.from_undirected([0, 1], [1, 0], 3),
         "duplicate"),
        (lambda m: m.SparseGraph.from_undirected([0], [3], 3), "node ids"),
        (lambda m: m.SparseGraph.from_undirected([0, 1], [1], 3),
         "equal-length"),
        (lambda m: m.SparseGraph.from_dense(np.triu(np.ones((3, 3)), 1)),
         "symmetric"),
        (lambda m: m.SparseGraph.ring(2), "ring needs"),
        (lambda m: m.two_level_partition(4, 5, 1), "regions"),
        (lambda m: m.two_level_partition(4, 2, 3), "regions"),
        (lambda m: m.two_level_partition(4, 2, 0), "regions"),
    ]
    for fn, match in cases:
        for mod in (jn, tn):
            with pytest.raises(ValueError, match=match):
                fn(mod)
    with pytest.raises(RuntimeError, match="connected"):
        tn.random_geometric_edges(50, radius=0.01, max_tries=2)
