"""repro_torch graphs, weights and synthetic data against the reference.

Both packages draw from the same seeded numpy streams, so graphs and data
must be EXACTLY equal.  One exception, stated where it is checked: the
diagonal of `metropolis_weights` is 1 - (a row sum), and XLA's association
order for that row sum is not specified, so it agrees to a few ulp.
"""
import jax
import numpy as np
import pytest

from repro.core import network as jn
from repro.data import synthetic as js
from repro_torch.core import network as tn
from repro_torch.data import synthetic as ts


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [8, 50, 200])
@pytest.mark.parametrize("seed", [0, 4])
def test_random_geometric_graph_and_weights(N, seed):
    adj, pos = jn.random_geometric_graph(N, seed=seed)
    tadj, tpos = tn.random_geometric_graph(N, seed=seed)
    _eq(tadj, adj)
    _eq(tpos, pos)
    _eq(tn.degrees(tadj), jn.degrees(adj))
    _eq(tn.nearest_neighbor_weights(tadj), jn.nearest_neighbor_weights(adj))
    want = np.asarray(jn.metropolis_weights(adj))
    got = tn.metropolis_weights(tadj).numpy()
    off = ~np.eye(N, dtype=bool)
    np.testing.assert_array_equal(got[off], want[off])
    np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                               atol=4 * np.finfo(np.float64).eps)
    np.testing.assert_allclose(tn.algebraic_connectivity(tadj),
                               jn.algebraic_connectivity(adj), rtol=1e-10)


def test_radius_rules_and_ring():
    for n in (2, 50, 1000, 10_000):
        side = tn._paper_side(n, None)
        assert side == jn._paper_side(n, None)
        assert tn.connectivity_radius(n, side) == \
            jn.connectivity_radius(n, side)
        assert tn._resolve_radius(n, side, None) == \
            jn._resolve_radius(n, side, None)
    assert tn._resolve_radius(50, 3.5, 1.1) == 1.1
    _eq(tn.ring_graph(7), jn.ring_graph(7))
    with pytest.raises(RuntimeError, match="connected"):
        tn.random_geometric_graph(30, radius=0.01, max_tries=2)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=50, n_per_node=100, seed=0),
    dict(n_nodes=12, n_per_node=30, seed=9, unequal_sizes=True,
         imbalanced=False),
    dict(n_nodes=10, n_per_node=64, seed=3, dtype=np.float32),
])
def test_paper_synthetic(kw):
    a, b = js.paper_synthetic(**kw), ts.paper_synthetic(**kw)
    for got, want in zip(b, a):
        _eq(got, want)
    for got, want in zip(b.flat, a.flat):
        _eq(got, want)


def test_gmm_data():
    pi = [0.2, 0.3, 0.5]
    mu = [[0.0, 0.0, 1.0], [3.0, -1.0, 0.0], [-2.0, 2.0, 2.0]]
    sigma = [np.eye(3) * s for s in (0.5, 1.0, 0.3)]
    a = js.gmm_data(6, 40, pi, mu, sigma, seed=1)
    b = ts.gmm_data(6, 40, pi, mu, sigma, seed=1)
    for got, want in zip(b, a):
        _eq(got, want)
