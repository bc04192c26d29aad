"""repro_torch.core.expfam / refperm against repro.core.expfam / refperm.

Random posteriors are drawn with numpy from a seed and fed to both
packages in float64; the port must agree to rtol 1e-10 (f64 rounding of
different but equivalent operation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expfam as jx
from repro.core import refperm as jref
from repro_torch.core import expfam as tx
from repro_torch.core import refperm as tref

RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _posteriors(K, D, n, seed):
    """n random in-domain posteriors as (list of numpy tuples)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        A = rng.normal(size=(K, D, D))
        W = np.einsum("kij,klj->kil", A, A) * 0.3 + 0.2 * np.eye(D)
        out.append((rng.uniform(0.5, 50.0, K), rng.normal(size=(K, D)) * 3,
                    rng.uniform(0.1, 40.0, K), W,
                    D - 1.0 + rng.uniform(0.5, 40.0, K)))
    return out


def _jq(p):
    return jx.GMMPosterior(*(jnp.asarray(a) for a in p))


def _tq(p):
    return tx.GMMPosterior(*(torch.from_numpy(a) for a in p))


def _stack(posts):
    """The posteriors as one batched numpy tuple (leading axis = draw)."""
    return tuple(np.stack(f) for f in zip(*posts))


def _jvmap(fn, *args):
    """The reference function vmapped over the leading draw axis (one
    compiled call instead of an eager dispatch per draw)."""
    return np.asarray(jax.jit(jax.vmap(fn))(*args))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


CASES = [(3, 2), (2, 5)]


@pytest.mark.parametrize("K,D", CASES)
def test_pack_unpack_round_trip(K, D):
    batch = _stack(_posteriors(K, D, 4, seed=K * 10 + D))
    jq, tq = jx.GMMPosterior(*batch), _tq(batch)
    jphi = _jvmap(jx.pack_natural, jq)
    tphi = tx.pack_natural(tq)                               # batched
    _close(tphi, jphi)
    _close(tx.nw_pack(tq), _jvmap(jx.nw_pack, jq))
    want = jax.jit(jax.vmap(lambda p: jx.unpack_natural(p, K, D)))(jphi)
    for a, b in zip(tx.unpack_natural(torch.from_numpy(jphi), K, D), want):
        _close(a, b, atol=1e-12)
    back = tx.pack_natural(tx.unpack_natural(tphi, K, D))
    _close(back, tphi, rtol=1e-9, atol=1e-9)
    assert tx.flat_dim(K, D) == jx.flat_dim(K, D) == tphi.shape[-1]
    np.testing.assert_array_equal(tx.block_labels(K, D),
                                  jx.block_labels(K, D))
    assert tx.BLOCK_NAMES == jx.BLOCK_NAMES


@pytest.mark.parametrize("K,D", CASES)
def test_project_and_in_domain(K, D):
    """Eq. 38b projection on points in and out of the domain.  eigh may
    order/sign eigenvectors differently; the returned reconstruction is
    invariant to that, so it is what is compared."""
    rng = np.random.default_rng(7 + K)
    phi = _jvmap(jx.pack_natural,
                 jx.GMMPosterior(*_stack(_posteriors(K, D, 3, seed=K + D))))
    bad = np.concatenate([phi + s * rng.normal(size=phi.shape)
                          for s in (0.0, 5.0, 50.0)])
    want = _jvmap(lambda p: jx.project_to_domain(p, K, D), bad)
    got = tx.project_to_domain(torch.from_numpy(bad), K, D)
    # a clamped beta (1e-6) blows n2 up to ~1e8: entries are compared
    # against their row's largest magnitude
    for g, w in zip(got, want):
        _close(g, w, atol=RTOL * np.abs(w).max())
    np.testing.assert_array_equal(
        tx.in_domain(torch.from_numpy(bad), K, D).numpy(),
        _jvmap(lambda p: jx.in_domain(p, K, D), bad))
    assert bool(tx.in_domain(got, K, D).all())


def _family_terms(m, q):
    """Log partitions and expected statistics of one posterior, through
    the expfam module `m` (either package)."""
    return (m.dirichlet_log_partition(q.alpha),
            m.dirichlet_expected_log(q.alpha),
            m.wishart_expected_logdet(q.W, q.nu),
            m.nw_log_partition(q), m.gmm_log_partition(q),
            m.expected_sufficient_stats(q))


@pytest.mark.parametrize("K,D", CASES)
def test_log_partitions_and_expected_stats(K, D):
    batch = _stack(_posteriors(K, D, 3, seed=3 * K + D))
    want = jax.jit(jax.vmap(lambda q: _family_terms(jx, q)))(
        jx.GMMPosterior(*batch))
    for g, w in zip(_family_terms(tx, _tq(batch)), want):
        _close(g, w)


@pytest.mark.parametrize("K,D", CASES)
def test_gmm_kl_flat_batched(K, D):
    """KL over a (nodes x references) grid in one broadcast call equals
    the reference's KL pair by pair."""
    phis = _jvmap(jx.pack_natural, jx.GMMPosterior(
        *_stack(_posteriors(K, D, 4, seed=11 * K + D))))
    got = tx.gmm_kl_flat(torch.from_numpy(phis)[:, None],
                         torch.from_numpy(phis)[None], K, D)
    want = jax.jit(jax.vmap(jax.vmap(
        lambda p, q: jx.gmm_kl_flat(p, q, K, D), (None, 0)), (0, None)))(
            phis, phis)
    _close(got, want, atol=1e-9)
    assert torch.all(got.diagonal().abs() < 1e-8)


@pytest.mark.parametrize("T", [7, 33, 100])
def test_ordered_sum_matches_and_is_padding_invariant(T):
    rng = np.random.default_rng(T)
    a = rng.normal(size=(T, 3, 2))
    got = tx.ordered_sum(torch.from_numpy(a))
    _close(got, jx.ordered_sum(jnp.asarray(a)), rtol=1e-12, atol=1e-13)
    for pad in (1, 31, 32, 200):
        padded = np.concatenate([a, np.zeros((pad, 3, 2))])
        assert torch.equal(tx.ordered_sum(torch.from_numpy(padded)), got)
    # the summed axis may be any axis
    moved = torch.from_numpy(np.moveaxis(a, 0, 1).copy())
    assert torch.equal(tx.ordered_sum(moved, dim=1), got)


def test_permuted_refs():
    p = _posteriors(3, 2, 1, seed=5)[0]
    want = jref.permuted_refs(_jq(p))
    got = tref.permuted_refs(_tq(p))
    assert got.shape == (6, tx.flat_dim(3, 2))
    _close(got, want)


def test_noninformative_prior():
    jp = jx.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0)
    tp = tx.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
