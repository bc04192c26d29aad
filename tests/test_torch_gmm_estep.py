"""The port's fused VBE step on the CPU (its plain PyTorch version) against
the reference kernel in Pallas interpret mode and its naive oracle.

Tolerances are those of tests/test_kernels.py: r atol 2e-5; R rtol 1e-4;
sum_x rtol 1e-4 / atol 5e-4; sum_xx rtol 1e-3 / atol 5e-3 (f32 products
summed in different orders).  The kernel itself runs only on a card:
tests/test_torch_kernels_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gmm_estep as tge
from repro_torch.kernels import ops as tops


def _args(N, T, K, D, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(N, T, D)) * 2).astype(np.float32)
    mask = (rng.random((N, T)) > 0.2).astype(np.float32)
    lp = rng.normal(size=(N, K)).astype(np.float32)
    A = rng.normal(size=(N, K, D, D)) * 0.3
    Wn = (np.einsum("nkij,nklj->nkil", A, A) + np.eye(D)).astype(np.float32)
    b = rng.normal(size=(N, K, D)).astype(np.float32)
    c = rng.uniform(1, 3, (N, K)).astype(np.float32)
    return x, mask, lp, Wn, b, c


def _check(got, want):
    r, R, sx, sxx = (None if g is None else g.numpy() for g in got)
    rr, RR, sxr, sxxr = (None if w is None else np.asarray(w, np.float32)
                         for w in want)
    if rr is not None:
        np.testing.assert_allclose(r, rr, atol=2e-5)
    np.testing.assert_allclose(R, RR, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sx, sxr, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(sxx, sxxr, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("T,K,D,block", [
    (100, 3, 2, 32),
    (257, 4, 5, 64),        # padding path
    (64, 2, 8, 64),
    (500, 6, 3, 128),
])
def test_sweep_against_interpret_kernel_and_oracle(T, K, D, block):
    """The four tests/test_kernels.py sweep shapes, single-node view."""
    a = [v[0] for v in _args(1, T, K, D)]
    got = tops.gmm_estep(*map(torch.from_numpy, a))
    _check(got, jops.gmm_estep(*map(jnp.asarray, a), block_t=block))
    _check(got, jref.gmm_estep(*map(jnp.asarray, a)))
    for g, p in zip(got, tge.gmm_estep_plain(*map(torch.from_numpy, a))):
        assert torch.equal(g, p)


@pytest.mark.parametrize("N,T,K,D,rep,return_r", [
    (3, 100, 32, 3, 1.0, True),        # the widest K the kernel is held to
    (5, 137, 4, 3, 8.0, False),        # replication applied at emit
])
def test_node_batched(N, T, K, D, rep, return_r):
    a = _args(N, T, K, D, seed=N)
    got = tops.gmm_estep_nodes(*map(torch.from_numpy, a), rep,
                               return_r=return_r)
    assert (got[0] is None) == (not return_r)
    want = jops.gmm_estep_nodes(*map(jnp.asarray, a), rep, block_t=32,
                                return_r=return_r)
    _check(got, want)
    rr, RR, sxr, sxxr = jref.gmm_estep_nodes(*map(jnp.asarray, a))
    _check(got, (rr if return_r else None, RR * rep, sxr * rep, sxxr * rep))


def test_bf16_x():
    """bf16 x and mask: both versions read the same bf16 values and
    accumulate in f32."""
    x, mask, *terms = _args(3, 120, 3, 2, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    mb = torch.from_numpy(mask).bfloat16()
    got = tops.gmm_estep_nodes(xb, mb, *map(torch.from_numpy, terms), 2.0)
    want = jops.gmm_estep_nodes(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(mb.float().numpy(), jnp.bfloat16),
        *map(jnp.asarray, terms), 2.0, block_t=32)
    _check(got, want)


def test_f64_x_is_cast_to_f32():
    x, mask, *terms = _args(2, 50, 3, 2, seed=4)
    t = list(map(torch.from_numpy, terms))
    got = tops.gmm_estep_nodes(torch.from_numpy(x).double(),
                               torch.from_numpy(mask).double(), *t)
    want = tops.gmm_estep_nodes(torch.from_numpy(x), torch.from_numpy(mask),
                                *t)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_padding_bit_invariance():
    """Trailing mask-zero rows leave the statistics bit-identical."""
    x, mask, *terms = map(torch.from_numpy, _args(3, 100, 4, 3, seed=5))
    base = tops.gmm_estep_nodes(x, mask, *terms, 3.0, return_r=False)
    for pad in (1, 28, 412):
        xp = torch.cat([x, torch.zeros(3, pad, 3)], 1)
        mp = torch.cat([mask, torch.zeros(3, pad)], 1)
        got = tops.gmm_estep_nodes(xp, mp, *terms, 3.0, return_r=False)
        for g, w in zip(got[1:], base[1:]):
            assert torch.equal(g, w)


def test_shift_gives_centred_statistics():
    """With a per-component shift s the step returns the statistics of
    y = x - s_k: R unchanged, sum r y = sum r x - R s, sum r y y^T the
    centred second moment; terms from estep_terms(q, shift=s) leave r
    unchanged.  Padding bit-invariance holds with a shift too."""
    from repro_torch.core import expfam, gmm
    rng = np.random.default_rng(6)
    N, T, K, D = 3, 150, 3, 2
    q = expfam.GMMPosterior(
        alpha=torch.tensor(rng.uniform(2, 9, (N, K))),
        m=torch.tensor(rng.uniform(1, 6, (N, K, D))),
        beta=torch.tensor(rng.uniform(5, 50, (N, K))),
        W=torch.eye(D, dtype=torch.float64).expand(N, K, D, D) * 0.1,
        nu=torch.tensor(rng.uniform(10, 60, (N, K))))
    x = torch.tensor(rng.uniform(0, 7, (N, T, D)), dtype=torch.float32)
    mask = torch.tensor(rng.random((N, T)) > 0.1, dtype=torch.float32)
    s = q.m.float()
    plain = [t.contiguous() for t in gmm.estep_terms(q, torch.float32)]
    cent = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=s)]
    r, R, sx, sxx = tops.gmm_estep_nodes(x, mask, *plain, 2.0)
    rc, Rc, sxc, sxxc = tops.gmm_estep_nodes(x, mask, *cent, 2.0, shift=s)
    np.testing.assert_allclose(rc, r, atol=2e-5)
    np.testing.assert_allclose(Rc, R, rtol=1e-4, atol=1e-4)
    want_sx = sx - R[..., None] * s
    np.testing.assert_allclose(sxc, want_sx, rtol=1e-3, atol=5e-3)
    want_sxx = (sxx - sx[..., :, None] * s[..., None, :]
                - s[..., :, None] * sx[..., None, :]
                + R[..., None, None] * s[..., :, None] * s[..., None, :])
    np.testing.assert_allclose(sxxc, want_sxx, rtol=1e-3, atol=5e-2)
    # the centred post-stage gives the uncentred posterior
    st = gmm.SuffStats(*(a.double() for a in (R, sx, sxx)))
    stc = gmm.SuffStats(*(a.double() for a in (Rc, sxc, sxxc)))
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0)
    for a, b in zip(gmm.posterior_from_stats(stc, prior, shift=s.double()),
                    gmm.posterior_from_stats(st, prior)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)
    xp = torch.cat([x, torch.zeros(N, 37, D)], 1)
    mp = torch.cat([mask, torch.zeros(N, 37)], 1)
    padded = tops.gmm_estep_nodes(xp, mp, *cent, 2.0, shift=s,
                                  return_r=False)
    for g, w in zip(padded[1:], (Rc, sxc, sxxc)):
        assert torch.equal(g, w)


def test_from_posterior_matches_core_vbe():
    from repro_torch.core import expfam, gmm
    rng = np.random.default_rng(1)
    q = expfam.noninformative_prior(3, 4, dtype=torch.float32)
    q = q._replace(m=torch.from_numpy(rng.normal(size=(3, 4)).astype(
        np.float32)), nu=torch.tensor([6.0, 7.0, 8.0]))
    x = torch.from_numpy((rng.normal(size=(200, 4)) * 2).astype(np.float32))
    mask = torch.ones(200)
    r, R, sx, sxx = tops.gmm_estep_from_posterior(x, mask, q)
    r2 = gmm.responsibilities(x, q, mask)
    st = gmm.sufficient_stats(x, r2, 1.0)
    np.testing.assert_allclose(r, r2, atol=3e-5)
    np.testing.assert_allclose(R, st.R, rtol=1e-4)
    np.testing.assert_allclose(sxx, st.sum_xx, rtol=1e-3, atol=1e-3)


def test_input_checks_raise():
    x, mask, lp, Wn, b, c = map(torch.from_numpy, _args(2, 64, 3, 2))
    launches = tops.gmm_estep_nodes.launches
    with pytest.raises(TypeError, match="x must be"):
        tops.gmm_estep_nodes(x.int(), mask, lp, Wn, b, c)
    with pytest.raises(TypeError, match="mask dtype"):
        tops.gmm_estep_nodes(x, mask.bfloat16(), lp, Wn, b, c)
    with pytest.raises(TypeError, match="Wn must be float32"):
        tops.gmm_estep_nodes(x, mask, lp, Wn.double(), b, c)
    with pytest.raises(ValueError, match="mask must be"):
        tops.gmm_estep_nodes(x, mask[:, :10], lp, Wn, b, c)
    with pytest.raises(ValueError, match="b must be"):
        tops.gmm_estep_nodes(x, mask, lp, Wn, b[:, :2], c)
    with pytest.raises(ValueError, match="shift must be"):
        tops.gmm_estep_nodes(x, mask, lp, Wn, b, c, shift=b[:1])
    with pytest.raises(ValueError, match="x must be contiguous"):
        xt = x.transpose(0, 1).contiguous().transpose(0, 1)
        tops.gmm_estep_nodes(xt, mask, lp, Wn, b, c)
    with pytest.raises(ValueError, match="block_t"):
        tops.gmm_estep_nodes(x, mask, lp, Wn, b, c, block_t=100)
    with pytest.raises(ValueError, match="D <= 8"):
        x9, m9, *t9 = map(torch.from_numpy, _args(1, 8, 2, 9))
        tops.gmm_estep_nodes(x9, m9, *t9)
    with pytest.raises(ValueError, match="shared memory"):
        x8, m8, *t8 = map(torch.from_numpy, _args(1, 8, 1200, 8))
        tops.gmm_estep_nodes(x8, m8, *t8)
    # the CPU path runs the plain version: no kernel launch is counted
    tops.gmm_estep_nodes(x, mask, lp, Wn, b, c)
    assert tops.gmm_estep_nodes.launches == launches
    assert tops.gmm_estep_nodes is tge.gmm_estep_nodes
