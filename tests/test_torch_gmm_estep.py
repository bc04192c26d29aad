"""The port's fused VBE step on the CPU (its plain PyTorch version) against
the reference kernel in Pallas interpret mode and its naive oracle, and
the wide-D kernel's schedule rendered in plain PyTorch.

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


def _check(got, want, r_atol=2e-5):
    r, R, sx, sxx = (None if g is None else g.numpy() for g in got)
    rr, RR, sxr, sxxr = (None if w is None else np.asarray(w, np.float32)
                         for w in want)
    if rr is not None:
        np.testing.assert_allclose(r, rr, atol=r_atol)
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
    with pytest.raises(ValueError, match="wide kernel's limit"):
        x9, m9, *t9 = map(torch.from_numpy, _args(1, 8, 13, 64))
        tops.gmm_estep_nodes(x9, m9, *t9)
    with pytest.raises(ValueError, match="shared memory"):
        x8, m8, *t8 = map(torch.from_numpy, _args(1, 8, 1200, 8))
        tops.gmm_estep_nodes(x8, m8, *t8)
    # the CPU path runs the plain version: no kernel launch is counted
    tops.gmm_estep_nodes(x, mask, lp, Wn, b, c)
    assert tops.gmm_estep_nodes.launches == launches
    assert tops.gmm_estep_nodes is tge.gmm_estep_nodes


# ---------------------------------------------------------------------------
# D > 8: the paper's real-data tables (Table II D = 34, Fig. 13 D = 52)
# ---------------------------------------------------------------------------
def WIDE_R_ATOL(D):
    """r's bar at dimension D: tests/test_kernels.py's 2e-5, which holds
    its D <= 8 sweep, scaled by D / 8 above it.  (On the card the wide
    kernel is held against an f64 evaluation instead: see chip_smoke.py's
    WIDE_VS_PLAIN.)"""
    return 2e-5 * max(1.0, D / 8)


@pytest.mark.parametrize("N,T,K,D", [
    (3, 17, 2, 34),       # Table II's node shape
    (2, 43, 6, 52),       # Fig. 13's K = 6 node shape
    (2, 70, 4, 52),       # more points than one wide-kernel tile
])
def test_wide_d_against_interpret_kernel(N, T, K, D):
    """The plain version at D = 34 / 52 against the Pallas kernel in
    interpret mode and its oracle, at the tests/test_kernels.py bars but
    for r's, which scales with D / 8 (WIDE_R_ATOL): log rho is a sum of
    D^2 f32 products, so its rounding, and r's (up to a quarter of it),
    grows with D (the centred form is held in
    test_wide_schedule_matches_plain)."""
    a = _args(N, T, K, D, seed=D + K)
    rep = 3.0
    got = tops.gmm_estep_nodes(*map(torch.from_numpy, a), rep)
    _check(got, jops.gmm_estep_nodes(*map(jnp.asarray, a), rep,
                                     block_t=32), WIDE_R_ATOL(D))
    rr, RR, sxr, sxxr = jref.gmm_estep_nodes(*map(jnp.asarray, a))
    _check(got, (rr, RR * rep, sxr * rep, sxxr * rep), WIDE_R_ATOL(D))


def _wide_schedule(x, mask, lp, Wn, b, c, rep=1.0, shift=None):
    """The wide kernel's schedule (csrc/gmm_estep.cu,
    gmm_estep_wide_kernel) rendered in plain PyTorch: per node, tiles of
    WIDE_TILE points held transposed with the constant-1 row at D; per
    component the Z = Y Wn_k column blocks and their row dots in f64; the
    masked softmax of log rho minus its largest (f64, then f32); f32
    statistics
    items (group, component, upper-triangle 4 x 4 block) in the kernel's
    item order over their group's points, tile sums added; the groups
    added in order; the emission's (i, j) lookup."""
    N, T, D = x.shape
    K = lp.shape[1]
    L = tge.wide_layout(K, D)
    Dp, nb, nbt, nbq, G = L["Dp"], L["nb"], L["nbt"], L["nbq"], L["groups"]
    TT = tge.WIDE_TILE
    tp = TT // G
    tri_of = {}
    for bi in range(nb):
        for bj in range(bi, nb):
            tri_of[bi, bj] = bi * nb - bi * (bi - 1) // 2 + (bj - bi)
    assert sorted(tri_of.values()) == list(range(nbt))
    rows = K + K * D + K
    stats = torch.zeros(N, rows, D)
    r_out = torch.zeros(N, T, K)
    for n in range(N):
        s = torch.zeros(K, Dp)
        if shift is not None:
            s[:, :D] = shift[n]
        acc = torch.zeros(G, K, nbt, 4, 4)
        for p0 in range(0, T, TT):
            cnt = min(TT, T - p0)
            xt = torch.zeros(Dp, TT)
            xt[D] = 1.0
            xt[:D, :cnt] = x[n, p0:p0 + cnt].float().T
            m = torch.zeros(TT)
            m[:cnt] = mask[n, p0:p0 + cnt].float()
            # log rho in f64; the softmax reads its differences to the
            # point's largest, rounded to f32
            lr = torch.zeros(K, TT, dtype=torch.float64)
            for k in range(K):
                Y = xt[:D].double() - s[k, :D, None].double()   # (D, TT)
                Wp = torch.zeros(D, 4 * nbq, dtype=torch.float64)
                Wp[:, :D] = Wn[n, k].double()
                q = torch.zeros(TT, dtype=torch.float64)
                cr = torch.zeros(TT, dtype=torch.float64)
                for eb in range(nbq):
                    z = Y.T @ Wp[:, 4 * eb:4 * eb + 4]          # (TT, 4)
                    e = torch.arange(4 * eb, min(4 * eb + 4, D))
                    q = q + (z[:, :len(e)] * Y[e].T).sum(1)
                    cr = cr + (Y[e].T * b[n, k, e].double()).sum(1)
                lr[k] = (lp[n, k].double()
                         - 0.5 * (q - 2.0 * cr + c[n, k].double()))
            ex = torch.exp((lr - lr.max(0).values).float())
            r = ex / ex.sum(0) * m                               # (K, TT)
            r_out[n, p0:p0 + cnt] = r[:, :cnt].T
            for w in range(G * K * nbt):                         # item order
                g, kt = divmod(w, K * nbt)
                k, rem = divmod(kt, nbt)
                bi = 0
                while rem >= nb - bi:
                    rem -= nb - bi
                    bi += 1
                bj = bi + rem
                assert tri_of[bi, bj] == kt % nbt
                t = slice(g * tp, (g + 1) * tp)
                yd = xt[4 * bi:4 * bi + 4, t] - s[k, 4 * bi:4 * bi + 4, None]
                ye = xt[4 * bj:4 * bj + 4, t] - s[k, 4 * bj:4 * bj + 4, None]
                acc[g, k, kt % nbt] += (r[k, t] * yd) @ ye.T
        tot = acc.sum(0)                                   # groups in order
        for row in range(rows):
            for col in range(D):
                if row < K:
                    k, i, j = row, col, D
                elif row < K + K * D:
                    k, d = divmod(row - K, D)
                    i, j = min(d, col), max(d, col)
                else:
                    k, i, j = row - K - K * D, D, D
                val = tot[k, tri_of[i // 4, j // 4], i % 4, j % 4]
                if row >= K + K * D and col != 0:
                    val = 0.0
                stats[n, row, col] = val * rep
    R = stats[:, K + K * D:, 0]
    return r_out, R, stats[:, :K], stats[:, K:K + K * D].reshape(N, K, D, D)


@pytest.mark.parametrize("N,T,K,D,centred", [
    (2, 17, 2, 34, True),        # Table II; two point groups
    (1, 43, 6, 52, False),       # Fig. 13 at K = 6
    (2, 130, 1, 9, True),        # K = 1, D = 9: sixteen groups, 3 tiles
    (1, 40, 224, 8, False),      # a K x D the shared path refuses
])
def test_wide_schedule_matches_plain(N, T, K, D, centred):
    """The wide kernel's tiling, item decoding, constant-1 row and
    emission, rendered in PyTorch, give the plain version's function at
    the tests/test_kernels.py bars."""
    assert tge.kernel_variant(K, D) == "wide"
    a = list(map(torch.from_numpy, _args(N, T, K, D, seed=K)))
    s = (torch.from_numpy(np.random.default_rng(1).normal(
        size=(N, K, D)).astype(np.float32)) if centred else None)
    got = _wide_schedule(*a, rep=2.0, shift=s)
    want = tge.gmm_estep_nodes_plain(*a, 2.0, shift=s)
    _check(got, want, WIDE_R_ATOL(D))


def test_wide_dispatch_and_limits():
    """D > 8 and the shapes past the shared path's memory go to the wide
    kernel, by (K, D) alone; past its own shared memory the wrapper
    raises, and FusedBackend.supports says no."""
    from repro_torch.core import backends, expfam
    from repro_torch.core import model as model_lib
    for K, D in ((2, 34), (2, 52), (4, 52), (6, 52), (10, 52), (1, 9),
                 (12, 64), (10, 68), (222, 8), (1200, 8)):
        assert tge.kernel_variant(K, D) == "wide", (K, D)
    assert tge.kernel_variant(221, 8) == "shared"
    for K, D in ((10, 52), (10, 64), (12, 64), (10, 68), (226, 8)):
        assert tge.supported(K, D), (K, D)
    for K, D in ((13, 64), (10, 69), (227, 8)):
        assert not tge.supported(K, D), (K, D)
    L = tge.wide_layout(2, 34)
    assert (L["Dp"], L["nb"], L["nbt"], L["nbq"], L["groups"]) == (
        36, 9, 45, 9, 2)
    assert tge.wide_layout(10, 52)["groups"] == 1
    assert tge.wide_layout(1, 1)["groups"] == tge.WIDE_MAX_GROUPS
    assert tge.wide_smem_bytes(10, 52) == 153104
    fb = backends.FusedBackend()
    for K, D, ok in ((2, 34, True), (6, 52, True), (13, 64, False)):
        mdl = model_lib.GMMModel(expfam.noninformative_prior(K, D),
                                 device="cpu")
        assert fb.supports(mdl) is ok, (K, D)


def test_wide_constants_mirror_the_source():
    """WIDE_THREADS, WIDE_TILE and WIDE_MAX_GROUPS are the CUDA source's
    kWideThreads, kWideTile and kWideMaxGroups."""
    import re
    from pathlib import Path
    src = (Path(tge.__file__).resolve().parent.parent / "csrc"
           / "gmm_estep.cu").read_text()
    for name, value in (("kWideThreads", tge.WIDE_THREADS),
                        ("kWideTile", tge.WIDE_TILE),
                        ("kWideMaxGroups", tge.WIDE_MAX_GROUPS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name


@pytest.mark.parametrize("K,D", [(2, 34), (4, 52)])
def test_fused_backend_runs_wide_d(K, D):
    """FusedBackend runs a D = 34 / 52 GMM (its CPU path: the plain
    version) and matches the reference backend's Eq. 46 trajectory at
    rtol/atol 1e-4 (tests/test_backends.py's bar), f64 iterates."""
    from repro_torch.core import algorithms, expfam, gmm, refperm
    from repro_torch.data import datasets
    data = (datasets.ionosphere_surrogate(n_nodes=20, seed=0) if D == 34
            else datasets.coil20_surrogate(K, n_nodes=10, seed=K))
    prior = expfam.noninformative_prior(K, D, beta0=0.05, w0_scale=5.0)
    x_all, lab = data.flat
    ref = refperm.permuted_refs(gmm.ground_truth_posterior(x_all, lab,
                                                           prior, K))
    u = np.random.default_rng(0).uniform(size=(K, D))
    init_q = algorithms.perturbed_init(prior, data.x, u)
    runs = [algorithms.run_dsvb(data.x, data.mask, torch.eye(data.x.shape[0])
                                * 0.5 + 0.5 / data.x.shape[0], prior,
                                n_iters=6, K=K, D=D, ref_phi=ref,
                                init_q=init_q, backend=be, device="cpu")
            for be in ("fused", "reference")]
    torch.testing.assert_close(runs[0].kl_mean, runs[1].kl_mean, rtol=1e-4,
                               atol=1e-4)
