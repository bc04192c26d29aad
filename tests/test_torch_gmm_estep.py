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
    # K=13 at D=64 (past the first wide kernel's shared memory) is taken
    x9, m9, *t9 = map(torch.from_numpy, _args(1, 8, 13, 64))
    assert tops.gmm_estep_nodes(x9, m9, *t9)[1].shape == (1, 13)
    # K=1200 at D=8 goes to the wide kernel, which takes it; the shared
    # path still raises past a block's shared memory (a caller's block_t)
    x8, m8, *t8 = map(torch.from_numpy, _args(1, 8, 1200, 8))
    assert tops.gmm_estep_nodes(x8, m8, *t8)[1].shape == (1, 1200)
    with pytest.raises(ValueError, match="shared memory"):
        x8, m8, *t8 = map(torch.from_numpy, _args(1, 8, 221, 8))
        tops.gmm_estep_nodes(x8, m8, *t8, block_t=1024)
    # the CPU path runs the plain version: no kernel launch is counted
    tops.gmm_estep_nodes(x, mask, lp, Wn, b, c)
    assert tops.gmm_estep_nodes.launches == launches
    # ops wraps the kernel module's wrapper (kernel telemetry) and reads
    # its launch count through
    assert tops.gmm_estep_nodes.__wrapped__ is tge.gmm_estep_nodes
    assert tops.gmm_estep_nodes.launches is tge.gmm_estep_nodes.launches


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


def _wide_u(W, b, c, s, P):
    """U_k as the prep launch builds it, in f64: M = [[W, -v], [-v^T, cc]]
    with v = (W + W^T) s / 2 + b and cc = s^T W s + 2 s.b + c (so that
    x'^T M x' = y^T W y - 2 y.b + c for y = x - s), folded onto the 8 x 8
    blocks on and above the diagonal (M_ij + M_ji above it), padded to
    (8 nS, 8 nJ)."""
    D = W.shape[0]
    Dq, nS, nJ = P["Dq"], P["nS"], P["nJ"]
    W, s, b = W.double(), s.double(), b.double()
    v = 0.5 * ((W + W.T) @ s) + b
    cc = float(c) + float(s @ (W @ s)) + 2.0 * float(s @ b)
    M = torch.zeros(Dq, Dq, dtype=torch.float64)
    M[:D, :D] = W
    M[:D, D] = M[D, :D] = -v
    M[D, D] = cc
    blk = torch.arange(Dq) // 8
    U = torch.zeros(8 * nS, 8 * nJ, dtype=torch.float64)
    U[:Dq, :Dq] = torch.where(blk[:, None] < blk[None, :], M + M.T,
                              torch.where(blk[:, None] == blk[None, :], M,
                                          torch.zeros(())))
    for J in range(nJ):     # the fragments hold every nonzero of column J
        assert not U[8 * (J + 1):, 8 * J:8 * J + 8].any()
    return U


def _wide_quad(Xt, U, P):
    """q = x'^T U x' of a tile's points: per chunk of WIDE_STEPS k-steps
    of 8 coordinates and column block J (k-steps 0 .. J), Z over its
    k-steps in the chunk on two accumulators (even and odd k-steps; each
    k-step one m16n8k8 product per 16 points), the row dot with x', the
    chunks added in order."""
    nS, nJ = P["nS"], P["nJ"]
    q = torch.zeros(Xt.shape[0], dtype=torch.float64)
    for sc in range(0, nS, tge.WIDE_STEPS):
        se = min(nS, sc + tge.WIDE_STEPS)
        part = torch.zeros_like(q)
        for J in range(sc, nJ):
            z = [torch.zeros(Xt.shape[0], 8, dtype=torch.float64)
                 for _ in range(2)]
            for i, st in enumerate(range(sc, min(J + 1, se))):
                z[i % 2] += (Xt[:, 8 * st:8 * st + 8]
                             @ U[8 * st:8 * st + 8, 8 * J:8 * J + 8])
            part += ((z[0] + z[1]) * Xt[:, 8 * J:8 * J + 8]).sum(1)
        q = part if sc == 0 else q + part
    return q


def _butterfly(parts, op):
    """The xor butterfly over a point's threads (every lane ends equal)."""
    parts = list(parts)
    o = 1
    while o < len(parts):
        parts = [op(parts[h], parts[h ^ o]) for h in range(len(parts))]
        o *= 2
    return parts[0]


def _wide_chunks(nbi, tp):
    """A block's items over its warps (wide_chunks in the source):
    nchunk chunks of csz items (at most WIDE_ITEMS), each over G point
    groups, nchunk G <= warps; the least work for the busiest warp, then
    the fewest warps."""
    warps = tge.WIDE_THREADS // 32
    best = None
    for nc in range(-(-nbi // tge.WIDE_ITEMS), warps + 1):
        cs = -(-nbi // nc)
        if (nc - 1) * cs >= nbi:
            continue
        g = 1
        while 2 * g * nc <= warps and 2 * g <= tp // 16:
            g *= 2
        work = cs * (tp // 16 // g)
        if best is None or work < best[0]:
            best = (work, nc, cs, g)
    return best[1:]


def _wide_schedule(x, mask, lp, Wn, b, c, rep=1.0, shift=None):
    """The wide path's schedule (csrc/gmm_estep.cu: the prep, fused or
    lse + split, and emit launches) rendered in plain PyTorch: the plan's
    tiles, U's fragments on the blocks on or above the 8 x 8 diagonal and
    the padding to the m16n8k4 shapes, the quadratic form's k-step chunks
    and accumulators, the softmax over each point's tpp threads (lane h
    takes components h, h + tpp, ...; online over chunks of kq components
    in the lse launch), the blocks' items, their chunks and point groups,
    the groups added in order, and the emit's centring in f64.  What it
    pins is the indexing and the order around each DMMA product, not the
    product's own bits (its internal order is the hardware's)."""
    N, T, D = x.shape
    K = lp.shape[1]
    P = tge.wide_plan(K, D, x.element_size())
    tp, Dq, nJ, nI = P["tp"], P["Dq"], P["nJ"], P["nI"]
    tpp = tge.WIDE_THREADS // tp
    warps = tge.WIDE_THREADS // 32
    items = [(I, J) for I in range(nI) for J in range(2 * I, nJ)]
    assert len(items) == P["nitems"]
    s_all = shift if shift is not None else torch.zeros(N, K, D)
    r_out = torch.zeros(N, T, K)
    stats = torch.zeros(N, K + K * D + K, D)
    ntiles = -(-T // tp)
    for n in range(N):
        U = [_wide_u(Wn[n, k], b[n, k], c[n, k], s_all[n, k], P)
             for k in range(K)]
        tiles = []
        for i in range(ntiles):
            Xt = torch.zeros(tp, 16 * nI, dtype=torch.float64)
            v = min(tp, T - i * tp)
            Xt[:v, :D] = x[n, i * tp:i * tp + v].double()
            Xt[:, D] = 1.0
            m = torch.zeros(tp)
            m[:v] = mask[n, i * tp:i * tp + v].float()
            tiles.append((Xt, m, v))

        def lr_of(k, Xt):
            return float(lp[n, k]) - 0.5 * _wide_quad(Xt, U[k], P)

        if P["nby"] > 1:                  # the lse launch
            lse = []
            for Xt, m, v in tiles:
                mx = torch.full((tp,), -torch.inf, dtype=torch.float64)
                den = torch.zeros(tp)
                for c0 in range(0, K, P["kq"]):
                    ks = range(c0, min(K, c0 + P["kq"]))
                    lr = {k: lr_of(k, Xt) for k in ks}
                    cm = _butterfly(
                        [torch.stack([lr[k] for k in ks if k % tpp == h]
                                     ).max(0).values
                         if any(k % tpp == h for k in ks)
                         else torch.full((tp,), -torch.inf,
                                         dtype=torch.float64)
                         for h in range(tpp)], torch.maximum)
                    mnew = torch.maximum(mx, cm)
                    parts = []
                    for h in range(tpp):
                        acc = torch.zeros(tp)
                        for k in ks:
                            if (k - c0) % tpp == h:
                                acc = acc + torch.exp((lr[k] - mnew).float())
                        parts.append(acc)
                    den = den * torch.exp((mx - mnew).float()) + _butterfly(
                        parts, torch.add)
                    mx = mnew
                lse.append((mx, den))
        S = torch.zeros(K, Dq, Dq, dtype=torch.float64)
        for y in range(P["nby"]):
            if P["kb"] > 0:
                kbase = y * P["kb"]
                nkb = min(K, kbase + P["kb"]) - kbase
                lo, hi = kbase * P["nitems"], (kbase + nkb) * P["nitems"]
            else:
                kbase, j = divmod(y, P["nsplit"])
                nkb = 1
                lo = kbase * P["nitems"] + j * P["per"]
                hi = kbase * P["nitems"] + min(P["nitems"],
                                               (j + 1) * P["per"])
            nbi = hi - lo
            nchunk, csz, G = _wide_chunks(nbi, tp)
            spg = tp // 16 // G
            acc = torch.zeros(nchunk, G, csz, 16, 8, dtype=torch.float64)
            for i, (Xt, m, v) in enumerate(tiles):
                ks = range(kbase, kbase + nkb)
                lr = {k: lr_of(k, Xt) for k in ks}
                if P["nby"] == 1:
                    mx = _butterfly(
                        [torch.stack([lr[k] for k in ks if k % tpp == h]
                                     ).max(0).values
                         if any(k % tpp == h for k in ks)
                         else torch.full((tp,), -torch.inf,
                                         dtype=torch.float64)
                         for h in range(tpp)], torch.maximum)
                    parts = []
                    for h in range(tpp):
                        a = torch.zeros(tp)
                        for k in ks:
                            if (k - kbase) % tpp == h:
                                a = a + torch.exp((lr[k] - mx).float())
                        parts.append(a)
                    den = _butterfly(parts, torch.add)
                else:
                    mx, den = lse[i]
                valid = torch.arange(tp) < v
                r = {k: torch.where(valid, torch.exp((lr[k] - mx).float())
                                    / den * m, torch.zeros(()))
                     for k in ks}
                if y == 0 or P["kb"] > 0 or (y % P["nsplit"]) == 0:
                    for k in ks:
                        r_out[n, i * tp:i * tp + v, k] = r[k][:v]
                for w in range(nchunk * G):
                    ch, gi = divmod(w, G)
                    it0 = lo + ch * csz
                    for st in range(gi * spg, (gi + 1) * spg):
                        pts = slice(16 * st, 16 * st + 16)
                        for cix, it in enumerate(range(it0,
                                                       min(hi, it0 + csz))):
                            k = it // P["nitems"]
                            I, J = items[it % P["nitems"]]
                            A = Xt[pts, 16 * I:16 * I + 16]       # (16, 16)
                            Bm = (Xt[pts, 8 * J:8 * J + 8]
                                  * r[k][pts].double()[:, None])  # (16, 8)
                            acc[ch, gi, cix] += A.T @ Bm
            for it in range(lo, hi):
                ch, cix = divmod(it - lo, csz)
                tot = acc[ch, 0, cix].clone()
                for gg in range(1, G):
                    tot = tot + acc[ch, gg, cix]
                k = it // P["nitems"]
                I, J = items[it % P["nitems"]]
                for e in range(128):
                    ri, cj = 16 * I + e // 8, 8 * J + e % 8
                    if ri <= cj < Dq:
                        S[k, ri, cj] = tot[e // 8, e % 8]
        # emit: centring on the shift in f64, symmetric, times rep, f32
        for k in range(K):
            sk = s_all[n, k].double()
            R = S[k, D, D]
            Sx = S[k, :D, D]
            stats[n, k] = ((Sx - R * sk) * rep).float()
            iu = torch.triu_indices(D, D)
            up = torch.zeros(D, D, dtype=torch.float64)
            i, j = iu
            up[i, j] = (S[k, i, j] - sk[i] * Sx[j] - Sx[i] * sk[j]
                        + R * sk[i] * sk[j])
            full = torch.where(torch.arange(D)[:, None]
                               <= torch.arange(D)[None, :], up, up.T)
            stats[n, K + k * D:K + (k + 1) * D] = (full * rep).float()
            stats[n, K + K * D + k, 0] = float(R * rep)
    R = stats[:, K + K * D:, 0]
    return r_out, R, stats[:, :K], stats[:, K:K + K * D].reshape(N, K, D, D)


@pytest.mark.parametrize("N,T,K,D,centred", [
    (2, 17, 2, 34, True),        # Table II: one block a node, 4 groups
    (1, 43, 6, 52, False),       # Fig. 13 at K = 6: lse + 2 split blocks
    (2, 130, 1, 9, True),        # K = 1, D = 9: 2 tiles, 8 groups
    (1, 40, 224, 8, False),      # a K x D the shared path refuses
    (1, 20, 13, 64, True),       # past the old kernel's limit: 7 blocks
    (1, 20, 13, 64, False),      # the same, against the JAX package
    (1, 9, 1, 130, True),        # one component over 2 blocks
    (1, 6, 2, 200, False),       # a 64-point tile
])
def test_wide_schedule_matches_plain(N, T, K, D, centred):
    """The wide path's schedule, rendered in PyTorch, gives the plain
    version's function: at the tests/test_kernels.py bars (r's scaled as
    WIDE_R_ATOL) against the f64 evaluation, and, where the JAX package
    computes the same function (no shift; or K = 1, whose shift is x's
    alone), against its Pallas kernel in interpret mode and its oracle."""
    assert tge.kernel_variant(K, D) == "wide"
    a = list(map(torch.from_numpy, _args(N, T, K, D, seed=K)))
    s = (torch.from_numpy(np.random.default_rng(1).normal(
        size=(N, K, D)).astype(np.float32)) if centred else None)
    rep = 2.0
    got = _wide_schedule(*a, rep=rep, shift=s)
    exact = tge.gmm_estep_nodes_plain(*a, rep, shift=s, dtype=torch.float64)
    _check(got, [e.float() for e in exact], WIDE_R_ATOL(D))
    if centred and K > 1:
        return
    j = [jnp.asarray(v.numpy()) for v in a]
    if centred:
        j[0] = jnp.asarray((a[0] - s[:, :1]).numpy())
    _check(got, jops.gmm_estep_nodes(*j, rep, block_t=32), WIDE_R_ATOL(D))
    rr, RR, sxr, sxxr = jref.gmm_estep_nodes(*j)
    _check(got, (rr, RR * rep, sxr * rep, sxxr * rep), WIDE_R_ATOL(D))


def test_wide_dispatch_and_limits():
    """D > 8 and the shapes past the shared path's memory go to the wide
    kernel, by (K, D) alone; the wide kernel takes every K and D (its plan
    splits a node's statistics over blocks, halves the tile, or reads x
    from global memory), and FusedBackend.supports says yes."""
    from repro_torch.core import backends, expfam
    from repro_torch.core import model as model_lib
    for K, D in ((2, 34), (2, 52), (4, 52), (6, 52), (10, 52), (1, 9),
                 (12, 64), (10, 68), (222, 8), (1200, 8)):
        assert tge.kernel_variant(K, D) == "wide", (K, D)
    assert tge.kernel_variant(221, 8) == "shared"
    # past its K range the shared path's u fragments outgrow a block's
    # shared memory only at D = 1 (K > 2336, a range it took before)
    assert [max(K for K in range(1, tge.SHARED_KMAX[D] + 1)
                if tge.kernel_variant(K, D) == "shared")
            for D in range(1, 9)] == [2336, 1709, 1019, 675, 480, 358, 278,
                                      221]
    assert tge.kernel_variant(2337, 1) == tge.kernel_variant(3418, 1) == "wide"
    for K, D in ((10, 52), (10, 64), (12, 64), (10, 68), (226, 8), (13, 64),
                 (10, 69), (227, 8), (2, 110), (1, 1), (5000, 3), (1, 4000)):
        assert tge.supported(K, D), (K, D)
    assert not tge.supported(0, 34) and not tge.supported(2, 0)
    P = tge.wide_plan(2, 34)
    assert (P["Dq"], P["nS"], P["nJ"], P["nI"], P["nfrag"], P["nitems"]) == (
        35, 5, 5, 3, 15, 9)
    assert (P["kb"], P["nby"], P["tp"], P["xg"], P["xs"]) == (2, 1, 128, 0,
                                                             52)
    assert P["su"] == 1 and P["smem"] == (
        128 * 52 * 8 + 2 * (128 * 34 * 4 + 16) + 2 * 128 * 8 + 128 * 4
        + 16 + 2 * 15 * 512)
    # past the first wide kernel's shared memory: split over blocks
    assert (tge.wide_plan(13, 64)["kb"], tge.wide_plan(13, 64)["nby"]) == (
        2, 7)
    assert tge.wide_plan(10, 69)["nby"] == 5
    assert (tge.wide_plan(227, 8)["kb"], tge.wide_plan(227, 8)["nby"]) == (
        32, 8)
    # one component over several blocks; a halved tile; x from global
    assert (tge.wide_plan(2, 150)["kb"], tge.wide_plan(2, 150)["nsplit"],
            tge.wide_plan(2, 150)["nby"]) == (0, 2, 4)
    assert tge.wide_plan(2, 200)["tp"] == 64
    assert tge.wide_plan(1, 2000)["xg"] == 1
    for K, D in ((2, 34), (13, 64), (227, 8), (1, 2000)):
        for esize in (4, 2):
            assert tge.wide_plan(K, D, esize)["smem"] <= tge.MAX_SMEM_BYTES
    assert tge.wide_workspace_bytes(1000, 4096, 2, 34) == (
        2000 * 15 * 64 * 8 + 2000 * 34 * 8 + 2000 * 630 * 8)
    fb = backends.FusedBackend()
    for K, D in ((2, 34), (6, 52), (13, 64), (2, 110)):
        mdl = model_lib.GMMModel(expfam.noninformative_prior(K, D),
                                 device="cpu")
        assert fb.supports(mdl), (K, D)


def test_wide_constants_mirror_the_source():
    """WIDE_THREADS, WIDE_TILE, WIDE_ITEMS, WIDE_STEPS and WIDE_COMPS are
    the CUDA source's kWideThreads, kWideTile, kWideItems, kWideSteps and
    kWideComps, and MAX_SMEM_BYTES its kWideSmem."""
    import re
    from pathlib import Path
    src = (Path(tge.__file__).resolve().parent.parent / "csrc"
           / "gmm_estep.cu").read_text()
    for name, value in (("kWideThreads", tge.WIDE_THREADS),
                        ("kWideTile", tge.WIDE_TILE),
                        ("kWideItems", tge.WIDE_ITEMS),
                        ("kWideSteps", tge.WIDE_STEPS),
                        ("kWideComps", tge.WIDE_COMPS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name
    m = re.search(r"constexpr int kWideSmem = (\d+) \* 1024;", src)
    assert m is not None and int(m.group(1)) * 1024 == tge.MAX_SMEM_BYTES


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
