"""csrc/gmm_estep.cu's shared-memory path (gmm_estep_smem_kernel), its
schedule rendered in plain PyTorch on the CPU, against the JAX package.

The CUDA kernel runs only on a card (tests/test_torch_kernels_gpu.py).
What can be held here is its schedule: each point's features phi = the
upper triangle of x' x'^T (x' = (x, 1)), each component's terms folded
into u_k on the same triangle (log rho = phi . u_k), the block_t tiles and
the warps' 16-point steps (warp w takes steps w, w + 8, ... of a tile),
log rho as k-steps of 8 features accumulated in order, the softmax as the
four lanes of a point hold it (a lane's components in block order, then
the xor butterfly; online per lane and over the lanes in the lse pass
when the node's components take several passes), r, the statistics
sum_t r phi as 16 x 8 products accumulated per warp across all tiles,
the warps' sums added in warp order, and the emit's centring in f64.
`_shared_schedule` renders that in f64 (f32 where the kernel is: exp,
the denominators, r); what it pins is the order around each DMMA product,
not the product's own bits (the hardware's).  It is held against the
Pallas kernel in interpret mode and `repro.kernels.ref.gmm_estep_nodes`
at tests/test_kernels.py's bars (r atol 2e-5; R rtol 1e-4; sum_x rtol
1e-4 / atol 5e-4; sum_xx rtol 1e-3 / atol 5e-3) at the sweep's
shared-path shapes, centred (against the same function with the shift
folded into uncentred terms, the JAX statistics centred in f64) and not,
and shown BIT-identical under trailing zero padding that adds tiles.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gmm_estep as ge


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


def _feats(D):
    """Feature (i, j), i <= j <= D, of x' = (x, 1), row by row."""
    return [(i, j) for i in range(D + 1) for j in range(i, D + 1)]


def _fold_u(lp, W, b, c, s):
    """u_k as the kernel folds it, in f64: -(M_ij + M_ji) / 2 above the
    diagonal and -M_ii / 2 on it for M = [[W, -v], [-v^T, cc]], v = (W +
    W^T) s / 2 + b, cc = s^T W s + 2 s.b + c, plus log_prior at (D, D)."""
    D = W.shape[0]
    W, b, s = W.double(), b.double(), s.double()
    v = 0.5 * ((W + W.T) @ s) + b
    cc = float(c) + float(s @ (W @ s)) + 2.0 * float(s @ b)
    u = []
    for i, j in _feats(D):
        if j < D:
            u.append(-0.5 * float(W[i, i]) if i == j
                     else -0.5 * float(W[i, j] + W[j, i]))
        elif i < D:
            u.append(float(v[i]))
        else:
            u.append(float(lp) - 0.5 * cc)
    return torch.tensor(u, dtype=torch.float64)


def _phi(x):
    """(P, D) points -> (P, F) features in f64 (exact products)."""
    xd = torch.cat([x.double(), torch.ones(x.shape[0], 1,
                                           dtype=torch.float64)], 1)
    return torch.stack([xd[:, i] * xd[:, j] for i, j in _feats(x.shape[1])],
                       1)


def _lane_sum(parts):
    """The kernel's sum over the four lanes of a point: += shfl_xor 1,
    then += shfl_xor 2 (every lane ends with the same bits)."""
    a = [parts[h] + parts[h ^ 1] for h in range(4)]
    return a[0] + a[2]


def _shared_schedule(x, mask, lp, Wn, b, c, rep=1.0, shift=None,
                     block_t=ge.DEFAULT_BLOCK_T):
    """gmm_estep_smem_kernel's schedule, one block a node.  Returns (r,
    R, sum_x, sum_xx)."""
    N, T, D = x.shape
    K = lp.shape[1]
    P = ge.shared_plan(K, D, x.element_size(), block_t)
    F, NS, NF, ncb, cbm = P["F"], P["NS"], P["NF"], P["ncb"], P["cbm"]
    warps, step = ge.SHARED_THREADS // 32, ge.SHARED_STEP
    s_all = shift if shift is not None else torch.zeros(N, K, D)
    ntiles = -(-T // block_t)
    r_out = torch.zeros(N, T, K)
    stats = torch.zeros(N, K + K * D + K, D)
    feats = _feats(D)
    for n in range(N):
        # u of every block of 8 components (zero past K and F)
        U = torch.zeros(8 * ncb, 8 * NS, dtype=torch.float64)
        for k in range(K):
            U[k, :F] = _fold_u(lp[n, k], Wn[n, k], b[n, k], c[n, k],
                               s_all[n, k])
        # the steps a warp takes, in order: (tile, first point, points)
        steps = [[] for _ in range(warps)]
        for i in range(ntiles):
            valid = min(block_t, T - i * block_t)
            for j in range(0, block_t // step):
                if j * step < valid:
                    steps[j % warps].append(i * block_t + j * step)

        def step_terms(p):
            """phi (16, 16 NF) and mask (16,) of the step at point p."""
            v = min(step, T - p)
            xs = torch.zeros(step, D)
            xs[:v] = x[n, p:p + v].float()
            ph = torch.zeros(step, 16 * NF, dtype=torch.float64)
            ph[:, :F] = _phi(xs)
            m = torch.zeros(step)
            m[:v] = mask[n, p:p + v].float()
            return ph, m, v

        def log_rho(ph, blocks):
            """(16, 8 len(blocks)) log rho: the k-steps of 8 in order."""
            cols = torch.cat([torch.arange(8 * cb, 8 * cb + 8)
                              for cb in blocks])
            lr = torch.zeros(step, len(cols), dtype=torch.float64)
            for s in range(NS):
                lr = lr + ph[:, 8 * s:8 * s + 8] @ U[cols, 8 * s:8 * s + 8].T
            return torch.where(cols[None] < K, lr, torch.full((), -torch.inf,
                                                               dtype=lr.dtype))

        lse = {}
        if P["chunked"]:
            # the lse pass: per lane t (components 8 cb + 2 t, + 1, block
            # by block) online, then over the lanes (xor 1, xor 2)
            for w in range(warps):
                for p in steps[w]:
                    ph, m, v = step_terms(p)
                    lr = log_rho(ph, range(ncb))
                    ms, ds = [], []
                    for t in range(4):
                        mm = torch.full((step,), -torch.inf,
                                        dtype=torch.float64)
                        dd = torch.zeros(step)
                        for cb in range(ncb):
                            for e in range(2):
                                k = 8 * cb + 2 * t + e
                                if k >= K:
                                    continue
                                val = lr[:, k]
                                up = val > mm
                                dd = torch.where(
                                    up, dd * torch.exp((mm - val).float()) + 1,
                                    dd + torch.exp((val - mm).float()))
                                mm = torch.where(up, val, mm)
                        ms.append(mm)
                        ds.append(dd)
                    for o in (1, 2):
                        nm, nd = [], []
                        for t in range(4):
                            M = torch.maximum(ms[t], ms[t ^ o])
                            nd.append(ds[t] * torch.exp((ms[t] - M).float())
                                      + ds[t ^ o] * torch.exp(
                                          (ms[t ^ o] - M).float()))
                            nm.append(M)
                        ms, ds = nm, nd
                    lse[p] = (ms[0], ds[0])
        for q in range(P["npass"]):
            blocks = list(range(q * cbm, min(ncb, (q + 1) * cbm)))
            nc = len(blocks)
            acc = torch.zeros(warps, NF, 16, 8 * nc, dtype=torch.float64)
            for w in range(warps):
                for p in steps[w]:
                    ph, m, v = step_terms(p)
                    lr = log_rho(ph, blocks)                  # (16, 8 nc)
                    if P["chunked"]:
                        # the lse pass's max and denominator
                        mx, den = lse[p]
                        mx = torch.where(torch.arange(step) < v, mx,
                                         torch.zeros((), dtype=mx.dtype))
                        den = torch.where(torch.arange(step) < v, den,
                                          torch.ones(()))
                        ev = torch.exp((lr - mx[:, None]).float())
                        r = ev * (m / den)[:, None]
                    else:
                        # the max over the blocks, e, each lane's share of
                        # the denominator (its components, block by block)
                        mx = lr.max(1).values
                        ev = torch.exp((lr - mx[:, None]).float())
                        parts = []
                        for t in range(4):
                            d = torch.zeros(step)
                            for cb in range(nc):
                                for e in range(2):
                                    d = d + ev[:, 8 * cb + 2 * t + e]
                            parts.append(d)
                        r = ev * (m / _lane_sum(parts))[:, None]
                    for cb, kb in enumerate(blocks):
                        for kk in range(8):
                            k = 8 * kb + kk
                            if k < K:
                                r_out[n, p:p + v, k] = r[:v, 8 * cb + kk]
                    for fb in range(NF):
                        acc[w, fb] += (ph[:, 16 * fb:16 * fb + 16].T
                                       @ r.double())
            Ssum = acc[0]
            for w in range(1, warps):
                Ssum = Ssum + acc[w]
            # emit: centring on the shift in f64, symmetric, times rep
            S = torch.cat(list(Ssum), 0)          # (16 NF, 8 nc)
            fidx = {f: i for i, f in enumerate(feats)}
            for cb, kb in enumerate(blocks):
                for kk in range(8):
                    k = 8 * kb + kk
                    if k >= K:
                        continue
                    col = S[:, 8 * cb + kk]
                    sk = s_all[n, k].double()
                    R = col[fidx[(D, D)]]
                    Sx = torch.stack([col[fidx[(d, D)]] for d in range(D)])
                    stats[n, k] = ((Sx - R * sk) * rep).float()
                    for d in range(D):
                        for e in range(D):
                            i, j = min(d, e), max(d, e)
                            val = (col[fidx[(i, j)]] - sk[i] * Sx[j]
                                   - Sx[i] * sk[j] + R * sk[i] * sk[j])
                            stats[n, K + k * D + d, e] = float(val * rep)
                    stats[n, K + K * D + k, 0] = float(R * rep)
    R = stats[:, K + K * D:, 0]
    return r_out, R, stats[:, :K], stats[:, K:K + K * D].reshape(N, K, D, D)


def _check(got, want):
    r, R, sx, sxx = (None if g is None else np.asarray(g) for g in got)
    rr, RR, sxr, sxxr = (None if w is None else np.asarray(w, np.float32)
                         for w in want)
    if r is not None and rr is not None:
        np.testing.assert_allclose(r, rr, atol=2e-5)
    np.testing.assert_allclose(R, RR, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sx, sxr, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(sxx, sxxr, rtol=1e-3, atol=5e-3)


def _jax_same_function(a, s, rep):
    """The JAX package's kernel (interpret mode) and oracle on the terms
    of the same function without a shift (b' = (W + W^T) s / 2 + b, c' =
    s^T W s + 2 s.b + c, in f64, then f32), their statistics centred on s
    in f64 afterwards.  Returns two (r, R, sum_x, sum_xx)."""
    x, mask, lp, Wn, b, c = a
    W = Wn.double()
    sd = s.double()
    b2 = (0.5 * torch.einsum("nkde,nke->nkd", W + W.transpose(-1, -2), sd)
          + b.double())
    c2 = (c.double() + torch.einsum("nkd,nkde,nke->nk", sd, W, sd)
          + 2.0 * (sd * b.double()).sum(-1))
    j = [jnp.asarray(v.numpy()) for v in (x, mask, lp, Wn, b2.float(),
                                          c2.float())]
    outs = [jops.gmm_estep_nodes(*j, 1.0, block_t=32),
            jref.gmm_estep_nodes(*j)]
    res = []
    for r, R, sx, sxx in outs:
        R = torch.tensor(np.asarray(R), dtype=torch.float64)
        sx = torch.tensor(np.asarray(sx), dtype=torch.float64)
        sxx = torch.tensor(np.asarray(sxx), dtype=torch.float64)
        sxc = sx - R[..., None] * sd
        sxxc = (sxx - sx[..., :, None] * sd[..., None, :]
                - sd[..., :, None] * sx[..., None, :]
                + R[..., None, None] * sd[..., :, None] * sd[..., None, :])
        res.append((np.asarray(r), (R * rep).float(), (sxc * rep).float(),
                    (sxxc * rep).float()))
    return res


@pytest.mark.parametrize("N,T,K,D", [
    (1, 257, 4, 5),        # the tests/test_kernels.py sweep's shapes the
    (1, 64, 2, 8),         # shared path takes (T ragged: a tile's last
    (1, 500, 6, 3),        # step part padding)
    (4, 300, 32, 3),       # four component blocks a warp
    (3, 1000, 8, 2),       # the over-complete run's K, D; two tiles
    (1, 300, 40, 3),       # five blocks: the lse pass, two passes
])
@pytest.mark.parametrize("centred", [False, True])
def test_shared_schedule_against_interpret_kernel_and_oracle(N, T, K, D,
                                                             centred):
    assert ge.kernel_variant(K, D) == "shared"
    a = list(map(torch.from_numpy, _args(N, T, K, D, seed=T + K)))
    rep = 3.0
    s = (torch.from_numpy(np.random.default_rng(K).normal(
        size=(N, K, D)).astype(np.float32)) if centred else None)
    got = _shared_schedule(*a, rep, shift=s)
    if centred:
        for want in _jax_same_function(a, s, rep):
            _check(got, want)
    else:
        j = [jnp.asarray(v.numpy()) for v in a]
        _check(got, jops.gmm_estep_nodes(*j, rep, block_t=32))
        rr, RR, sxr, sxxr = jref.gmm_estep_nodes(*j)
        _check(got, (rr, RR * rep, sxr * rep, sxxr * rep))
    # and the port's f64 evaluation of the same function
    exact = ge.gmm_estep_nodes_plain(*a, rep, shift=s, dtype=torch.float64)
    _check(got, [e.float() for e in exact])


@pytest.mark.parametrize("K,D,block_t", [(8, 2, 512), (32, 3, 128),
                                         (40, 3, 256)])
@pytest.mark.parametrize("centred", [False, True])
def test_shared_schedule_bit_invariant_to_trailing_padding(K, D, block_t,
                                                           centred):
    """Zero rows appended at T = 300 leave the statistics bit-identical:
    pad 1 stays in the last tile, pad 700 adds tiles."""
    x, mask, *terms = map(torch.from_numpy, _args(2, 300, K, D, seed=5))
    shift = torch.full((2, K, D), 0.75) if centred else None
    base = _shared_schedule(x, mask, *terms, 3.0, shift=shift,
                            block_t=block_t)
    for pad in (1, 700):
        xp = torch.cat([x, torch.zeros(2, pad, D)], 1)
        mp = torch.cat([mask, torch.zeros(2, pad)], 1)
        got = _shared_schedule(xp, mp, *terms, 3.0, shift=shift,
                               block_t=block_t)
        assert torch.equal(got[0][:, :300], base[0])
        for g, w in zip(got[1:], base[1:]):
            assert torch.equal(g, w)


def test_shared_constants_mirror_the_source():
    """SHARED_THREADS, SHARED_STEP and SHARED_RT are the CUDA source's
    kSmThreads, kSmStep and kSmRt, shared_cbmax its sm_cbmax, and the
    plan's shapes its SmShape."""
    src = (Path(ge.__file__).resolve().parent.parent / "csrc"
           / "gmm_estep.cu").read_text()
    for name, value in (("kSmThreads", ge.SHARED_THREADS),
                        ("kSmStep", ge.SHARED_STEP),
                        ("kSmRt", ge.SHARED_RT)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name
    m = re.search(r"sm_cbmax\(int D\) \{ return D <= (\d+) \? (\d+) : "
                  r"(\d+); \}", src)
    assert m is not None
    lim, lo, hi = map(int, m.groups())
    for D in range(1, ge.MAX_D + 1):
        assert ge.shared_cbmax(D) == (lo if D <= lim else hi)
    P = ge.shared_plan(32, 3)
    assert (P["F"], P["NS"], P["NF"], P["XS"]) == (10, 2, 1, 20)
    P = ge.shared_plan(4, 8)
    assert (P["F"], P["NS"], P["NF"], P["XS"]) == (45, 6, 3, 52)
