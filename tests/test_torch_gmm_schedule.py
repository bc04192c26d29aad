"""csrc/gmm_estep.cu's register-path schedule, rendered in plain PyTorch on
the CPU, against the JAX package; the wrapper's dispatch and input checks.

The CUDA kernel runs only on a card (tests/test_torch_kernels_gpu.py).
What can be held here is its schedule: which thread of which block takes
which point, the per-thread partial sums in point order and the node's
sum (lane l adds threads l, l + 32, ... in order, then the warp
butterfly), around the per-point arithmetic it does (log rho in the plain
version's form, exp of (log rho - max), one reciprocal a point).
`_regs_schedule` renders that in f32; it is held against the Pallas kernel
in interpret mode and `repro.kernels.ref` at the tests/test_kernels.py
sweep's T and tiles with register-path (K, D) and at that sweep's
tolerances (r atol 2e-5; R rtol 1e-4; sum_x rtol 1e-4 / atol 5e-4; sum_xx
rtol 1e-3 / atol 5e-3: f32 products summed in different orders), and
shown BIT-identical under trailing zero padding that adds tiles.
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
from repro_torch.kernels import ops

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


def _butterfly(v, lane_dim):
    """__shfl_xor_sync butterfly over the 32 lanes of `lane_dim`: every
    lane ends with the warp total, added in the kernel's order."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v.index_select(lane_dim, lanes ^ off)
    return v


def _regs_schedule(x, mask, lp, Wn, b, c, rep=1.0, shift=None):
    """gmm_estep_regs_kernel in f32, one block per node.  Point p of a
    node belongs to tile p // TILE; thread (p % TILE) // GROUP takes it as
    point p % GROUP of its group.  Returns (r, R, sum_x, sum_xx)."""
    TH, GR, TILE = ge.REG_THREADS, ge.REG_GROUP, ge.REG_TILE
    N, T, D = x.shape
    K = lp.shape[1]
    x, mask = x.float(), mask.float()
    s = torch.zeros(N, K, D) if shift is None else shift
    tiles = -(-T // TILE)
    Tp = tiles * TILE                       # points past T read as zeros
    xp = torch.cat([x, x.new_zeros(N, Tp - T, D)], 1)
    mp = torch.cat([mask, mask.new_zeros(N, Tp - T)], 1)
    y = xp[:, :, None, :] - s[:, None]                            # (N,Tp,K,D)
    # log rho = lp - (y' Wn y - 2 y.b + c) / 2, Wn applied row by row
    yw = torch.einsum("ntkd,nkde->ntke", y, Wn)
    lr = lp[:, None] - 0.5 * ((yw * y).sum(-1) - 2.0 * (y * b[:, None])
                              .sum(-1) + c[:, None])               # (N,Tp,K)
    e = torch.exp(lr - lr.amax(-1, keepdim=True))
    r = e * (mp / e.sum(-1))[..., None]
    ry = r[..., None] * y
    tri = [(d, f) for d in range(D) for f in range(d, D)]
    contrib = torch.cat([r[..., None], ry,
                         torch.stack([ry[..., d] * y[..., f]
                                      for d, f in tri], -1)], -1)
    SK = contrib.shape[-1]
    # per thread: its points in point order (tile by tile, then the group)
    c6 = contrib.reshape(N, tiles, TH, GR, K, SK)
    acc = torch.zeros(N, TH, K, SK)
    for tl in range(tiles):
        for j in range(GR):
            acc = acc + c6[:, tl, :, j]
    # per node: lane l adds threads l, l + 32, ..., then the butterfly,
    # then the replication
    part = acc.reshape(N, TH // 32, 32, K, SK)
    lane = part[:, 0]
    for w in range(1, TH // 32):
        lane = lane + part[:, w]
    tot = _butterfly(lane, 1)[:, 0] * rep
    R, sum_x, up = tot[..., 0], tot[..., 1:1 + D], tot[..., 1 + D:]
    sum_xx = torch.zeros(N, K, D, D)
    for i, (d, f) in enumerate(tri):
        sum_xx[..., d, f] = sum_xx[..., f, d] = up[..., i]
    return r[:, :T], R, sum_x, sum_xx


def _check(got, want):
    r, R, sx, sxx = (None if g is None else np.asarray(g) for g in got)
    rr, RR, sxr, sxxr = (None if w is None else np.asarray(w, np.float32)
                         for w in want)
    if r is not None and rr is not None:
        np.testing.assert_allclose(r, rr, atol=2e-5)
    np.testing.assert_allclose(R, RR, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sx, sxr, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(sxx, sxxr, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("T,K,D,block", [
    (100, 3, 2, 32),
    (257, 1, 5, 64),        # ragged: T % 4 != 0
    (64, 8, 1, 64),
    (500, 2, 3, 128),
])
def test_schedule_sweep_against_interpret_kernel_and_oracle(T, K, D, block):
    """The four tests/test_kernels.py sweep cases' T and tiles,
    single-node view.  Their (K, D) are the sweep's where the register
    path takes it (100, 3, 2); elsewhere the register path's own at that
    D or width (the sweep's (4, 5), (2, 8), (6, 3) run the shared-memory
    kernel, whose schedule tests/test_torch_gmm_shared_schedule.py
    renders)."""
    assert ge.kernel_variant(K, D) == "registers"
    a = _args(1, T, K, D)
    got = tuple(g[0] for g in _regs_schedule(*map(torch.from_numpy, a)))
    _check(got, jops.gmm_estep(*(jnp.asarray(v[0]) for v in a),
                               block_t=block))
    _check(got, jref.gmm_estep(*(jnp.asarray(v[0]) for v in a)))


@pytest.mark.parametrize("N,T,K,D,rep", [
    (3, 1000, 3, 2, 7.0),       # the main path's K, D; two tiles a node
    (2, 2600, 4, 2, 1.0),       # the register path's widest K at D = 2
    (2, 700, 8, 1, 3.0),        # ... at D = 1
    (2, 333, 2, 3, 2.0),        # ... at D = 3, T ragged
])
def test_schedule_node_batched_against_interpret_kernel(N, T, K, D, rep):
    """Register-path shapes, several nodes and tiles, with a replication
    factor, against the Pallas kernel and the oracle."""
    assert ge.kernel_variant(K, D) == "registers"
    a = _args(N, T, K, D, seed=T)
    got = _regs_schedule(*map(torch.from_numpy, a), rep)
    _check(got, jops.gmm_estep_nodes(*map(jnp.asarray, a), rep, block_t=128))
    rr, RR, sxr, sxxr = jref.gmm_estep_nodes(*map(jnp.asarray, a))
    _check(got, (rr, RR * rep, sxr * rep, sxxr * rep))
    # and the port's plain version (the CPU path of the wrapper)
    want = ops.gmm_estep_nodes(*map(torch.from_numpy, a), rep)
    _check(got, tuple(w.numpy() for w in want))


def test_schedule_with_shift_matches_plain_version():
    """A per-component shift (the engine's centring) in the schedule: the
    same function as the plain version with the same shift."""
    rng = np.random.default_rng(11)
    a = list(map(torch.from_numpy, _args(4, 900, 3, 2, seed=3)))
    shift = torch.tensor(rng.uniform(-2, 2, (4, 3, 2)), dtype=torch.float32)
    got = _regs_schedule(*a, 5.0, shift=shift)
    want = ge.gmm_estep_nodes_plain(*a, 5.0, shift=shift)
    _check(got, want)


@pytest.mark.parametrize("K,D", [(3, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("centred", [False, True])
def test_schedule_bit_invariant_to_trailing_padding(centred, K, D):
    """Zero rows appended at T = 1000 (two tiles) leave the statistics
    bit-identical: pad 1 and 24 stay in the second tile, pad 3000 adds
    six tiles."""
    assert ge.kernel_variant(K, D) == "registers"
    x, mask, *terms = map(torch.from_numpy, _args(3, 1000, K, D, seed=5))
    shift = torch.full((3, K, D), 0.75) if centred else None
    base = _regs_schedule(x, mask, *terms, 3.0, shift=shift)
    for pad in (1, 24, 3000):
        xp = torch.cat([x, torch.zeros(3, pad, D)], 1)
        mp = torch.cat([mask, torch.zeros(3, pad)], 1)
        got = _regs_schedule(xp, mp, *terms, 3.0, shift=shift)
        assert torch.equal(got[0][:, :1000], base[0])
        for g, w in zip(got[1:], base[1:]):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Dispatch and input checks of the wrapper
# ---------------------------------------------------------------------------
def test_kernel_variant_by_shape():
    """The register path takes K (1 + D + D(D+1)/2) <= 24 statistics."""
    assert [ge.reg_kmax(D) for D in range(1, 9)] == [8, 4, 2, 1, 1, 0, 0, 0]
    regs = [(3, 2), (4, 2), (1, 2), (8, 1), (2, 3), (1, 4), (1, 5)]
    shared = [(5, 2), (8, 2), (9, 1), (3, 3), (2, 4), (2, 5), (1, 6), (1, 8),
              (6, 3), (32, 3), (200, 8)]
    for K, D in regs:
        assert ge.kernel_variant(K, D) == "registers", (K, D)
    for K, D in shared:
        assert ge.kernel_variant(K, D) == "shared", (K, D)
    # the variant never depends on T or N: it takes only (K, D)
    assert ge.kernel_variant.__code__.co_argcount == 2


def test_register_path_constants_mirror_the_source():
    """REG_STATS_BUDGET, REG_THREADS and REG_GROUP are the CUDA source's
    kRegBudget, kThreads and kGroup, and SHARED_THREADS (whose warps'
    16-point steps make the block_t rule) its kSmThreads."""
    src = (Path(ge.__file__).resolve().parent.parent / "csrc"
           / "gmm_estep.cu").read_text()
    want = {"kRegBudget": ge.REG_STATS_BUDGET, "kThreads": ge.REG_THREADS,
            "kGroup": ge.REG_GROUP, "kSmThreads": ge.SHARED_THREADS}
    for name, value in want.items():
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name


def test_vector_loads_rule():
    x = torch.zeros(2, 64, 2)
    mask = torch.zeros(2, 64)
    assert ge.vector_loads(x, mask)
    assert not ge.vector_loads(torch.zeros(2, 66, 2), torch.zeros(2, 66))
    # a view that starts one element into its storage is not 16-byte aligned
    xs = torch.zeros(2 * 64 * 2 + 1)[1:].view(2, 64, 2)
    assert not ge.vector_loads(xs, mask)
    ms = torch.zeros(2 * 64 + 1)[1:].view(2, 64)
    assert not ge.vector_loads(x, ms)


def test_new_input_checks_raise():
    x, mask, lp, Wn, b, c = map(torch.from_numpy, _args(2, 64, 3, 2))
    launches = ops.gmm_estep_nodes.launches
    with pytest.raises(TypeError, match="replication must be a Python"):
        ops.gmm_estep_nodes(x, mask, lp, Wn, b, c, torch.tensor(2.0))
    # zero-element arrays: the grid and index limits are checked first
    with pytest.raises(ValueError, match="nodes"):
        ops.gmm_estep_nodes(torch.empty(ge.MAX_NODES + 1, 0, 2),
                            torch.empty(ge.MAX_NODES + 1, 0), lp, Wn, b, c)
    with pytest.raises(ValueError, match="points a node"):
        ops.gmm_estep_nodes(torch.empty(1, ge.MAX_POINTS + 1, 0),
                            torch.empty(1, ge.MAX_POINTS + 1), lp, Wn, b, c)
    # register-path shapes need no dynamic shared memory, whatever block_t
    assert ge.kernel_variant(8, 1) == "registers"
    x1, m1, *t1 = map(torch.from_numpy, _args(1, 40, 8, 1))
    ops.gmm_estep_nodes(x1, m1, *t1, block_t=128)
    # numpy scalars are Python numbers
    ops.gmm_estep_nodes(x, mask, lp, Wn, b, c, np.float64(2.0))
    assert ops.gmm_estep_nodes.launches == launches
