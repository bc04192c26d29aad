"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test takes the `cuda` fixture, which skips when there
is no card (decided inside the fixture, never at import or collection).
On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances are those of tests/test_kernels.py: gmm_estep r atol 2e-5;
R rtol 1e-4; sum_x rtol 1e-4 / atol 5e-4; sum_xx rtol 1e-3 / atol 5e-3;
flash_attention atol 2e-5 (f32) / 2e-2 (bf16); ssd_scan atol 5e-5 (at
Mamba-2's full shape: error against f64 at most twice the plain
version's, as chip_smoke.py holds it).  The streaming cases: the link
coins and epoch permutations are equal bit for bit on the CPU and the
card; gmm_estep on masks scaled as `stream.advance` makes them (T/B = 8,
40.96, 5) at the same bars; full-batch streaming specs bit-equal to the
full-batch fused run.  The sparse topologies: the segmented-sum combines
launched twice bit-equal, split/resume and save -> restore -> continue
bit-equal on the card, the same session on the CPU and the card within
1e-12 relative after one iteration (the reference backend, f64), the
link and gossip coins equal bit for bit.  Serving: a fleet launches
gmm_estep once a fleet iteration over (S N, T, D), the kernel at that
shape within the bars above; each tenant bit-equal to its solo run on
the ring, within 1e-9 on the matmul combines; a checkpoint snapshot
holds the slice boundary while the next slice overwrites the fleet.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import algorithms, engine, expfam, gmm, network
from repro_torch.core import model as model_lib
from repro_torch.core import refperm
from repro_torch.data import stream, synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gmm_estep as ge
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their "
                    "plain versions are tested in test_torch_gmm_estep.py "
                    "and test_torch_lm_kernels.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(N, T, K, D, dev, seed=0, dtype=torch.float32):
    g = np.random.default_rng(seed)
    x = g.normal(size=(N, T, D)) * 2
    mask = (g.random((N, T)) > 0.2).astype(float)
    A = g.normal(size=(N, K, D, D)) * 0.3
    Wn = np.einsum("nkij,nklj->nkil", A, A) + np.eye(D)
    terms = [g.normal(size=(N, K)), Wn, g.normal(size=(N, K, D)),
             g.uniform(1, 3, (N, K))]
    f = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    return (f(x, dtype), f(mask, dtype), *map(f, terms))


def _check(got, want):
    r, R, sx, sxx = got
    rr, RR, sxr, sxxr = want
    if r is not None:
        torch.testing.assert_close(r, rr, rtol=0, atol=2e-5)
    torch.testing.assert_close(R, RR, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sx, sxr, rtol=1e-4, atol=5e-4)
    torch.testing.assert_close(sxx, sxxr, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("N,T,K,D", [
    (1, 100, 3, 2), (1, 257, 4, 5), (1, 64, 2, 8), (1, 500, 6, 3),
    (4, 300, 32, 3), (64, 4096, 3, 2),
    # the register path's widest K at D = 2 and D = 1 and an unaligned T
    # on it; K=8/D=2 and K=200/D=8 on the shared-memory path
    (3, 1000, 4, 2), (2, 777, 8, 1), (2, 257, 3, 2), (3, 1000, 8, 2),
    (2, 300, 200, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("return_r", [True, False])
@pytest.mark.parametrize("centred", [False, True])
def test_kernel_matches_plain(cuda, N, T, K, D, dtype, return_r, centred):
    a = _args(N, T, K, D, cuda, seed=T, dtype=dtype)
    shift = (torch.randn(N, K, D, device=cuda, generator=torch.Generator(
        cuda).manual_seed(T)) if centred else None)
    got = ops.gmm_estep_nodes(*a, 3.0, shift=shift, return_r=return_r)
    want = ge.gmm_estep_nodes_plain(*a, 3.0, shift=shift,
                                    return_r=return_r)
    torch.cuda.synchronize()
    assert (got[0] is None) == (not return_r)
    _check(got, want)


# the register path's main shape; the shared path's K=8/D=2, K=32/D=3,
# K=4/D=8 and K=40/D=3 (an lse pass, then passes of component blocks)
@pytest.mark.parametrize("K,D", [(3, 2), (8, 2), (32, 3), (4, 8), (40, 3)])
@pytest.mark.parametrize("centred", [False, True])
def test_bit_invariance_and_determinism(cuda, centred, K, D):
    x, mask, *terms = _args(16, 1000, K, D, cuda, seed=1)
    shift = torch.full((16, K, D), 1.5, device=cuda) if centred else None
    kw = dict(shift=shift, return_r=False)
    base = ops.gmm_estep_nodes(x, mask, *terms, 7.0, **kw)
    again = ops.gmm_estep_nodes(x, mask, *terms, 7.0, **kw)
    for pad in (1, 24, 3000):
        xp = torch.cat([x, x.new_zeros(16, pad, D)], 1)
        mp = torch.cat([mask, mask.new_zeros(16, pad)], 1)
        got = ops.gmm_estep_nodes(xp, mp, *terms, 7.0, **kw)
        for g, w in zip(got[1:], base[1:]):
            assert torch.equal(g, w)
    for g, w in zip(again[1:], base[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("K,D", [(3, 2), (8, 2), (32, 3), (4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_and_scalar_loads_agree_bitwise(cuda, dtype, K, D):
    """x and mask starting off a 16-byte boundary take the scalar loads
    (the register path) or stage the head and tail of each tile's copy
    through registers (the shared path): the same values, so the same
    bits as the aligned loads."""
    x, mask, *terms = _args(8, 1024, K, D, cuda, seed=5, dtype=dtype)
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:]
    ms = torch.empty(mask.numel() + 1, dtype=dtype, device=cuda)[1:]
    xs, ms = xs.view(x.shape), ms.view(mask.shape)
    xs.copy_(x)
    ms.copy_(mask)
    assert ge.vector_loads(x, mask) and not ge.vector_loads(xs, ms)
    want = ops.gmm_estep_nodes(x, mask, *terms, 3.0)
    got = ops.gmm_estep_nodes(xs, ms, *terms, 3.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_large_shared_memory_opt_in(cuda):
    """K=200, D=8 needs ~200 KB of shared memory: above the 48 KB default,
    so the launch opts in; the result still matches."""
    a = _args(2, 300, 200, 8, cuda, seed=3)
    assert ge.smem_bytes(200, 8, 512) > 48 * 1024
    _check(ops.gmm_estep_nodes(*a), ge.gmm_estep_nodes_plain(*a))


@pytest.mark.parametrize("N,T,K,D", [
    (20, 17, 2, 34),                     # Table II
    (10, 14, 2, 52), (10, 28, 4, 52), (10, 43, 6, 52),   # Fig. 13
    (3, 300, 10, 52), (2, 200, 12, 64),  # several blocks a node
    (2, 130, 1, 9),                      # eight point groups
    (2, 300, 224, 8),                    # past the shared path's memory
    # past the first wide design's shared memory
    (3, 77, 13, 64), (2, 50, 16, 64), (2, 40, 2, 110), (2, 90, 227, 8),
    (1, 5, 1, 1800)])                    # x read from global memory
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("return_r", [True, False])
@pytest.mark.parametrize("centred", [False, True])
def test_wide_kernel_matches_plain(cuda, N, T, K, D, dtype, return_r,
                                   centred):
    """The wide kernel at tests/test_kernels.py's bars against an f64
    evaluation of the same inputs (it forms log rho in f64; two f32
    versions do not agree to those bars at D >= 34, where log rho is a
    sum of D^2 products: chip_smoke.py's note); one wide launch counted
    per call (its prep, main and emit launches, and the lse launch when a
    node takes several blocks)."""
    assert ge.kernel_variant(K, D) == "wide"
    a = _args(N, T, K, D, cuda, seed=T + K, dtype=dtype)
    shift = (torch.randn(N, K, D, device=cuda, generator=torch.Generator(
        cuda).manual_seed(T)) if centred else None)
    before = ops.gmm_estep_nodes.variant_launches["wide"]
    got = ops.gmm_estep_nodes(*a, 3.0, shift=shift, return_r=return_r)
    exact = ge.gmm_estep_nodes_plain(*a, 3.0, shift=shift,
                                     return_r=return_r, dtype=torch.float64)
    torch.cuda.synchronize()
    assert ops.gmm_estep_nodes.variant_launches["wide"] == before + 1
    assert (got[0] is None) == (not return_r)
    _check([None if g is None else g.double() for g in got], exact)


@pytest.mark.parametrize("centred", [False, True])
def test_wide_kernel_bit_invariance_and_determinism(cuda, centred):
    x, mask, *terms = _args(6, 200, 6, 52, cuda, seed=2)
    shift = torch.full((6, 6, 52), 0.5, device=cuda) if centred else None
    kw = dict(shift=shift, return_r=False)
    base = ops.gmm_estep_nodes(x, mask, *terms, 5.0, **kw)
    again = ops.gmm_estep_nodes(x, mask, *terms, 5.0, **kw)
    for pad in (1, 64, 500):
        xp = torch.cat([x, x.new_zeros(6, pad, 52)], 1)
        mp = torch.cat([mask, mask.new_zeros(6, pad)], 1)
        got = ops.gmm_estep_nodes(xp, mp, *terms, 5.0, **kw)
        for g, w in zip(got[1:], base[1:]):
            assert torch.equal(g, w)
    for g, w in zip(again[1:], base[1:]):
        assert torch.equal(g, w)


def test_launch_counter_and_engine_parity(cuda):
    """A fused run launches the kernel once per iteration and matches the
    reference backend's KL trajectory at rtol 1e-4 (f32)."""
    K, D, N = 3, 2, 20
    data = synthetic.paper_synthetic(n_nodes=N, n_per_node=200, seed=2,
                                     dtype=np.float32)
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        dtype=torch.float32)
    adj, _ = network.random_geometric_graph(N, seed=4)
    W = network.nearest_neighbor_weights(adj).float()
    ref = refperm.permuted_refs(gmm.ground_truth_posterior(
        *data.flat, prior, K))
    x, mask = data.x.to(cuda), data.mask.to(cuda)
    runs = {}
    for backend in ("fused", "reference"):
        before = ops.gmm_estep_nodes.launches
        runs[backend] = algorithms.run_dsvb(
            x, mask, W, prior, n_iters=12, K=K, D=D, ref_phi=ref,
            backend=backend)
        launched = ops.gmm_estep_nodes.launches - before
        assert launched == (12 if backend == "fused" else 0)
    torch.testing.assert_close(runs["fused"].kl_mean,
                               runs["reference"].kl_mean, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (2, 64, 4, 2, 32), (1, 128, 2, 1, 64), (2, 96, 4, 4, 16),
    (1, 256, 8, 2, 128), (1, 1000, 8, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 32])
def test_flash_attention_matches_plain(cuda, B, S, Hq, Hkv, hd, dtype,
                                       window):
    g = torch.Generator(cuda).manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    assert ops.flash_attention.launches == before + 2
    want = fa.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,S,H,P,N,chunk,rtol", [
    (2, 64, 4, 16, 8, 16, 0), (1, 128, 2, 32, 16, 32, 0),
    (2, 64, 2, 8, 4, 64, 0), (1, 96, 3, 16, 8, 32, 0),
    # Mamba-2's P, N and chunk: |y| reaches tens, so the f32 bar is
    # relative there (1e-5, a few ulp of accumulated rounding)
    (1, 512, 4, 64, 128, 256, 1e-5)])
def test_ssd_scan_matches_plain(cuda, B, S, H, P, N, chunk, rtol):
    g = torch.Generator(cuda).manual_seed(S + P)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = rn(B, S, H, P)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.5)
    Bm, Cm = rn(B, S, N) * 0.3, rn(B, S, N) * 0.3
    before = ops.ssd_scan.launches
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y2, h2 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ops.ssd_scan.launches == before + 2
    yp, hp = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, rtol=rtol, atol=5e-5)
    torch.testing.assert_close(h, hp, rtol=rtol, atol=5e-5)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_flash_attention_yi_6b_prefill_shape(cuda):
    """The Yi-6B prefill shape in bf16 (the tensor-core kernel's main path):
    within 2e-2 of the plain version, two launches bit-identical."""
    g = torch.Generator(cuda).manual_seed(7)
    q, k, v = (torch.randn(4, 2048, h, 128, generator=g, device=cuda)
               .to(torch.bfloat16) for h in (32, 4, 4))
    got = ops.flash_attention(q, k, v)
    again = ops.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)
    assert torch.equal(got, again)


def test_ssd_scan_mamba2_prefill_shape(cuda):
    """The Mamba-2 370M prefill shape in bf16: |y| reaches tens, so the
    kernel is held, as in chip_smoke.py, against an f64 evaluation of the
    same inputs: its max error, for y and for the state, at most twice
    the plain version's.  Two launches bit-identical."""
    g = torch.Generator(cuda).manual_seed(8)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = rn(4, 2048, 32, 64).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rn(4, 2048, 32))
    A = -torch.exp(rn(32) * 0.5)
    Bm, Cm = ((rn(4, 2048, 128) * 0.3).to(torch.bfloat16) for _ in range(2))
    args = (x, dt, A, Bm, Cm)
    y, h = ops.ssd_scan(*args, chunk=256)
    y2, h2 = ops.ssd_scan(*args, chunk=256)
    yp, hp = ss.ssd_scan_plain(*args, chunk=256)
    y64, h64 = mamba2.ssd_chunked(*(a.double() for a in args), 256)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for got, plain, ref in ((y, yp, y64), (h, hp, h64)):
        err = (got.double() - ref).abs().max()
        assert err <= 2 * (plain.double() - ref).abs().max()


def test_ssd_scan_counts_one_launch_per_call(cuda):
    """One wrapper call launches the three passes and counts once."""
    g = torch.Generator(cuda).manual_seed(9)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    args = (rn(1, 128, 2, 16), torch.nn.functional.softplus(rn(1, 128, 2)),
            -torch.exp(rn(2)), rn(1, 128, 8), rn(1, 128, 8))
    for n in range(1, 4):
        before = ops.ssd_scan.launches
        for _ in range(n):
            ops.ssd_scan(*args, chunk=32)
        assert ops.ssd_scan.launches == before + n


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """On the card: bf16 flash inputs off a 16-byte boundary (TMA), and
    ssd head dims past MAX_P or off a multiple of 4, raise before any
    launch."""
    buf = torch.zeros(1 + 64 * 2 * 32, dtype=torch.bfloat16, device=cuda)
    q = buf[1:].view(1, 64, 2, 32)            # contiguous, 2 bytes off
    k = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16, device=cuda)
    before = ops.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, k, k)
    z = lambda *s: torch.zeros(*s, device=cuda)
    for P, N in ((68, 8), (6, 8), (8, 6)):
        with pytest.raises(ValueError, match="multiples of 4"):
            ops.ssd_scan(z(1, 32, 2, P), z(1, 32, 2), z(2), z(1, 32, N),
                         z(1, 32, N), chunk=32)
    assert ops.flash_attention.launches == before


# ---------------------------------------------------------------------------
# streaming: device-independent coins and permutations, scaled masks
# ---------------------------------------------------------------------------
def test_coins_and_permutations_equal_on_cpu_and_card(cuda):
    for seed, t, n in ((0, 0, 7), (5, 3, 300), (2 ** 40 + 1, 123456, 1000)):
        for drop in (0.2, 0.5):
            cpu = network.link_keep_matrix(
                network.link_generator(seed, t, "cpu"), n, drop)
            card = network.link_keep_matrix(
                network.link_generator(seed, t, cuda), n, drop)
            assert torch.equal(cpu, card.cpu())
            assert torch.equal(
                network.ring_link_keep(network.link_generator(seed, t, "cpu"),
                                       n, drop),
                network.ring_link_keep(network.link_generator(seed, t, cuda),
                                       n, drop).cpu())
        for epoch in (0, 1, 77):
            cpu = stream.epoch_perms(stream.node_keys(n, seed), epoch, 4096)
            card = stream.epoch_perms(stream.node_keys(n, seed, cuda), epoch,
                                      4096)
            assert torch.equal(cpu, card.cpu())


@pytest.mark.parametrize("N,T,B,K,D", [
    (50, 4096, 512, 3, 2), (20, 4096, 100, 3, 2), (8, 100, 20, 3, 2),
    (6, 1000, 200, 8, 2), (4, 430, 86, 2, 34)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_on_scaled_masks(cuda, N, T, B, K, D, dtype):
    """The kernel on a streaming gather: (N, B) points, mask T/B on the
    selected valid points (8, 40.96, 5; the register, shared and wide
    paths).  Every output is linear in the mask, so both are compared per
    unit of weight (divided by T/B), in the units of the 0/1 masks the
    bars were set for.  D > 8 is held against an f64 evaluation, as
    test_wide_kernel_matches_plain."""
    x, mask, *terms = _args(N, T, K, D, cuda, dtype=torch.float32)
    st = stream.init_state(N, 3, T, device=cuda)
    _, idx, mb = stream.advance(st, mask, 1, B)
    assert float(mb.max()) == pytest.approx(T / B, rel=1e-6)
    xb = torch.gather(x, 1, idx[..., None].expand(N, B, D)).to(dtype)
    mb = mb.to(dtype)
    got = ops.gmm_estep_nodes(xb, mb, *terms)
    want = ge.gmm_estep_nodes_plain(
        xb, mb, *terms, dtype=torch.float64 if D > 8 else torch.float32)
    scale = T / B
    _check([g / scale for g in got],
           [(w / scale).to(g.dtype) for g, w in zip(got, want)])


def test_full_batch_streaming_bit_exact_on_card(cuda):
    K, D, N, T = 3, 2, 40, 512
    data = synthetic.paper_synthetic(n_nodes=N, n_per_node=T, seed=2,
                                     dtype=np.float32)
    prior = expfam.noninformative_prior(K, D, beta0=0.1, w0_scale=10.0,
                                        device=cuda)
    adj, _ = network.random_geometric_graph(N, seed=4)
    W = network.nearest_neighbor_weights(adj)
    mdl = model_lib.GMMModel(prior, backend="fused", device=cuda)
    full = engine.run_vb(mdl, (data.x, data.mask), engine.Diffusion(W),
                         n_iters=10)
    for cv in (None, "svrg"):
        got = engine.run_vb(mdl, (data.x, data.mask), engine.Diffusion(W),
                            n_iters=10,
                            minibatch=stream.MinibatchSpec(T, 1, cv))
        assert torch.equal(got.phi, full.phi)
        assert torch.equal(got.kl_nodes, full.kl_nodes)


# ---------------------------------------------------------------------------
# sparse topologies: deterministic segmented sums, resume, CPU vs card
# ---------------------------------------------------------------------------
def _sparse_topologies(g, n):
    sw = network.sparse_nearest_neighbor_weights(g)
    gw, rg = network.two_level_partition(n, max(1, n // 16),
                                         max(1, n // 128))
    return {
        "diffusion_drop": lambda: engine.Diffusion(sw, link_drop=0.2,
                                                   link_seed=1),
        "ring_drop": lambda: engine.RingDiffusion(
            graph=network.SparseGraph.ring(n), link_drop=0.2),
        "gossip": lambda: engine.PairwiseGossip(g, p_activate=0.3, seed=5),
        "hierarchical": lambda: engine.HierarchicalFusion(gw, rg),
        "admm_adaptive_drop": lambda: engine.ADMMConsensus(
            g, adaptive_rho=True, per_block=True, link_drop=0.2),
    }


def test_sparse_combine_repeat_determinism(cuda):
    n = 10_000
    g, _ = network.random_geometric_edges(n, seed=0)
    v = torch.rand(n, 27, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)).to(cuda)
    for name, make in _sparse_topologies(g, n).items():
        topo = make().to(cuda)
        if isinstance(topo, engine.ADMMConsensus):
            outs = [topo._graph_ops(v, 3) for _ in range(2)]
            a, b = ([o[0], o[1](v)] for o in outs)
        else:
            a, b = ([topo.combine(v, t=3)] for _ in range(2))
        for x, y in zip(a, b):
            assert torch.equal(x, y), name


def _sparse_instance(n, T, dev):
    data = synthetic.paper_synthetic(n_nodes=n, n_per_node=T, seed=0)
    prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                        device=dev)
    g, _ = network.random_geometric_edges(n, seed=0)
    return data, prior, g


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_sparse_split_resume_and_checkpoint_on_card(cuda, tmp_path,
                                                    backend):
    n = 1000
    data, prior, g = _sparse_instance(n, 64, cuda)
    mdl = model_lib.GMMModel(prior, backend=backend, device=cuda)
    for name, make in _sparse_topologies(g, n).items():
        kw = ({} if name.startswith("admm")
              else dict(schedule=engine.Schedule()))

        def fresh():
            return engine.vb_init(mdl, (data.x, data.mask), make(),
                                  device=cuda, **kw)

        whole, _ = engine.vb_run(fresh(), 12)
        part, _ = engine.vb_run(fresh(), 5)
        path = ckpt.save(str(tmp_path / f"{name}.npz"), part)
        split, _ = engine.vb_run(part, 7)
        resumed, _ = engine.vb_run(ckpt.restore(path, fresh()), 7)
        for got in (split, resumed):
            assert torch.equal(got.phi, whole.phi), name
            if whole.carry is not None:
                for x, y in zip(got.carry, whole.carry):
                    assert torch.equal(x, y), name


def test_sparse_session_cpu_vs_card(cuda):
    """One iteration of the same sparse session on the CPU and the card
    (reference backend, f64): the same link and gossip coins, phi within
    1e-12 relative."""
    n = 1000
    data, prior, g = _sparse_instance(n, 20, "cpu")
    for name, make in _sparse_topologies(g, n).items():
        kw = ({} if name.startswith("admm")
              else dict(schedule=engine.Schedule()))
        phis = {}
        for dev in ("cpu", cuda):
            mdl = model_lib.GMMModel(prior.to(dev), device=dev)
            st = engine.vb_init(mdl, (data.x, data.mask), make(), device=dev,
                                **kw)
            phis[str(dev)] = engine.vb_step(st).phi.cpu()
        a, b = phis["cpu"], phis["cuda"]
        assert float((a - b).abs().max() / a.abs().max()) <= 1e-12, name
    for t in (0, 9):
        coins = [network.sparse_link_keep(network.link_generator(5, t, d),
                                          g.n_undirected, 0.7).cpu()
                 for d in ("cpu", cuda)]
        assert torch.equal(*coins)


# ---------------------------------------------------------------------------
# Multi-tenant serving: the fleet on the card
# ---------------------------------------------------------------------------
def _fleet_env(dev, n=64, T=512, tenants=4):
    from repro_torch.serving import vb_service
    prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                        device=dev)
    mdl = model_lib.GMMModel(prior, 3, 2, backend="fused", device=dev)
    adj, _ = network.random_geometric_graph(n, seed=0)
    data = []
    for s in range(tenants):
        d = synthetic.paper_synthetic(n_nodes=n, n_per_node=T, seed=s,
                                      dtype=np.float32)
        data.append((d.x.to(dev), d.mask.to(dev)))
    return vb_service, mdl, adj, data


def test_fleet_one_launch_per_iteration_and_kernel_at_fleet_shape(cuda):
    """A 4-slot fleet of 64-node tenants launches gmm_estep_nodes once a
    fleet iteration over (4 x 64, T, D); the kernel on the fleet's
    buffers and final iterate matches its plain version at the TOL
    bars."""
    vs, mdl, adj, data = _fleet_env(cuda)
    svc = vs.VBService(slice_iters=5, max_fleet=4, device=cuda)
    for i, d in enumerate(data):
        svc.submit(vs.VBRequest(model=mdl, data=d,
                                topology=engine.RingDiffusion(),
                                n_iters=10 + 5 * i))
    ops.gmm_estep_nodes.launches = 0
    svc.run()
    st = svc.stats()
    assert ops.gmm_estep_nodes.launches == st.slices * 5
    (g,) = svc._groups.values()
    x, mask = (a.reshape((-1,) + a.shape[2:]) for a in g.stream_data)
    assert x.shape == (4 * 64, 512, 2)
    q = expfam.unpack_natural(g.phi.reshape(x.shape[0], -1), 3, 2)
    shift = q.m.float().contiguous()
    terms = [t.contiguous() for t in gmm.estep_terms(q, torch.float32,
                                                     shift=shift)]
    _check(ops.gmm_estep_nodes(x, mask, *terms, shift=shift,
                               return_r=False),
           ge.gmm_estep_nodes_plain(x, mask, *terms, shift=shift,
                                    return_r=False))


@pytest.mark.parametrize("topo_name", ["ring_drop", "diffusion", "admm"])
def test_fleet_matches_solo_on_card(cuda, topo_name):
    """Each tenant served in a fleet against a solo vb_run of its budget
    on the card: the ring (an elementwise combine, per-slot link coins)
    bit-equal, the matmul combines within 1e-9 relative."""
    vs, mdl, adj, data = _fleet_env(cuda)
    W = network.nearest_neighbor_weights(adj)
    make = {"ring_drop": lambda: engine.RingDiffusion(link_drop=0.2,
                                                      link_seed=1),
            "diffusion": lambda: engine.Diffusion(W),
            "admm": lambda: engine.ADMMConsensus(adj, adaptive_rho=True)}
    topo = make[topo_name]()
    budgets = [12, 20, 8, 16]
    svc = vs.VBService(slice_iters=6, max_fleet=3, device=cuda)
    rids = [svc.submit(vs.VBRequest(model=mdl, data=d, topology=topo,
                                    n_iters=n))
            for d, n in zip(data, budgets)]
    out = svc.run()
    assert svc.stats().compiles == 1
    for d, n, rid in zip(data, budgets, rids):
        solo = engine.run_vb(mdl, d, make[topo_name](), n_iters=n,
                             device=cuda)
        got = out[rid].phi
        if topo_name == "ring_drop":
            assert torch.equal(solo.phi, got), rid
        else:
            rel = float((solo.phi - got).abs().max() / solo.phi.abs().max())
            assert rel <= 1e-9, (rid, rel)


def test_checkpoint_snapshot_while_next_slice_overwrites(cuda, tmp_path):
    """`save_session(wait=False)` clones the slot at the boundary; the
    next slice, queued at once, overwrites the fleet in place while the
    writer copies: the file holds the boundary state (bit-equal to a solo
    run of that many iterations), and so do the periodic autosaves."""
    vs, mdl, adj, data = _fleet_env(cuda)
    topo = engine.RingDiffusion()
    svc = vs.VBService(slice_iters=4, max_fleet=2, device=cuda,
                       ckpt_dir=str(tmp_path / "auto"), ckpt_every=1)
    rids = [svc.submit(vs.VBRequest(model=mdl, data=d, topology=topo,
                                    n_iters=16)) for d in data[:2]]
    svc.step_slice()
    path = svc.save_session(rids[0], str(tmp_path / "mid.npz"), wait=False)
    svc.step_slice()                    # overwrites the fleet meanwhile
    svc.driver.flush_checkpoints()
    arrays = ckpt.read_npz(path)
    assert int(arrays["['t']"]) == 4
    solo = engine.run_vb(mdl, data[0], topo, n_iters=4, device=cuda)
    assert torch.equal(torch.as_tensor(arrays["['phi']"]),
                       solo.phi.cpu())
    svc.run()
    for rid, d in zip(rids, data):
        auto = ckpt.read_npz(str(tmp_path / "auto" / f"{rid}.npz"))
        t = int(auto["['t']"])
        solo = engine.run_vb(mdl, d, topo, n_iters=t, device=cuda)
        assert torch.equal(torch.as_tensor(auto["['phi']"]), solo.phi.cpu())
