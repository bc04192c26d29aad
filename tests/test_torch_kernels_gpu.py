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
The fleet's CUDA graph: on nine topologies and both GMM backends the
graphed fleet (join, leave, mixed taus and budgets, an early stop)
equals the eager loop bit for bit with as many kernel launches, one
capture per capacity (growth included) and a replay for every other
fleet iteration; the profiler sees the replayed kernels.
Telemetry: one `kernel/<name>` span a launch, recorded without waiting
for the device and with no CUDA event.  The mesh
executor: under a one-rank NCCL group (`admission.data_axis_mesh`) runs
and a serving fleet bit-equal to the single-array executor; gmm_estep
launched on a row slice (a rank's block of nodes) bit-equal to the same
rows of the whole launch, on each of the kernel's three paths.  The LM
families: flash_attention at head_dim 256 (RecurrentGemma-2B's MQA), and
one bf16 train step of the MoE and rec smoke configs against the CPU.
The LM sharding: on a (1, 1) mesh over a one-rank NCCL group the bf16
smoke configs' prefill logits bit-equal to no mesh (the kernels launched
once a layer on their shards) and `Engine(mesh=)`'s tokens equal.
"""
import json

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


@pytest.mark.parametrize("B,S,Hq,Hkv,window,dtype", [
    (2, 300, 4, 1, 0, torch.bfloat16), (2, 300, 4, 1, 64, torch.bfloat16),
    (1, 200, 4, 2, 32, torch.float32),
    # RecurrentGemma-2B's prefill: MQA, 10 query heads, window 2048
    (4, 2048, 10, 1, 2048, torch.bfloat16)])
def test_flash_attention_head_dim_256(cuda, B, S, Hq, Hkv, window, dtype):
    """hd 256, where the bf16 kernel's two warpgroups split the output
    columns: causal, windowed and MQA against the plain version (2e-2 in
    bf16, 2e-5 in f32), two launches bit-identical."""
    g = torch.Generator(cuda).manual_seed(S + window)
    q, k, v = (torch.randn(B, S, h, 256, generator=g, device=cuda).to(dtype)
               for h in (Hq, Hkv, Hkv))
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    want = fa.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert torch.equal(got, again)


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of each entry of |x| in `dtype` (bf16
    keeps 8 significant bits, f32 24)."""
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - bits)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "recurrentgemma_2b"])
def test_bf16_train_step_card_vs_cpu(cuda, arch):
    """One bf16 allreduce step of the MoE and rec smoke configs on the
    card against the same step on the CPU from the same state: the MoE
    scatter, the RG-LRU scan and remat on the device.  bf16 keeps 8 bits
    (3.9e-3 a rounding, several along the chain) and the two devices sum
    in other orders, so the loss is held at 1e-2 relative, and each
    tensor's clipped gradient, read from the first moment mu = (1 - b1)
    g, at 2e-2 of its norm (nu = (1 - b2) g^2 at 4e-2).  On each device
    every parameter entry must be AdamW's update of the start from that
    device's own moments, to one ulp of its dtype (plus f32 roundings of
    the update): the parameters then differ between the devices only as
    the moments do.  (The first step
    moves an entry by lr x g / (|g| + eps), so an entry whose gradient
    differs in sign on the two devices, at rounding level, moves by
    +-lr: the test prints how many do.)"""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import tokens
    from repro_torch.training import train_step as ts
    b1, b2, eps = 0.9, 0.95, 1e-8           # adamw.update's defaults
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16",
                                         compute_dtype="bfloat16")
    hyper = ts.TrainHyper(peak_lr=1e-3, warmup=0, total_steps=10)
    cpu = ts.init_state(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    start = {n: p.detach().float().clone()
             for n, p in cpu.params.named_parameters()}
    card = ts.train_state_to(cpu, cuda)
    batch = tokens.Batcher(cfg.vocab_size, 4, 32).next_batch()
    step = ts.make_train_step(cfg, hyper=hyper)
    cpu, m_cpu = step(cpu, ts.batch_to(batch, "cpu"))
    card, m_card = step(card, ts.batch_to(batch, cuda))
    torch.cuda.synchronize()
    assert float(m_card["lr"]) == float(m_cpu["lr"])
    lr = float(np.float32(float(m_cpu["lr"])))
    bc1 = float(np.float32(1.0) - np.float32(b1))
    bc2 = float(np.float32(1.0) - np.float32(b2))

    def ulps_from_adamw(state, name):
        """Largest distance of the state's parameter from AdamW's update
        of the start by the state's own moments, in units of one ulp of
        the parameter's dtype plus 4 f32 ulps of the update's terms (the
        card divides by a scalar as a product with its reciprocal, so
        an f32 parameter may differ by an f32 rounding or two)."""
        p = state.params.get_parameter(name).detach()
        mu, nu = (m[name].cpu() for m in (state.opt.mu, state.opt.nu))
        ratio = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        decay = hyper.weight_decay * start[name]
        want = (start[name] - lr * (ratio + decay)).to(p.dtype).float()
        got = p.cpu().float()
        tol = _ulp(torch.maximum(got.abs(), want.abs()), p.dtype) \
            + 4 * _ulp(lr * (ratio.abs() + decay.abs()), torch.float32)
        return float(((got - want).abs() / tol).max())

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    want = dict(cpu.params.named_parameters())
    report = {}
    for name, p in card.params.named_parameters():
        assert p.dtype == want[name].dtype
        got, ref = p.detach().cpu().float(), want[name].detach().float()
        mu_card, mu_cpu = card.opt.mu[name].cpu(), cpu.opt.mu[name]
        report[name] = {
            "grad_rel_err": rel(mu_card, mu_cpu),
            "nu_rel_err": rel(card.opt.nu[name].cpu(), cpu.opt.nu[name]),
            "card_update_ulps": ulps_from_adamw(card, name),
            "cpu_update_ulps": ulps_from_adamw(cpu, name),
            "sign_flips": int((torch.sign(mu_card)
                               != torch.sign(mu_cpu)).sum()),
            "past_one_ulp": int(((got - ref).abs() > _ulp(
                torch.maximum(got.abs(), ref.abs()), p.dtype)).sum()),
            "numel": p.numel()}
    print(arch, json.dumps(report))
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-2)
    for name, r in report.items():
        assert r["grad_rel_err"] <= 2e-2, (name, r)
        assert r["nu_rel_err"] <= 4e-2, (name, r)
        assert r["card_update_ulps"] <= 1 and r["cpu_update_ulps"] <= 1, \
            (name, r)


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
    # the slices above were replays of the fleet's captured iteration
    (g,) = svc._groups.values()
    assert g._graph is not None


# ---------------------------------------------------------------------------
# The fleet's iteration as a CUDA graph (serving/driver.py `_run_graphed`)
# ---------------------------------------------------------------------------
def _graph_topology(name, adj):
    g = network.SparseGraph.from_dense(adj)
    gw, rg = network.two_level_partition(adj.shape[0], 8, 2)
    W = network.nearest_neighbor_weights(adj)
    return {
        "diffusion": lambda: engine.Diffusion(W),
        "diffusion_drop": lambda: engine.Diffusion(W, link_drop=0.2,
                                                   link_seed=2),
        "sparse_diffusion_drop": lambda: engine.Diffusion(
            network.sparse_nearest_neighbor_weights(g), link_drop=0.2),
        "ring": engine.RingDiffusion,
        "ring_drop": lambda: engine.RingDiffusion(link_drop=0.2,
                                                  link_seed=1),
        "fusion": engine.FusionCenter,
        "isolated": engine.Isolated,
        "gossip": lambda: engine.PairwiseGossip(g, p_activate=0.5, seed=3),
        "hierarchical": lambda: engine.HierarchicalFusion(gw, rg),
    }[name]


def _serve_counted(vs, mdl, topo, reqs, **kw):
    """Serve `reqs` ((data, n_iters, tau, tol, arrive_at)) under host
    telemetry; (service, rids, results, counters, gmm_estep launches)."""
    from repro_torch import telemetry
    telemetry.reset()
    before = ops.gmm_estep_nodes.launches
    with telemetry.enabled_scope():
        svc = vs.VBService(device=mdl.device, **kw)
        rids = [svc.submit(vs.VBRequest(
            model=mdl, data=d, topology=topo, n_iters=n,
            schedule=engine.Schedule(tau=tau), tol=tol), arrive_at=at)
            for d, n, tau, tol, at in reqs]
        out = svc.run()
    rows = {r["name"]: r["value"] for r in telemetry.snapshot()
            if "value" in r}
    telemetry.reset()
    return svc, rids, out, rows, ops.gmm_estep_nodes.launches - before


@pytest.mark.parametrize("topo_name,backend", [
    ("diffusion", "fused"), ("diffusion", "reference"),
    ("diffusion_drop", "fused"), ("sparse_diffusion_drop", "fused"),
    ("ring", "fused"), ("ring_drop", "fused"), ("fusion", "fused"),
    ("isolated", "fused"), ("gossip", "fused"), ("hierarchical", "fused")])
def test_graphed_fleet_bit_equal_eager_and_solo(cuda, monkeypatch,
                                                topo_name, backend):
    """Join and leave with mixed taus and budgets, one tenant stopping
    early (tol > 0), through a 3-slot fleet: the graph path's results
    and launch count equal the eager loop's bit for bit (the rule forced
    off), one capture and a replay for every fleet iteration but the
    capture slice's warm-up; each tenant against its solo run as
    `test_fleet_matches_solo_on_card` holds it."""
    from repro_torch.serving import driver as drv
    vs, mdl, adj, data = _fleet_env(cuda)
    mdl = mdl.with_backend(backend)
    make = _graph_topology(topo_name, adj)
    # a tol the third tenant's rms step falls under by iteration 8
    a, b = (engine.run_vb(mdl, data[2], make(), n_iters=n,
                          schedule=engine.Schedule(tau=0.5), device=cuda)
            for n in (7, 8))
    tol = 1.5 * float(torch.sqrt(((b.phi - a.phi) ** 2).mean()))
    reqs = [(data[0], 12, 0.2, 0.0, None), (data[1], 20, 0.1, 0.0, None),
            (data[2], 30, 0.5, tol, None), (data[3], 16, 0.2, 0.0, 1)]
    runs = {}
    for path in ("graph", "eager"):
        if path == "eager":
            monkeypatch.setattr(drv, "_graph_eligible", lambda *a: False)
        runs[path] = _serve_counted(vs, mdl, make(), reqs, slice_iters=6,
                                    max_fleet=3)
    (svc, rids, out, rows, launches), (esvc, erids, eout, erows,
                                       elaunches) = runs.values()
    st = svc.stats()
    iters = st.slices * 6
    assert st.compiles == esvc.stats().compiles == 1
    assert rows["driver_graph_captures_total"] == 1
    assert rows["driver_graph_replays_total"] == iters - drv.GRAPH_WARMUP
    assert erows["driver_graph_replays_total"] == 0
    assert "driver_graph_captures_total" not in erows
    assert launches == elaunches == (iters if backend == "fused" else 0)
    assert out[rids[2]].converged and out[rids[2]].t <= 8
    for (d, n, tau, _, _), rid, erid in zip(reqs, rids, erids):
        s = out[rid]
        assert torch.equal(s.phi, eout[erid].phi), rid
        assert (s.t, s.converged) == (eout[erid].t, eout[erid].converged)
        solo = engine.run_vb(mdl, d, make(), n_iters=s.t,
                             schedule=engine.Schedule(tau=tau), device=cuda)
        if topo_name in ("ring", "ring_drop", "isolated"):
            assert torch.equal(solo.phi, s.phi), rid
        else:
            rel = float((solo.phi - s.phi).abs().max()
                        / solo.phi.abs().max())
            assert rel <= 1e-9, (rid, rel)


def test_graphed_fleet_recaptures_once_per_capacity(cuda, monkeypatch):
    """`max_fleet=None`: arrivals at slices 0, 1 and 2 grow the fleet
    1 -> 2 -> 4; each capacity captures once (as many captures as
    compiles), and the results equal the eager loop's bit for bit."""
    from repro_torch.serving import driver as drv
    vs, mdl, adj, data = _fleet_env(cuda)
    topo = engine.Diffusion(network.nearest_neighbor_weights(adj))
    reqs = [(data[0], 24, 0.2, 0.0, 0), (data[1], 20, 0.1, 0.0, 1),
            (data[2], 16, 0.5, 0.0, 2), (data[3], 12, 0.2, 0.0, 2)]
    svc, rids, out, rows, launches = _serve_counted(
        vs, mdl, topo, reqs, slice_iters=5, max_fleet=None)
    monkeypatch.setattr(drv, "_graph_eligible", lambda *a: False)
    esvc, erids, eout, erows, elaunches = _serve_counted(
        vs, mdl, topo, reqs, slice_iters=5, max_fleet=None)
    st = svc.stats()
    assert st.capacity == 4 and st.compiles == 3
    assert rows["driver_graph_captures_total"] == 3
    assert rows["driver_graph_replays_total"] == \
        st.slices * 5 - 3 * drv.GRAPH_WARMUP
    assert launches == elaunches == st.slices * 5
    for rid, erid in zip(rids, erids):
        assert torch.equal(out[rid].phi, eout[erid].phi), rid


def test_profiler_sees_the_replayed_kernels(cuda):
    """Under torch.profiler the replays' kernels are device events: a
    gmm_estep kernel a fleet iteration, as many as the launch counter
    adds, and one replay counted a fleet iteration."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry
    vs, mdl, adj, data = _fleet_env(cuda)
    topo = engine.Diffusion(network.nearest_neighbor_weights(adj))
    svc = vs.VBService(slice_iters=5, max_fleet=2, device=cuda)
    for d in data[:2]:
        svc.submit(vs.VBRequest(model=mdl, data=d, topology=topo,
                                n_iters=40))
    svc.step_slice()                    # captures
    torch.cuda.synchronize()
    telemetry.reset()
    before = ops.gmm_estep_nodes.launches
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            svc.step_slice()
            svc.step_slice()
            torch.cuda.synchronize()
        rows = {r["name"]: r["value"] for r in telemetry.snapshot()
                if "value" in r}
    finally:
        telemetry.reset()
    kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA"
                  and "gmm_estep" in e.name
                  and not getattr(e, "is_user_annotation", False))
    assert kernels == ops.gmm_estep_nodes.launches - before == 10
    assert rows["driver_graph_replays_total"] == 10
    assert rows["driver_fleet_iterations_total"] == 10


# ---------------------------------------------------------------------------
# Telemetry: a span a launch, no device timer
# ---------------------------------------------------------------------------
def test_kernel_wall_time_counts_launches_without_syncing(cuda):
    """With telemetry on, each gmm_estep_nodes launch is one
    `kernel/gmm_estep_nodes` span (the spans equal the launches) and no
    metric, recorded without waiting: behind a ~0.2 s device sleep the
    calls return while the stream still has work, and no CUDA event is
    made.  Under the profiler (telemetry off) each launch is also a
    `kernel/gmm_estep_nodes` range whose device-side mirror is marked a
    user annotation, beside the kernel itself."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry
    args = _args(64, 512, 3, 2, cuda)
    telemetry.disable()
    telemetry.reset()
    ops.gmm_estep_nodes(*args)                  # built and warm
    torch.cuda.synchronize()
    before = ops.gmm_estep_nodes.launches
    made = []
    event_init = torch.cuda.Event.__init__

    def counted(self, *a, **kw):
        made.append(1)
        event_init(self, *a, **kw)

    try:
        torch.cuda.Event.__init__ = counted
        telemetry.enable()
        torch.cuda._sleep(int(2e8))             # ~0.1-0.2 s on the card
        for _ in range(5):
            ops.gmm_estep_nodes(*args)
        assert not torch.cuda.current_stream().query()
        launched = ops.gmm_estep_nodes.launches - before
        spans = [e for e in telemetry.tracer().events
                 if e["name"] == "kernel/gmm_estep_nodes"]
        assert len(spans) == launched == 5
        assert telemetry.tracer().span_names() == ["kernel/gmm_estep_nodes"]
        assert len(telemetry.registry()) == 0 and not made
        torch.cuda.synchronize()
        telemetry.disable()
        telemetry.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ops.gmm_estep_nodes(*args)
            torch.cuda.synchronize()
        ranges = [e for e in prof.events()
                  if e.name == "kernel/gmm_estep_nodes"]
        host = [e for e in ranges if e.device_type.name == "CPU"]
        mirrors = [e for e in ranges if e.device_type.name == "CUDA"]
        assert len(host) == 3 and not made
        assert all(getattr(e, "is_user_annotation", True) for e in mirrors)
        assert sum(1 for e in prof.events() if e.device_type.name == "CUDA"
                   and "gmm_estep" in e.name
                   and not getattr(e, "is_user_annotation", False)) == 3
        assert len(telemetry.tracer()) == 3
    finally:
        torch.cuda.Event.__init__ = event_init
        telemetry.disable()
        telemetry.reset()


@pytest.mark.parametrize("K,D", [(3, 2), (8, 2), (2, 34)])
def test_gmm_estep_row_slices_bit_equal(cuda, K, D):
    """A rank launches the kernel on its own rows: each statistic is a
    node's own, so a launch over rows lo:hi equals those rows of the
    whole launch bit for bit (register, shared-memory and wide paths)."""
    x, mask, *terms = _args(64, 300, K, D, cuda, seed=K + D)
    shift = torch.randn(64, K, D, device=cuda)
    whole = ops.gmm_estep_nodes(x, mask, *terms, 64.0, shift=shift)
    for lo, hi in ((0, 32), (32, 64), (16, 48)):
        part = ops.gmm_estep_nodes(
            x[lo:hi].contiguous(), mask[lo:hi].contiguous(),
            *(t[lo:hi].contiguous() for t in terms), 64.0,
            shift=shift[lo:hi].contiguous())
        for p, w in zip(part, whole):
            assert torch.equal(p, w[lo:hi]), (ge.kernel_variant(K, D), lo)


def test_one_rank_nccl_executor_bit_equal(cuda):
    """The executor under a one-rank NCCL group gives the single-array
    executor's bits: runs of each collective's topology, and a serving
    fleet of rings with link drops."""
    import torch.distributed as dist

    from repro_torch.serving import admission, vb_service

    made = not dist.is_initialized()
    ex = admission.data_axis_mesh(device=cuda)
    try:
        data = synthetic.paper_synthetic(n_nodes=8, n_per_node=40, seed=1)
        x, mask = data.x.to(cuda), data.mask.to(cuda)
        prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                            device=cuda)
        mdl = model_lib.GMMModel(prior, 3, 2, backend="fused", device=cuda)
        adj, _ = network.random_geometric_graph(8, seed=3)
        W = network.nearest_neighbor_weights(adj)
        for topo, kw in (
                (engine.Diffusion(W), {}),
                (engine.RingDiffusion(link_drop=0.2), {}),
                (engine.ADMMConsensus(adj, adaptive_rho=True,
                                      per_block=True), {}),
                (engine.FusionCenter(), dict(schedule=engine.ONE_SHOT))):
            a = engine.run_vb(mdl, (x, mask), topo, n_iters=10, **kw)
            b = engine.run_vb(mdl, (x, mask), topo, n_iters=10,
                              executor=ex, **kw)
            for u, v in ((a.phi, b.phi), (a.kl_nodes, b.kl_nodes),
                         (a.consensus_err, b.consensus_err)):
                assert torch.equal(u, v), type(topo).__name__
            if a.consensus_diag is not None:
                assert all(torch.equal(u, v) for u, v in zip(
                    a.consensus_diag, b.consensus_diag))
        ring = engine.RingDiffusion(link_drop=0.2)
        phis = []
        for executor in (None, ex):
            svc = vb_service.VBService(slice_iters=4, max_fleet=2,
                                       executor=executor, device=cuda)
            rids = [svc.submit(vb_service.VBRequest(
                model=mdl, data=(x, mask), topology=ring, n_iters=9,
                schedule=engine.Schedule(tau=tau))) for tau in (0.2, 0.1)]
            out = svc.run()
            phis.append([out[r].phi for r in rids])
        assert all(torch.equal(u, v) for u, v in zip(*phis))
    finally:
        if made:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m", "recurrentgemma_2b",
                                  "granite_moe_3b_a800m"])
def test_one_rank_mesh_lm_bit_equal(cuda, arch):
    """The LM sharding's DTensor path on a (1, 1) mesh over a one-rank
    NCCL group, bf16 smoke configs with the kernels: the prefill logits
    bit-equal to no mesh, each kernel launched once a layer on its
    shard, and the greedy tokens of `Engine(mesh=)` equal."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as lm_model
    from repro_torch.serving import engine as lm_engine

    made = not dist.is_initialized()
    mesh = mesh_lib.make_test_mesh(1, 1, device=cuda)
    try:
        cfg = get_smoke_config(arch).replace(param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
        lm = lm_model.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                                  device=cuda)
        toks = torch.randint(0, cfg.vocab_size, (4, 64), device=cuda,
                             generator=torch.Generator(cuda).manual_seed(1))
        with torch.no_grad():
            want = lm_model.forward(cfg, lm, toks, use_kernels=True)
        dl = sharding.distribute_copy(lm, mesh, sharding.param_shardings(
            dict(lm.named_parameters()), mesh,
            scanned=lm_model._homogeneous(cfg)))
        for fn in (ops.flash_attention, ops.ssd_scan):
            fn.launches = 0
        with torch.no_grad(), sharding.use_mesh(mesh):
            got = lm_model.forward(cfg, dl, sharding.to_dtensor(
                toks, mesh, sharding.placements_for(mesh, batch=4)),
                use_kernels=True)
        kinds = cfg.layer_kinds()
        assert ops.flash_attention.launches == kinds.count("attn")
        assert ops.ssd_scan.launches == kinds.count("ssm")
        assert torch.equal(got["logits"].full_tensor(), want["logits"])
        rng = np.random.default_rng(0)
        reqs = [lm_engine.Request(rng.integers(0, cfg.vocab_size, 32)
                                  .astype(np.int32), 8) for _ in range(4)]
        outs = [lm_engine.Engine(cfg, lm, max_seq=48, use_kernels=True,
                                 device=cuda, mesh=m).generate(reqs)
                for m in (None, mesh)]
        assert all(np.array_equal(a, b) for a, b in zip(*outs))
    finally:
        if made:
            dist.destroy_process_group()
