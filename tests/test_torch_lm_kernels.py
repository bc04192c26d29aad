"""The port's flash-attention and SSD-scan wrappers (their plain versions on
the CPU) against the JAX package's Pallas kernels in interpret mode and
its `kernels/ref.py` oracles, at every tests/test_kernels.py shape, with
that file's tolerances: flash atol 2e-5 (f32) / 2e-2 (bf16), causality
atol 1e-5; ssd atol 5e-5 against ref.ssd and the kernel, 1e-5 against
`mamba2.ssd_chunked`.  Inputs are drawn with numpy and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import mamba2 as jmamba2
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2

FLASH_SHAPES = [(2, 64, 4, 2, 32), (1, 128, 2, 1, 64),
                (2, 96, 4, 4, 16),      # S not a multiple of the block
                (1, 256, 8, 2, 128)]
SSD_SHAPES = [(2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
              (2, 64, 2, 8, 4, 64),     # single chunk
              (1, 96, 3, 16, 8, 32)]    # 3 chunks


def _both(a, dtype):
    """numpy f32 -> (jax array, torch tensor), both rounded to `dtype`."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 32])
def test_flash_attention_sweep(B, S, Hq, Hkv, hd, dtype, window):
    rng = np.random.default_rng(S + hd)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.normal(size=shape).astype(np.float32), dtype)
        for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    assert ops.flash_attention.launches == before   # the CPU runs no kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    g = Hq // Hkv
    want_ref = jnp.moveaxis(ref.attention(
        jnp.moveaxis(jq, 2, 1), jnp.moveaxis(jnp.repeat(jk, g, 2), 2, 1),
        jnp.moveaxis(jnp.repeat(jv, g, 2), 2, 1), window=window), 1, 2)
    want_kernel = jops.flash_attention(jq, jk, jv, window=window)
    tol = 2e-5 if dtype == "f32" else 2e-2
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_flash_attention_causality():
    """Future tokens must not influence output (hard property), and the
    port agrees with the JAX kernel on both inputs."""
    rng = np.random.default_rng(1)
    B, S, H, hd = 1, 64, 2, 32
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    k2, v2 = k.copy(), v.copy()
    k2[:, S // 2:] = 99.0
    v2[:, S // 2:] = -99.0
    t = torch.tensor
    out1 = ops.flash_attention(t(q), t(k), t(v))
    out2 = ops.flash_attention(t(q), t(k2), t(v2))
    np.testing.assert_allclose(_np(out1[:, :S // 2]), _np(out2[:, :S // 2]),
                               atol=1e-5, rtol=0)
    # the second half's outputs reach 99 in magnitude: the f32 bar there
    # is relative (1e-6, a few ulp), on top of the sweep's atol
    for kk, vv, got in ((k, v, out1), (k2, v2, out2)):
        want = jops.flash_attention(jnp.asarray(q), jnp.asarray(kk),
                                    jnp.asarray(vv))
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5,
                                   rtol=1e-6)


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(B, S, H))), np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_sweep(B, S, H, P, N, chunk):
    args = _ssd_inputs(B, S, H, P, N, S + P)
    before = ops.ssd_scan.launches
    y, h = ops.ssd_scan(*map(torch.tensor, args), chunk=chunk)
    assert ops.ssd_scan.launches == before
    jargs = tuple(map(jnp.asarray, args))
    for want_y, want_h in (ref.ssd(*jargs),
                           jops.ssd_scan(*jargs, chunk=chunk)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=5e-5, rtol=0)
        np.testing.assert_allclose(_np(h), _np(want_h), atol=5e-5, rtol=0)


def test_ssd_matches_model_chunked():
    """The wrapper == the JAX model's plain chunked path, and the port's
    `ssd_chunked` == the JAX one."""
    args = _ssd_inputs(2, 128, 4, 16, 8, 7)
    jy, jh = jmamba2.ssd_chunked(*map(jnp.asarray, args), 32)
    for y, h in (ops.ssd_scan(*map(torch.tensor, args), chunk=32),
                 mamba2.ssd_chunked(*map(torch.tensor, args), 32)):
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(h), _np(jh), atol=1e-5, rtol=0)


def test_ssd_scan_bf16_casts_once():
    """bf16 x: the plain version computes in f32 and rounds y once (the
    TPU kernel's contract), so it equals the f32 result rounded."""
    x, dt, A, Bm, Cm = map(torch.tensor, _ssd_inputs(1, 64, 2, 16, 8, 3))
    xb, Bb, Cb = (a.to(torch.bfloat16) for a in (x, Bm, Cm))
    y, h = ops.ssd_scan(xb, dt, A, Bb, Cb, chunk=16)
    y32, h32 = ss.ssd_scan_plain(xb.float(), dt, A, Bb.float(), Cb.float(),
                                 chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    assert torch.equal(h, h32)


def test_wrapper_input_checks():
    t = lambda *s, dtype=torch.float32: torch.zeros(*s, dtype=dtype)
    q, k = t(1, 16, 4, 32), t(1, 16, 2, 32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="dtypes"):
        ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="hd in"):
        ops.flash_attention(t(1, 16, 4, 48), t(1, 16, 2, 48),
                            t(1, 16, 2, 48))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(t(1, 16, 3, 32), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(t(1, 4, 16, 32).transpose(1, 2), k, k)
    x, dt, A, Bm, Cm = t(1, 96, 2, 8), t(1, 96, 2), t(2), t(1, 96, 4), \
        t(1, 96, 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    with pytest.raises(TypeError, match="dt must be"):
        ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    with pytest.raises(TypeError, match="Bm must be"):
        ops.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=32)
    with pytest.raises(ValueError, match="Cm must be"):
        ops.ssd_scan(x, dt, A, Bm, t(1, 96, 5), chunk=32)
    assert ss.smem_bytes(128, 64) <= ss.MAX_SMEM_BYTES
    assert fa.smem_bytes(128) <= fa.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd_scan(t(1, 32, 1, 256), t(1, 32, 1), t(1), t(1, 32, 256),
                     t(1, 32, 256), chunk=32)


# ---------------------------------------------------------------------------
# The CUDA kernels' schedules, rendered in plain PyTorch on the CPU (helpers
# of this file, on no path), against the JAX package
# ---------------------------------------------------------------------------
def _ssd_three_pass(x, dt, A, Bm, Cm, L):
    """csrc/ssd_scan.cu's schedule: (a) chunk states, (b) state passing,
    (c) chunk scan with G = C B^T formed once per (batch, chunk) for every
    head; a ragged last chunk zero-padded.  Returns (y, final state
    (B, H, P, N))."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // L)
    pad = lambda a: torch.nn.functional.pad(
        a, (0,) * (2 * (a.dim() - 2)) + (0, nc * L - S))
    xc = pad(x).reshape(Bb, nc, L, H, P)
    dtc = pad(dt).reshape(Bb, nc, L, H)
    Bc, Cc = (pad(a).reshape(Bb, nc, L, N) for a in (Bm, Cm))
    cum = torch.cumsum(dtc * A, dim=2)                       # (B,nc,L,H)
    # (a) chunk states S_c = (B o w)^T x, w_l = dt_l exp(cum_last - cum_l)
    w = dtc * torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcln,bclhp->bchnp", Bc, w[..., None] * xc)
    # (b) state passing: the state entering each chunk, and the last one
    h = torch.zeros((Bb, H, N, P), dtype=x.dtype)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(cum[:, c, -1, :])[..., None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, 1)                          # (B,nc,H,N,P)
    # (c) chunk scan: G once for all heads, gated per head (mask, then exp)
    G = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,L,L,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    gates = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      -torch.inf))
    M = G[..., None] * gates * dtc[:, :, None, :, :]
    y = (torch.exp(cum)[..., None]
         * torch.einsum("bcln,bchnp->bclhp", Cc, h_prev)
         + torch.einsum("bclmh,bcmhp->bclhp", M, xc))
    return y.reshape(Bb, nc * L, H, P)[:, :S], h.transpose(-1, -2)


# (B, S, H, P, N, kernel chunk L, the reference's chunk): S = 96 at L = 64
# leaves a ragged last chunk of 32
SSD_SCHEDULE = [(2, 128, 4, 16, 8, 16, 32), (2, 128, 4, 16, 8, 64, 32),
                (1, 96, 3, 16, 8, 64, 32), (1, 64, 2, 8, 4, 16, 64)]


@pytest.mark.parametrize("B,S,H,P,N,L,chunk", SSD_SCHEDULE)
def test_ssd_three_pass_schedule_f64(B, S, H, P, N, L, chunk):
    """The schedule in f64 equals the port's `mamba2.ssd_chunked` to
    rtol 1e-10 (atol 1e-12 for entries near zero): the chunk length and
    the order of the passes do not change the function."""
    args = [torch.tensor(a, dtype=torch.float64)
            for a in _ssd_inputs(B, S, H, P, N, S + L)]
    y, h = _ssd_three_pass(*args, L)
    want_y, want_h = mamba2.ssd_chunked(*args, chunk)
    torch.testing.assert_close(y, want_y, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(h, want_h, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("B,S,H,P,N,L,chunk", SSD_SCHEDULE)
def test_ssd_three_pass_schedule_vs_jax_kernel(B, S, H, P, N, L, chunk):
    """The schedule in f32 against the JAX package's Pallas kernel in
    interpret mode (f32 inside) at this file's ssd bar, atol 5e-5."""
    args = _ssd_inputs(B, S, H, P, N, S + L)
    y, h = _ssd_three_pass(*map(torch.tensor, args), L)
    want_y, want_h = jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want_y), atol=5e-5, rtol=0)
    np.testing.assert_allclose(_np(h), _np(want_h), atol=5e-5, rtol=0)


def _flash_bf16_p(q, k, v, *, window=0, block_k=fa.BLOCK_K):
    """csrc/flash_attention.cu's bf16 arithmetic: logits in f32 from bf16
    q, k; online softmax over key tiles (f32 m, l, acc, -1e30 masks, causal);
    P rounded to bf16 before P V, as the tensor cores take it; o = acc /
    max(l, 1e-30) rounded to bf16.  GQA as a grouping of the query heads."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, hd)
    s_all = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / np.sqrt(hd)
    i = torch.arange(S)[:, None]
    m = torch.full((B, Hkv, Hq // Hkv, S, 1), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, Hq // Hkv, S, hd))
    for k0 in range(0, S, block_k):
        j = torch.arange(k0, min(k0 + block_k, S))[None, :]
        ok = j <= i
        if window > 0:
            ok &= j > i - window
        s = torch.where(ok, s_all[..., k0:k0 + block_k], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhgqk,bkhd->bhgqd",
                          p.to(torch.bfloat16).float(),
                          v[:, k0:k0 + block_k].float())
        acc = alpha * acc + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, hd).to(q.dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("window", [0, 32])
def test_flash_bf16_p_emulation_vs_jax_kernel(B, S, Hq, Hkv, hd, window):
    """The bf16 kernel's rounding of P to bf16 stays within the bf16 bar
    (2e-2) of the JAX kernel in interpret mode at the sweep shapes."""
    rng = np.random.default_rng(S + hd)
    (jq, q), (jk, k), (jv, v) = (
        _both(rng.normal(size=shape).astype(np.float32), "bf16")
        for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    got = _flash_bf16_p(q, k, v, window=window)
    want = jops.flash_attention(jq, jk, jv, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)


def test_kernel_smem_and_scratch_sizes():
    """Every instance's block fits Hopper's shared memory: flash at each
    head dim in both dtypes, ssd at Mamba-2's N and P and at the sweep's;
    the ssd scratch is the per-chunk f32 states and last cumsums."""
    for hd in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert fa.smem_bytes(hd, dtype) <= fa.MAX_SMEM_BYTES
    assert fa.smem_bytes(128, torch.bfloat16) == 99368
    for N, P in ((128, 64), (8, 16), (16, 32), (4, 8)):
        assert ss.smem_bytes(N, P) <= ss.MAX_SMEM_BYTES
    nc = 2048 // ss.KERNEL_CHUNK
    assert ss.scratch_bytes(4, 2048, 32, 64, 128) == 4 * 4 * nc * 32 * (
        128 * 64 + 1)
    assert ss.scratch_bytes(1, 96, 3, 16, 8) == 4 * 2 * 3 * (8 * 16 + 1)
