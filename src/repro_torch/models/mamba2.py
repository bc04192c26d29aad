"""Mamba-2 (SSD — state-space duality) block (port of
`repro.models.mamba2`).  [arXiv:2405.21060]

The sequence transform is the scalar-decay SSM
    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * B_t (x)  ,  y_t = C_t . h_t + D x_t
computed with the chunked SSD algorithm: quadratic attention-like math
inside chunks of length L, linear state passing across chunks.
`ssd_chunked` is the plain tensor path (the non-kernel path and, in f32,
the kernel's plain version); `ssm_block(use_kernel=True)` runs the CUDA
kernel of `repro_torch.kernels.ssd_scan` instead.

Under an ambient mesh (`dist.sharding.use_mesh`) the projections are
DTensor ops; the convolution and a decode step's recurrence run on each
rank's rows, and the SSD scan on its rows and (when the heads divide
"model") its heads, in per-shard regions (exact: nothing there mixes rows
or heads).

Dtypes follow the JAX package: with bf16 weights, C B^T and the intra
product run in bf16, the state and the decays in f32, and where JAX
promotes a mixed pair (an f32 decode cache with bf16 activations) the port
casts to the promoted type explicitly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.models import kernel_adapters, layers


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state


class Mamba2Block(nn.Module):
    """Fused in-projection [z (d_in) | x (d_in) | B (N) | C (N) | dt (H)],
    depthwise causal conv over x, B, C, the per-head decay A = -exp(A_log),
    skip D, dt bias, gated-norm scale and out-projection."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d_in, H, N = _dims(cfg)
        d = cfg.d_model
        conv_dim = d_in + 2 * N
        f32 = torch.float32
        self.in_proj = layers.param((d, 2 * d_in + 2 * N + H), dtype, device)
        self.conv_w = layers.param((cfg.conv_width, conv_dim), dtype, device)
        self.conv_b = layers.param((conv_dim,), dtype, device)
        self.A_log = layers.param((H,), f32, device)
        self.D = layers.param((H,), f32, device)
        self.dt_bias = layers.param((H,), f32, device)
        self.norm_scale = layers.param((d_in,), dtype, device)
        self.out_proj = layers.param((d_in, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        H = self.A_log.shape[0]
        layers.dense_init_(self.in_proj, generator)
        layers.normal_init_(self.conv_w, generator, 0.1)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm_scale.zero_()
        layers.dense_init_(self.out_proj, generator)

    def forward(self, x, *, return_state: bool = False,
                use_kernel: bool = False):
        return ssm_block(x, self, self.cfg, return_state=return_state,
                         use_kernel=use_kernel)


def ssm_params(cfg: ModelConfig, dtype, *, generator, device) -> Mamba2Block:
    p = Mamba2Block(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x (B, S, C), w (W, C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    return out + b


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    x  (B, S, H, P)   head inputs            dt (B, S, H)  softplus'd steps
    A  (H,)           negative decay rates   Bm/Cm (B, S, N)  shared across H
    Returns (y (B, S, H, P), final_state (B, H, P, N)).
    """
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = S // L
    if nc * L != S:
        raise ValueError(f"S={S} must be a multiple of the chunk {L}")
    xc = x.reshape(Bb, nc, L, H, P)
    dtc = dt.reshape(Bb, nc, L, H)
    Bc = Bm.reshape(Bb, nc, L, N)
    Cc = Cm.reshape(Bb, nc, L, N)

    dA = dtc * A[None, None, None, :]                 # (B,nc,L,H) <= 0
    cum = torch.cumsum(dA, dim=2)                     # inclusive cumsum
    # --- intra-chunk (quadratic, causal-masked) ---
    # M[l, l'] = C_l . B_l' * exp(cum_l - cum_l') * dt_l'  for l' <= l
    cb = torch.einsum("bcln,bcmn->bclm", Cc, Bc)      # (B,nc,L,L)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,L,L,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    # mask BEFORE exp: exp of the (positive) masked-out entries overflows
    seg = seg.masked_fill(~mask[None, None, :, :, None], -torch.inf)
    gates = torch.exp(seg)
    M = cb[..., None] * gates * dtc[:, :, None, :, :]         # (B,nc,L,L,H)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", M.to(x.dtype), xc)

    # --- chunk summaries:  S_c = sum_l exp(cum_L - cum_l) dt_l B_l x_l ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,L,H)
    wx = (dtc * decay_to_end)[..., None] * xc                 # (B,nc,L,H,P)
    # at least f32 (the JAX path's cast); an f64 evaluation stays f64
    acc = torch.promote_types(x.dtype, torch.float32)
    S_c = torch.einsum("bcln,bclhp->bchpn",
                       *layers.promoted(Bc, wx.to(acc)))

    # --- cross-chunk recurrence over nc (sequential) ---
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)
    h = (torch.zeros((Bb, H, P, N), dtype=acc, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                     # state BEFORE
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,H,P,N)

    # --- inter-chunk contribution:  y_l += C_l . (exp(cum_l) h_prev) ---
    in_decay = torch.exp(cum)                                 # (B,nc,L,H)
    y_inter = torch.einsum("bcln,bchpn->bclhp",
                           *layers.promoted(Cc, h_prevs)) * in_decay[
                               ..., None]
    y = y_intra + y_inter.to(x.dtype)
    return y.reshape(Bb, S, H, P), h


def _ssd(xh, dt, A, Bm, Cm, cfg: ModelConfig, use_kernel: bool):
    """(y, final state) of the SSD scan: the CUDA kernel, or the plain
    chunked path, on each rank's rows and heads under a mesh."""
    if use_kernel:
        return kernel_adapters.ssd_scan(xh, dt, A, Bm, Cm,
                                        chunk=cfg.ssm_chunk)
    fn = lambda x, dt, A, Bm, Cm: ssd_chunked(x, dt, A, Bm, Cm,
                                              cfg.ssm_chunk)
    mesh = sharding.current_mesh()
    if mesh is None:
        return fn(xh, dt, A, Bm, Cm)
    return kernel_adapters.heads_region(mesh, fn, xh, dt, A, Bm, Cm)


def ssm_block(x, p, cfg: ModelConfig, *, return_state: bool = False,
              use_kernel: bool = False):
    """Full Mamba-2 block: in_proj -> conv -> SSD -> gated norm ->
    out_proj.  With `return_state`, also (conv tail, final state) for
    decode continuation."""
    d_in, H, N = _dims(cfg)
    B, S, _ = x.shape
    zxbcdt = sharding.unshard_model(x @ p.in_proj)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    xbc_act = F.silu(sharding.rows_region(_causal_conv, (xbc,),
                                          (p.conv_w, p.conv_b)))
    xs, Bm, Cm = torch.split(xbc_act, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    y, state = _ssd(xh, dt, A, Bm, Cm, cfg, use_kernel)
    y = y + p.D[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_in)
    y = layers.rms_norm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = y @ p.out_proj
    if return_state:
        # conv tail: the last (W-1) pre-conv inputs, for decode
        # continuation (the JAX block recomputes x @ in_proj for it; the
        # port keeps the slice it already has)
        return out, (layers.conv_tail(xbc, cfg.conv_width), state)
    return out


def _decode_core(conv_buf, xbc, dt, h, conv_w, conv_b, dt_bias, A_log, D,
                 *, cfg: ModelConfig):
    """One step of the conv and the SSM recurrence on the rows given:
    -> (y (B, d_in) f32, the new conv buffer, the new state)."""
    d_in, H, N = _dims(cfg)
    B = xbc.shape[0]
    # causal conv over the rolling buffer
    seq = torch.cat(layers.promoted(conv_buf, xbc[:, None, :]), dim=1)
    conv_out = torch.einsum("bwc,wc->bc",
                            *layers.promoted(seq, conv_w)) + conv_b
    xbc_t = F.silu(conv_out)
    xs, Bm, Cm = torch.split(xbc_t, [d_in, N, N], dim=-1)
    dt_t = F.softplus(dt.float() + dt_bias)                       # (B, H)
    A = -torch.exp(A_log)
    xh = xs.reshape(B, H, cfg.ssm_head_dim).float()
    decay = torch.exp(dt_t * A[None, :])                          # (B, H)
    upd = (dt_t[..., None, None] * Bm[:, None, None, :]
           * xh[..., :, None])                                    # (B,H,P,N)
    h = decay[..., None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", *layers.promoted(h, Cm))
    y = y + D[None, :, None] * xh
    return y.reshape(B, d_in), seq[:, 1:, :], h


def ssm_decode_step(x, p, cfg: ModelConfig, state):
    """One decode step.  x (B, 1, d); state = (conv_buf (B,W-1,Cc),
    h (B,H,P,N)).  Returns (out (B,1,d), (conv_buf, h)), both new."""
    d_in, H, N = _dims(cfg)
    conv_buf, h = state
    zxbcdt = sharding.unshard_model(x[:, 0, :] @ p.in_proj)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    y, conv_buf, h = sharding.rows_region(
        lambda *a: _decode_core(*a, cfg=cfg), (conv_buf, xbc, dt, h),
        (p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D), n_out=3)
    y = y.to(x.dtype)
    y = layers.rms_norm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = (y @ p.out_proj)[:, None, :]
    return out, (conv_buf, h)
