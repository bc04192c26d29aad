"""RG-LRU recurrent block (RecurrentGemma / Griffin; port of
`repro.models.rglru`).  [arXiv:2402.19427]

    r_t = sigmoid(W_a xi_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x xi_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

computed over the sequence with a log-depth scan (`rglru_scan`); decode
carries (conv_buf, h).  The residual block is Griffin's "recurrent block":
two input linears -> (gelu gate | temporal conv -> RG-LRU) -> elementwise
merge -> output linear.  `jax.nn.gelu` is the tanh approximation, and so
is the port's.

Under an ambient mesh (`dist.sharding.use_mesh`) the projections and
gates are DTensor ops; the convolution runs on each rank's rows, and the
scan on its rows and (when the width divides "model") its channels, in
per-shard regions (exact: the scan is elementwise across channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.models import layers

_C = 8.0


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """in_x, in_gate (d, w); conv_w (W, w), conv_b (w); w_a, w_i (w, w)
    with f32 biases b_a, b_i; f32 lam (w); out (w, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, w = cfg.d_model, _lru_width(cfg)
        f32 = torch.float32
        self.in_x = layers.param((d, w), dtype, device)
        self.in_gate = layers.param((d, w), dtype, device)
        self.conv_w = layers.param((cfg.conv_width, w), dtype, device)
        self.conv_b = layers.param((w,), dtype, device)
        self.w_a = layers.param((w, w), dtype, device)
        self.b_a = layers.param((w,), f32, device)
        self.w_i = layers.param((w, w), dtype, device)
        self.b_i = layers.param((w,), f32, device)
        self.lam = layers.param((w,), f32, device)
        self.out = layers.param((w, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for w in (self.in_x, self.in_gate, self.w_a, self.w_i, self.out):
            layers.dense_init_(w, generator)
        layers.normal_init_(self.conv_w, generator, 0.1)
        for b in (self.conv_b, self.b_a, self.b_i):
            b.zero_()
        # Lambda parameterised so a ~ U[0.9, 0.999] at r=1 (Griffin init)
        a = torch.linspace(0.9, 0.999, self.lam.shape[0],
                           device=self.lam.device)
        self.lam.copy_(torch.log(torch.expm1(-torch.log(a) / _C)))

    def forward(self, x, *, return_state: bool = False):
        return rec_block(x, self, self.cfg, return_state=return_state)


def rec_params(cfg: ModelConfig, dtype, *, generator, device) -> RGLRU:
    p = RGLRU(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _gates(xi, p):
    xf = xi.float()
    r = torch.sigmoid(xf @ p.w_a.float() + p.b_a)
    i = torch.sigmoid(xf @ p.w_i.float() + p.b_i)
    log_a = -_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated_in


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_0 = 0) in
    log2(S) steps: the reference's associative scan with the combine
    (a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2), taken Hillis-Steele style
    (each step combines every position with the one `off` before it)."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_scan(xi, p, h0=None):
    """xi (B, S, w) -> (h_seq (B, S, w) in xi's dtype, h_final (B, w)
    f32)."""
    a, gin = _gates(xi, p)                       # (B, S, w) f32
    if h0 is not None:
        # fold the carry into the first step: h_1 = a_1 h_0 + gin_1
        gin = torch.cat([gin[:, :1] + a[:, :1] * h0[:, None], gin[:, 1:]],
                        dim=1)
    h_seq = _scan_local(a, gin)
    return h_seq.to(xi.dtype), h_seq[:, -1, :]


def _scan_local(a, b):
    """`_linear_scan` on each rank's rows and, when the width divides
    "model", its channels."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return _linear_scan(a, b)
    split = a.shape[-1] % sharding.axis_size(mesh, "model") == 0
    pl = sharding.placements_for(mesh, batch=a.shape[0],
                                 model_dim=2 if split else None)
    return sharding.region(_linear_scan, mesh, (pl, pl), pl)(a, b)


def rec_block(x, p, cfg: ModelConfig, *, return_state: bool = False):
    """Griffin recurrent block.  x (B, S, d)."""
    gate = F.gelu((x @ p.in_gate).float(), approximate="tanh")
    xi = sharding.unshard_model(x @ p.in_x)
    xi_conv = sharding.rows_region(_conv, (xi,), (p.conv_w, p.conv_b))
    h_seq, h_fin = rglru_scan(xi_conv, p)
    merged = (h_seq.float() * gate).to(x.dtype)
    out = merged @ p.out
    if return_state:
        return out, (layers.conv_tail(xi, cfg.conv_width), h_fin.float())
    return out


def _conv(xi, conv_w, conv_b):
    """Depthwise causal conv over the sequence: sum_i x_{t-W+1+i} w_i +
    b, the terms added in the reference's order."""
    W = conv_w.shape[0]
    S = xi.shape[1]
    xp = F.pad(xi, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S, :] * conv_w[i]
    return out + conv_b


def _decode_conv(conv_buf, xi, conv_w, conv_b):
    """One step of the conv over the rolling buffer: (conv output (B, w),
    the buffer with `xi` appended)."""
    seq = torch.cat(layers.promoted(conv_buf, xi[:, None, :]), dim=1)
    xi_c = torch.einsum("bwc,wc->bc", *layers.promoted(seq, conv_w))
    return xi_c + conv_b, seq


def rec_decode_step(x, p, cfg: ModelConfig, state):
    """x (B, 1, d); state = (conv_buf (B, W-1, w), h (B, w) f32).  Where
    the cache is f32 and the activations bf16, the concatenation and the
    conv run in f32 (JAX's promotion)."""
    conv_buf, h = state
    gate = F.gelu((x[:, 0, :] @ p.in_gate).float(), approximate="tanh")
    xi = sharding.unshard_model(x[:, 0, :] @ p.in_x)
    xi_c, seq = sharding.rows_region(_decode_conv, (conv_buf, xi),
                                     (p.conv_w, p.conv_b), n_out=2)
    a, gin = _gates(xi_c[:, None, :], p)
    h = a[:, 0, :] * h + gin[:, 0, :]
    merged = (h * gate).to(x.dtype)
    out = (merged @ p.out)[:, None, :]
    return out, (seq[:, 1:, :], h)
