"""Mixture-of-Experts FFN with sort-free capacity dispatch (port of
`repro.models.moe`).

Tokens are placed into a static (E * C + 1, d) buffer by a scatter and
read back by a gather (the last row is the drop slot of the tokens past
an expert's capacity): no routing matmul, static shapes, drop-on-overflow
(`capacity_factor`).  The expert FFNs are batched products over the
leading expert axis (plain `torch.einsum`, as the reference leaves them
to XLA).

Capacity drops follow token order: a (token, slot)'s place in its
expert's buffer is the count of earlier (token, slot)s routed there, so
the port drops the same tokens as the reference for the same router
choices.  `torch.topk` and `jax.lax.top_k` may order equal
probabilities differently; with a random router no two are equal (the
tests draw their routers at random).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

#: rows of the blocked cumsum that places (token, slot)s in their buffers
_CUMSUM_BLOCK = 1024


class MoE(nn.Module):
    """router (d, E) in f32; wi, wg (E, d, d_ff), wo (E, d_ff, d) in the
    parameter dtype."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = layers.param((d, E), torch.float32, device)
        self.wi = layers.param((E, d, f), dtype, device)
        self.wg = layers.param((E, d, f), dtype, device)
        self.wo = layers.param((E, f, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator):
        layers.dense_init_(self.router, generator, 0)
        for w in (self.wi, self.wg, self.wo):
            layers.dense_init_(w, generator, 1)

    def forward(self, x):
        return moe_block(x, self, self.cfg)


def moe_params(cfg: ModelConfig, dtype, *, generator, device) -> MoE:
    p = MoE(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def moe_block(x: torch.Tensor, p, cfg: ModelConfig):
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar).

    The dispatch is global over the batch this process holds.  With
    `cfg.moe_local_dispatch` the reference dispatches per data shard of
    its mesh; a rank of the port holds its own rows, so the global
    dispatch over them is that rank's local dispatch (per-shard capacity).
    Dispatch across the ranks of a group comes with the LM sharding
    (ROADMAP Queue 1 item 16)."""
    return _moe_dispatch(x, p, cfg=cfg)


def _positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, slot)'s place in its expert's buffer: the count of
    earlier entries routed to the same expert, by the reference's
    two-level blocked cumsum (in-block scans plus a scan over the block
    totals; integer sums, so equal to one cumsum)."""
    n = flat_e.shape[0]
    onehot = F.one_hot(flat_e, E)                               # (n, E)
    nb = -(-n // _CUMSUM_BLOCK)
    oh = F.pad(onehot, (0, 0, 0, nb * _CUMSUM_BLOCK - n)).reshape(
        nb, _CUMSUM_BLOCK, E)
    local = torch.cumsum(oh, dim=1)                             # in-block
    block_tot = local[:, -1, :]                                 # (nb, E)
    offsets = torch.cumsum(block_tot, dim=0) - block_tot        # exclusive
    pos = (local - oh + offsets[:, None, :]).reshape(nb * _CUMSUM_BLOCK,
                                                    E)[:n]
    return pos.gather(1, flat_e[:, None])[:, 0]


def _moe_dispatch(x, p, *, cfg: ModelConfig):
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(T * k / E * cfg.capacity_factor))
    xt = x.reshape(T, d)

    logits = xt.float() @ p.router                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)         # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    flat_e = expert_idx.reshape(T * k)
    pos = _positions(flat_e, E)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))            # drop slot

    # scatter tokens into the (E*C + 1, d) buffer (one copy per chosen
    # expert); only the drop slot takes several writes, and it is never read
    src = xt.repeat_interleave(k, dim=0)                         # (T*k, d)
    buf = x.new_zeros((E * cap + 1, d)).index_put((dest,), src)
    xe = buf[:E * cap].reshape(E, cap, d)

    # expert FFN (SwiGLU), batched over the experts
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p.wg)) * \
        torch.einsum("ecd,edf->ecf", xe, p.wi)
    ye = torch.einsum("ecf,efd->ecd", h, p.wo)                   # (E, C, d)

    # gather back and mix with the gate values
    ybuf = torch.cat([ye.reshape(E * cap, d), ye.new_zeros((1, d))], 0)
    yslots = ybuf[dest].reshape(T, k, d)
    gates = (gate_vals * keep.reshape(T, k)).to(x.dtype)
    out = torch.einsum("tkd,tk->td", yslots, gates).reshape(B, S, d)

    # load-balancing auxiliary loss (Switch-style)
    frac_tokens = F.one_hot(expert_idx, E).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * mean_probs)
    return out, aux
