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

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
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

    Without an ambient mesh the dispatch is global over the batch given.
    Under a mesh (`dist.sharding.use_mesh`; x a DTensor with its rows over
    the dp axes) routing, the capacity positions and the scatter/gather
    run on each rank's rows in per-shard regions, and the expert FFN is
    DTensor products with the model-sharded expert weights:

    * `cfg.moe_local_dispatch`: each data shard dispatches its own tokens
      (per-shard capacity, the Switch "per-core" semantics; the shards'
      buffers side by side on the capacity axis), and the router loss is
      the mean of the shards' losses;
    * otherwise the dispatch is global: a token's place in its expert's
      buffer counts the earlier tokens of every shard (the shards' expert
      counts are gathered), so the same tokens drop as in the unsharded
      run, and the shards' scatters add into one buffer.
    """
    mesh = sharding.current_mesh()
    if mesh is None:
        return _moe_dispatch(x, p, cfg=cfg)
    return _moe_mesh(x, p, cfg, mesh)


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


def _route(xt, router, cfg: ModelConfig, cap: int, base_fn=None):
    """Top-k routing of tokens xt (T, d) and their places in the (E * cap
    + 1)-row buffer: (dest (T k,), gates (T, k) in xt's dtype, the
    fraction of slots each expert takes (E,), the mean router
    probabilities (E,)).  `base_fn(counts)` gives the entries routed to
    each expert before these tokens (other shards' tokens)."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = xt.float() @ router                                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)         # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    flat_e = expert_idx.reshape(T * k)
    pos = _positions(flat_e, E)
    if base_fn is not None:
        pos = pos + base_fn(F.one_hot(flat_e, E).sum(0))[flat_e]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))            # drop slot
    gates = (gate_vals * keep.reshape(T, k)).to(xt.dtype)
    frac_tokens = F.one_hot(expert_idx, E).float().mean(dim=(0, 1))
    return dest, gates, frac_tokens, probs.mean(dim=0)


def _scatter(xt, dest, E: int, cap: int, k: int):
    """The (E, cap, d) expert buffer: each (token, slot) copied to its
    place (one copy per chosen expert); only the drop slot takes several
    writes, and it is never read."""
    d = xt.shape[1]
    src = xt.repeat_interleave(k, dim=0)                         # (T*k, d)
    buf = xt.new_zeros((E * cap + 1, d)).index_put((dest,), src)
    return buf[:E * cap].reshape(E, cap, d)


def _experts(xe, p):
    """The expert FFNs (SwiGLU), batched over the experts: (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p.wg)) * \
        torch.einsum("ecd,edf->ecf", xe, p.wi)
    return torch.einsum("ecf,efd->ecd", h, p.wo)


def _gather(ye, dest, gates):
    """Each token's expert outputs read back and mixed with its gates:
    (T, d)."""
    E, C, d = ye.shape
    T, k = gates.shape
    ybuf = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], 0)
    yslots = ybuf[dest].reshape(T, k, d)
    return torch.einsum("tkd,tk->td", yslots, gates)


def _capacity(T: int, cfg: ModelConfig) -> int:
    return max(1, int(T * cfg.experts_per_token / cfg.n_experts
                      * cfg.capacity_factor))


def _moe_dispatch(x, p, *, cfg: ModelConfig):
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    cap = _capacity(T, cfg)
    xt = x.reshape(T, d)
    dest, gates, frac_tokens, mean_probs = _route(xt, p.router, cfg, cap)
    xe = _scatter(xt, dest, E, cap, cfg.experts_per_token)
    ye = _experts(xe, p)                                         # (E, C, d)
    out = _gather(ye, dest, gates).reshape(B, S, d)
    # load-balancing auxiliary loss (Switch-style)
    aux = E * torch.sum(frac_tokens * mean_probs)
    return out, aux


def _moe_mesh(x, p, cfg: ModelConfig, mesh):
    """`moe_block` under a mesh (see there)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    dp = sharding.dp_axes_for(B, mesh)
    names = tuple(mesh.mesh_dim_names)
    n = math.prod(mesh.size(names.index(a)) for a in dp)
    local = cfg.moe_local_dispatch and bool(dp)
    cap = _capacity(B * S // n if local else B * S, cfg)
    rows = sharding.placements_for(mesh, batch=B)
    rep = sharding.placements_for(mesh)
    summed = tuple(Partial() if a in dp else Replicate() for a in names)

    def route(x_l, router):
        xt = x_l.reshape(-1, d)
        base_fn = None if local else (
            lambda counts: _earlier_counts(counts, mesh, dp))
        dest, gates, frac, mprobs = _route(xt, router, cfg, cap, base_fn)
        xe = _scatter(xt, dest, E, cap, k)
        if local:       # the mean of the shards' router losses
            return xe, dest, gates, E * torch.sum(frac * mprobs) * (1.0 / n)
        return xe, dest, gates, frac * (1.0 / n), mprobs * (1.0 / n)

    # local: the shards' buffers side by side on the capacity axis;
    # global: the shards' scatters summed into one buffer
    xe_pl = (sharding.placements_for(mesh, batch=B, batch_dim=1) if local
             else summed)
    out_pl = (xe_pl, rows, rows) + ((summed,) if local else (summed, summed))
    xe, dest, gates, *aux = sharding.region(route, mesh, (rows, rep),
                                            out_pl)(x, p.router)
    if not local:
        xe = sharding.relayout(xe, mesh, rep)
    ye = _experts(xe, p)
    out = sharding.region(
        lambda ye, dest, gates: _gather(ye, dest, gates).reshape(-1, S, d),
        mesh, (xe_pl if local else rep, rows, rows), rows)(ye, dest, gates)
    if local:
        aux = sharding.relayout(aux[0], mesh, rep)
    else:
        aux = E * torch.sum(sharding.relayout(aux[0], mesh, rep)
                            * sharding.relayout(aux[1], mesh, rep))
    return out, aux


def _earlier_counts(counts, mesh, dp: tuple):
    """(E,) entries routed to each expert by the dp shards before this
    one in batch order (shards ordered major axis first), from every
    shard's `counts`."""
    names = tuple(mesh.mesh_dim_names)
    every = counts[None]
    for a in reversed(dp):              # minor axis first
        parts = [torch.empty_like(every)
                 for _ in range(mesh.size(names.index(a)))]
        dist.all_gather(parts, every.contiguous(),
                        group=mesh.get_group(a))
        every = torch.cat(parts, 0)
    coord = mesh.get_coordinate()
    me = 0
    for a in dp:
        me = me * mesh.size(names.index(a)) + coord[names.index(a)]
    return every[:me].sum(0)
