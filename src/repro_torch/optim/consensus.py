"""The paper's technique as a data-parallel consensus layer for training
(port of `repro.optim.consensus`), over the mesh executor
(`dist.collectives.MeshExecutor`): each rank of the group holds one
replica of the parameters, and the ranks form the ring of the paper's
sensor graph.

* `dp_mode="diffusion"` (dSVB, Eqs. 27a/27b): each replica takes its local
  optimiser step, then combines parameters with its ring neighbours with
  nearest-neighbour weights (Eq. 47, w = 1/3 each).
* `dp_mode="admm"` (dVB-ADMM, Eqs. 38a/39/40): consensus-ADMM on the
  parameters with per-replica aggregate duals lambda_i and the kappa_t
  ramp; the projection (38b) is a no-op (a weight's parameter space is
  all of R^n).

Parameters and duals are dicts {name: tensor} (`optim.adamw.named`); the
functions update them in place and return them.  A parameter tree has
tens to hundreds of tensors and a collective costs ~0.05-0.26 ms of host
time, so every exchange packs the tree into one flat buffer per dtype
before its `ppermute`s (the combines are elementwise: the bits are those
of a tensor-by-tensor exchange).  Only the sums of squares of the
residual norms and the consensus diagnostic depend on the packing, by
their summation order.

On a device mesh a replica's tensors are DTensors over its sub-mesh (the
"model" axis, sharded as the policy says): every exchange carries each
rank's own block (`sharding.local`) to the peer at the same model
coordinate, and the sums of squares behind the residual norms and the
diagnostic add the blocks over the sub-mesh too, each replicated block
counted once (by the ranks at coordinate 0 of the axes it is replicated
over).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.engine import residual_balanced_rho
from repro_torch.dist import collectives, sharding
from repro_torch.dist.collectives import MeshExecutor


def _groups(tree: dict) -> dict:
    """{dtype: [names]} in the tree's order."""
    out: dict = {}
    for name, t in tree.items():
        out.setdefault(t.dtype, []).append(name)
    return out


def _flat(tree: dict, names: list, dtype=None) -> torch.Tensor:
    """This rank's blocks of the named tensors, flattened into one."""
    return torch.cat([sharding.local(tree[n]).detach().reshape(-1).to(
        dtype or tree[n].dtype) for n in names])


def _sizes(tree: dict, names: list) -> list:
    return [sharding.local(tree[n]).numel() for n in names]


@torch.no_grad()
def _write(tree: dict, names: list, flat: torch.Tensor) -> None:
    """Copy the flat buffer back into the tree's tensors (cast to each)."""
    for n, chunk in zip(names, flat.split(_sizes(tree, names))):
        t = sharding.local(tree[n])
        t.copy_(chunk.view(t.shape))


def _counted(t) -> float:
    """1.0 where this rank counts `t`'s block in a sum over the
    replica's sub-mesh, else 0.0: a DTensor's block is counted by the
    ranks at coordinate 0 of each mesh axis it is replicated over."""
    if not isinstance(t, DTensor):
        return 1.0
    coord = t.device_mesh.get_coordinate()
    return float(all(c == 0 for c, p in zip(coord, t.placements)
                     if not isinstance(p, Shard)))


def _leaf_sums(sq: torch.Tensor, tree: dict, names: list) -> torch.Tensor:
    """Each named tensor's sum of the flat `sq`, zero where this rank
    does not count its block (`_counted`)."""
    sums = torch.segment_reduce(sq, "sum", lengths=torch.tensor(
        _sizes(tree, names), device=sq.device))
    return sums * torch.tensor([_counted(tree[n]) for n in names],
                               device=sq.device)


def _sub_mesh_sum(x: torch.Tensor, tree: dict) -> torch.Tensor:
    """`x` summed over the sub-mesh the tree's DTensors span (as it is
    for plain tensors)."""
    t = next(iter(tree.values()))
    if isinstance(t, DTensor):
        for d in range(t.device_mesh.ndim):
            if t.device_mesh.size(d) > 1:
                x = collectives.psum(x, MeshExecutor(
                    t.device_mesh.get_group(d)))
    return x


# ---------------------------------------------------------------------------
# dSVB-style diffusion (Eq. 27b with nearest-neighbour weights on a ring)
# ---------------------------------------------------------------------------
@torch.no_grad()
def diffusion_combine(params: dict, ex: MeshExecutor,
                      w_self: float = 1.0 / 3.0) -> dict:
    """Each tensor <- w_self x_i + w_n (x_{i-1} + x_{i+1}), exchanged in its
    own dtype and summed in float32."""
    for names in _groups(params).values():
        flat = _flat(params, names)
        _write(params, names, collectives.ring_combine(
            flat, ex, w_self, compute_dtype=torch.float32))
    return params


# ---------------------------------------------------------------------------
# dVB-ADMM consensus (Eqs. 38a / 39 on a ring; deg_i = 2)
# ---------------------------------------------------------------------------
def admm_init_duals(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


@torch.no_grad()
def admm_step(params_star: dict, params_prev: dict, duals: dict,
              ex: MeshExecutor, *, rho, kappa,
              return_residuals: bool = False):
    """One primal+dual ADMM consensus round, in place.

    params_star: the locally optimised parameters (phi*_i of Eq. 18: the
    post-AdamW parameters), overwritten with the new iterate;
    params_prev: last round's consensus iterate; duals: lambda_i,
    overwritten.  Returns (params_star, duals), plus the global (||r||,
    ||s||) RMS residual norms when `return_residuals`, from the same ring
    exchange the dual ascent performs.
    """
    deg = 2.0
    r_sq = s_sq = 0.0
    for names in _groups(params_star).values():
        dtype = params_star[names[0]].dtype
        prev = _flat(params_prev, names)
        # the neighbours stay in their dtype: each f32 sum upcasts them
        # exactly, without a parameter-sized f32 copy of each
        left, right = collectives.ring_neighbors(prev, ex)
        prev = prev.float()
        lam = _flat(duals, names)
        num = (_flat(params_star, names, torch.float32) - 2.0 * lam
               + rho * (deg * prev + left + right))
        del left, right
        new = (num / (1.0 + 2.0 * rho * deg)).to(dtype)
        del num
        resid, pf = _ring_residual(new, ex)
        _write(duals, names, lam + kappa * rho / 2.0 * resid)
        _write(params_star, names, new)
        del lam, new
        if return_residuals:
            r, s = _residual_sums(resid, pf, prev, rho, params_star, names)
            r_sq, s_sq = r_sq + r, s_sq + s
        del prev, resid, pf
    if not return_residuals:
        return params_star, duals
    return params_star, duals, _rms_norms(r_sq, s_sq, params_star, ex)


# ---------------------------------------------------------------------------
# Adaptive penalty: the VB engine's residual-balancing rule on ring
# residuals
# ---------------------------------------------------------------------------
def _ring_residual(new: torch.Tensor, ex: MeshExecutor):
    """(r, new in float32) of one dtype group's flat iterate: r is the
    Eq. 39 disagreement 2 p_i - p_{i-1} - p_{i+1} in float32."""
    left, right = collectives.ring_neighbors(new, ex)
    pf = new.float()
    return 2.0 * pf - left - right, pf


def _residual_sums(resid, pf, prev, rho, tree: dict, names: list):
    """The group's sums of squares of r and of Boyd's dual residual
    s = rho (p^t - p^{t-1}) (`pf`, `prev` in float32), over the blocks
    this rank counts."""
    s = rho * (pf - prev)
    return (_leaf_sums(resid * resid, tree, names).sum(),
            _leaf_sums(s * s, tree, names).sum())


def _rms_norms(r_sq, s_sq, tree: dict, ex: MeshExecutor):
    """Global RMS norms from this rank's sums of squares of r and s over
    the entries of `tree` it counts (one psum of the two sums and the
    count over the replica's sub-mesh and the ring)."""
    n = sum(sharding.local(t).numel() * _counted(t) for t in tree.values())
    tot = torch.stack([r_sq, s_sq, torch.tensor(
        float(n), dtype=torch.float32, device=r_sq.device)])
    tot = collectives.psum(_sub_mesh_sum(tot, tree), ex)
    return torch.sqrt(tot[0] / tot[2]), torch.sqrt(tot[1] / tot[2])


@torch.no_grad()
def admm_residual_norms(params_new: dict, params_prev: dict,
                        ex: MeshExecutor, *, rho):
    """(||r||, ||s||) of one ADMM consensus round on the ring, as global
    RMS norms over all tensors and replicas: r is the Eq. 39 disagreement
    2 p_i - p_{i-1} - p_{i+1}, s Boyd's dual residual rho (p^t - p^{t-1}).
    (`admm_step(return_residuals=True)` gives the same norms from its own
    exchange.)"""
    r_sq = s_sq = 0.0
    for names in _groups(params_new).values():
        resid, pf = _ring_residual(_flat(params_new, names), ex)
        r, s = _residual_sums(resid, pf,
                              _flat(params_prev, names, torch.float32), rho,
                              params_new, names)
        r_sq, s_sq = r_sq + r, s_sq + s
    return _rms_norms(r_sq, s_sq, params_new, ex)


def adapt_rho(rho, r_norm, s_norm, *, mu: float = 10.0,
              tau_incr: float = 2.0, tau_decr: float = 2.0,
              rho_min: float = 1e-3, rho_max: float = 1e3):
    """Residual-balance the training-layer ADMM penalty (Boyd Sec.
    3.4.1): the VB engine's rule, so both layers share one
    implementation."""
    return residual_balanced_rho(rho, r_norm, s_norm, mu=mu,
                                 tau_incr=tau_incr, tau_decr=tau_decr,
                                 rho_min=rho_min, rho_max=rho_max)


# ---------------------------------------------------------------------------
# Disagreement diagnostic (how far replicas are from consensus)
# ---------------------------------------------------------------------------
@torch.no_grad()
def consensus_residual(params: dict, ex: MeshExecutor,
                       leaf_of=None) -> torch.Tensor:
    """mean over leaves of mean((phi_i - mean_j phi_j)^2).  `leaf_of`
    maps a parameter name to its leaf of the reference's params tree
    (a homogeneous stack's layers share one stacked leaf: see
    `training.train_step`); default, each tensor is a leaf.  A DTensor
    leaf's mean is over all its shards (`numel` is the whole tensor's)."""
    sums, sizes, leaves = [], [], []
    for names in _groups(params).values():
        pf = _flat(params, names, torch.float32)
        sq = (pf - collectives.pmean(pf, ex)) ** 2
        sums.append(_leaf_sums(sq, params, names))
        sizes += [params[n].numel() for n in names]
        leaves += [n if leaf_of is None else leaf_of(n) for n in names]
    index = {leaf: i for i, leaf in enumerate(dict.fromkeys(leaves))}
    seg = torch.tensor([index[leaf] for leaf in leaves],
                       device=sums[0].device)
    num = torch.zeros(len(index), device=seg.device).index_add_(
        0, seg, _sub_mesh_sum(torch.cat(sums), params))
    den = torch.zeros(len(index), device=seg.device).index_add_(
        0, seg, torch.tensor(sizes, dtype=torch.float32, device=seg.device))
    return (num / den).mean()
