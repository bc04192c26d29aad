"""Plain reference of the paper's dSVB over a sensor network (Algorithm 1).

A straightforward PyTorch implementation of the Bayesian GMM
(Dirichlet x Normal-Wishart) of arXiv 2011.13600, written from the paper
and Bishop's PRML Sec. 10.2 alone: the natural-parameter packing of
Eq. 45, the per-node VBE step and local VBM optimum with the replicated
likelihood (Eqs. 17a, 18, Appendix A), the Robbins-Monro step (27a) and
the diffusion combine (27b) with the nearest-neighbour weights of
Eq. 47, worked out again from the graph's links; and Algorithm 2, the
consensus ADMM of Eqs. 38-40 with its adaptive penalty.  It imports nothing of
the program: no kernel, no fused path, no centring of the statistics.
Every function takes the dtype it computes in; the benchmark runs it in
float64, and in float32 as the control.

Layout of the flat natural-parameter vector (Eq. 45), K components in D
dimensions: [alpha - 1 (K) | per component (nu - D)/2, -beta/2, beta m
(D), vec(-W^{-1}/2 - beta m m^T / 2) (D*D)].
"""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def flat_dim(K: int, D: int) -> int:
    return K + K * (2 + D + D * D)


def prior(cfg: dict, dtype, device) -> dict:
    """The configuration's conjugate prior as hyperparameters."""
    K, D = cfg["K"], cfg["D"]
    kw = dict(dtype=dtype, device=device)
    m0 = torch.tensor(cfg.get("m0", [0.0] * D), **kw)
    return dict(alpha=torch.full((K,), float(cfg["alpha0"]), **kw),
                m=m0.expand(K, D).clone(),
                beta=torch.full((K,), float(cfg["beta0"]), **kw),
                W=(torch.eye(D, **kw) * float(cfg["w0_scale"])).expand(
                    K, D, D).clone(),
                nu=torch.full((K,), float(cfg.get("nu0", D)), **kw))


def pack(h: dict) -> torch.Tensor:
    """Hyperparameters (leading axes ...) -> (..., P) natural parameters."""
    D = h["m"].shape[-1]
    beta, m = h["beta"], h["m"]
    n1 = (h["nu"] - D) / 2.0
    n4 = -beta / 2.0
    n3 = beta[..., None] * m
    n2 = (-0.5 * torch.linalg.inv(h["W"])
          - 0.5 * beta[..., None, None] * m[..., :, None] * m[..., None, :])
    blocks = torch.cat([n1[..., None], n4[..., None], n3,
                        n2.flatten(-2)], dim=-1)
    return torch.cat([h["alpha"] - 1.0, blocks.flatten(-2)], dim=-1)


def unpack(phi: torch.Tensor, K: int, D: int) -> dict:
    blocks = phi[..., K:].unflatten(-1, (K, 2 + D + D * D))
    beta = -2.0 * blocks[..., 1]
    m = blocks[..., 2:2 + D] / beta[..., None]
    n2 = blocks[..., 2 + D:].unflatten(-1, (D, D))
    w_inv = -2.0 * n2 - beta[..., None, None] * m[..., :, None] * m[..., None, :]
    return dict(alpha=phi[..., :K] + 1.0, m=m, beta=beta,
                W=torch.linalg.inv(w_inv), nu=2.0 * blocks[..., 0] + D)


def _local_optimum_block(x, mask, phi, pri, replication, K, D):
    h = unpack(phi, K, D)                                   # (n, K, ...)
    e_logpi = (torch.special.digamma(h["alpha"])
               - torch.special.digamma(h["alpha"].sum(-1, keepdim=True)))
    j = torch.arange(1, D + 1, dtype=phi.dtype, device=phi.device)
    e_logdet = (torch.special.digamma((h["nu"][..., None] + 1.0 - j) / 2.0)
                .sum(-1) + D * math.log(2.0)
                + torch.linalg.slogdet(h["W"]).logabsdet)
    diff = x[:, :, None, :] - h["m"][:, None, :, :]          # (n, T, K, D)
    wd = torch.einsum("nkij,ntkj->ntki", h["W"], diff)
    maha = (diff * wd).sum(-1)                               # (n, T, K)
    log_rho = (e_logpi[:, None, :] + 0.5 * e_logdet[:, None, :]
               - 0.5 * D * _LOG_2PI
               - 0.5 * (D / h["beta"][:, None, :]
                        + h["nu"][:, None, :] * maha))
    r = torch.softmax(log_rho, dim=-1) * mask[..., None]
    R = replication * r.sum(1)                               # (n, K)
    rx = r[..., None] * x[:, :, None, :]                     # (n, T, K, D)
    sx = replication * rx.sum(1)                             # (n, K, D)
    sxx = replication * torch.einsum("ntkd,nte->nkde", rx, x)
    # Bishop 10.58-10.62 on the uncentred statistics; a component no
    # point is responsible for (R = 0 exactly) keeps its prior
    xbar = sx / torch.where(R > 0, R, torch.ones_like(R))[..., None]
    rs = sxx - R[..., None, None] * xbar[..., :, None] * xbar[..., None, :]
    d = xbar - pri["m"]
    cross = (pri["beta"] * R / (pri["beta"] + R))[..., None, None] * (
        d[..., :, None] * d[..., None, :])
    w_inv = torch.linalg.inv(pri["W"]) + rs + cross
    w_inv = 0.5 * (w_inv + w_inv.transpose(-1, -2))
    beta = pri["beta"] + R
    post = dict(alpha=pri["alpha"] + R, beta=beta, nu=pri["nu"] + R,
                m=(pri["beta"][..., None] * pri["m"] + sx) / beta[..., None],
                W=torch.linalg.inv(w_inv))
    return pack(post)


def local_optimum(x, mask, phi, pri, replication: float, K: int, D: int,
                  *, chunk: int = 2048) -> torch.Tensor:
    """phi*_i (Eq. 18) of every node: x (N, T, D), mask (N, T), phi
    (N, P), all read in phi's dtype, `chunk` nodes at a time."""
    dt = phi.dtype
    out = torch.empty_like(phi)
    for lo in range(0, phi.shape[0], chunk):
        hi = min(lo + chunk, phi.shape[0])
        out[lo:hi] = _local_optimum_block(
            x[lo:hi].to(dt), mask[lo:hi].to(dt), phi[lo:hi], pri,
            replication, K, D)
    return out


def eta(t: int, tau: float, d0: float) -> float:
    """eta of the (t+1)-th iteration, t = 0, 1, ... (Eq. 29)."""
    return 1.0 / (d0 + tau * (t + 1.0))


class Graph:
    """The sensor graph from its undirected links (u, v): degrees and the
    neighbour sum z_i -> sum_{j ~ i} z_j over the node axis -2 of a
    (..., N, P) stack, by an index add over the directed edges, or
    `dense=True` by the (N, N) adjacency (small N)."""

    def __init__(self, u, v, n_nodes: int, device, *, dense: bool = False):
        u, v = u.to(device), v.to(device)
        self.src = torch.cat([u, v])
        self.dst = torch.cat([v, u])
        self.deg = torch.bincount(self.dst, minlength=n_nodes).to(
            torch.float64)
        self.adj = None
        if dense:
            self.adj = torch.zeros(n_nodes, n_nodes, dtype=torch.float64,
                                   device=device)
            self.adj[self.dst, self.src] = 1.0

    def nsum(self, z: torch.Tensor) -> torch.Tensor:
        if self.adj is not None:
            return torch.matmul(self.adj.to(z.dtype), z)
        acc = torch.zeros_like(z)
        acc.index_add_(z.dim() - 2, self.dst,
                       z.index_select(z.dim() - 2, self.src))
        return acc

    def diffuse(self, z: torch.Tensor) -> torch.Tensor:
        """Eq. 27b with Eq. 47 weights: (z_i + sum_{j ~ i} z_j) /
        (deg_i + 1)."""
        return (z + self.nsum(z)) / (self.deg.to(z.dtype) + 1.0)[:, None]


def dsvb(x, mask, phi0, pri, graph: Graph, *, tau: float, d0: float,
         n_iters: int, replication: float, K: int, D: int,
         t0: int = 0, keep=None) -> list:
    """Algorithm 1 from phi0 at absolute iteration t0: the iterate after
    each of `n_iters` steps, or after the steps numbered in `keep`
    (1, 2, ...), as a list of (N, P) tensors in phi0's dtype."""
    phi, out = phi0, []
    for i, t in enumerate(range(t0, t0 + n_iters)):
        star = local_optimum(x, mask, phi, pri, replication, K, D)
        phi = graph.diffuse(phi + eta(t, tau, d0) * (star - phi))
        if keep is None or i + 1 in keep:
            out.append(phi)
    return out


# ---------------------------------------------------------------------------
# Algorithm 2: consensus ADMM with the projection (38b) and the adaptive
# penalty (residual balancing, dual warmup, dual reset)
# ---------------------------------------------------------------------------
def _eigh(a: torch.Tensor, chunk: int = 1 << 14):
    """eigh over the leading batch in chunks (the card's batched eigh
    takes fewer than 32,766 matrices a call)."""
    flat = a.reshape(-1, *a.shape[-2:])
    parts = [torch.linalg.eigh(c) for c in flat.split(chunk)]
    return (torch.cat([p[0] for p in parts]).reshape(a.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(a.shape))


def project(phi: torch.Tensor, K: int, D: int, admm: dict) -> torch.Tensor:
    """Eq. 38b: the nearest point of the domain: alpha >= min_alpha,
    beta >= min_beta, nu >= D - 1 + 1e-3, and W^{-1} on the PSD cone by
    clipping its eigenvalues at max(1e-10 |largest|, min_eig)."""
    alpha = torch.clamp(phi[..., :K] + 1.0, min=admm["min_alpha"])
    blocks = phi[..., K:].unflatten(-1, (K, 2 + D + D * D))
    n4 = torch.clamp(blocks[..., 1], max=-admm["min_beta"] / 2.0)
    beta = -2.0 * n4
    n3 = blocks[..., 2:2 + D]
    m = n3 / beta[..., None]
    nu = torch.clamp(2.0 * blocks[..., 0] + D, min=(D - 1.0) + 1e-3)
    mmt = m[..., :, None] * m[..., None, :]
    w_inv = (-2.0 * blocks[..., 2 + D:].unflatten(-1, (D, D))
             - beta[..., None, None] * mmt)
    w_inv = 0.5 * (w_inv + w_inv.transpose(-1, -2))
    val, vec = _eigh(w_inv)
    floor = torch.clamp(1e-10 * val.abs().amax(-1, keepdim=True),
                        min=admm["min_eig"])
    val = torch.maximum(val, floor)
    w_inv = (vec * val[..., None, :]) @ vec.transpose(-1, -2)
    n2 = -0.5 * w_inv - 0.5 * beta[..., None, None] * mmt
    out = torch.cat([((nu - D) / 2.0)[..., None], n4[..., None], n3,
                     n2.flatten(-2)], dim=-1)
    return torch.cat([alpha - 1.0, out.flatten(-2)], dim=-1)


def admm_init(phi0: torch.Tensor, rho0) -> dict:
    """Algorithm 2's state for a (S, N, P) stack of sessions: zero duals,
    the initial penalty a session, the dual gate closed."""
    S = phi0.shape[0]
    kw = dict(dtype=phi0.dtype, device=phi0.device)
    return {"phi": phi0, "lam": torch.zeros_like(phi0),
            "rho": torch.as_tensor(rho0, **kw).expand(S).clone(),
            "stable": torch.zeros(S, dtype=torch.int64, device=phi0.device),
            "t_act": torch.zeros(S, **kw),
            "active": torch.zeros(S, dtype=torch.bool, device=phi0.device)}


def admm_step(st: dict, star: torch.Tensor, graph: Graph, xi: float,
              admm: dict, K: int, D: int) -> dict:
    """One iteration of adaptive consensus ADMM for each session of a
    (S, N, P) stack, given the local optima `star`:

      (38a) phi_i <- [phi*_i - 2 lam_i + rho (d_i phi_i + sum_j phi_j)]
                     / (1 + 2 rho d_i)
      (38b) phi_i <- Proj(phi_i)
      (39)  lam_i <- lam_i + kappa rho / 2 (d_i phi_i - sum_j phi_j)
      (40)  kappa = 1 - 1 / (1 + xi t_act)^2, t_act counting the
            iterations since the dual gate opened (0: no ascent)

    The gate opens once the dual residual ||rho (phi' - phi)|| has stayed
    under warmup_tol times the primal residual ||d phi' - sum phi'|| (RMS
    over the session's nodes and coordinates) for warmup_window
    iterations.  Where the projection moved a node by more than clip_tol
    its duals are reset to dual_reset times themselves, and any such node
    restarts the ramp.  Every adapt_every iterations of dual activity the
    penalty is balanced (x tau_incr where r > mu s, / tau_decr where
    s > mu r, within [rho_min, rho_max])."""
    phi, lam, rho = st["phi"], st["lam"], st["rho"]
    deg = graph.deg.to(phi.dtype)[:, None]
    r3 = rho[:, None, None]
    hat = (star - 2.0 * lam + r3 * (deg * phi + graph.nsum(phi))) / (
        1.0 + 2.0 * r3 * deg)
    new = project(hat, K, D, admm)
    clipped = (new - hat).abs().amax(-1) > admm["clip_tol"]     # (S, N)
    resid = deg * new - graph.nsum(new)
    n = phi.shape[-2] * phi.shape[-1]
    r = torch.sqrt((resid * resid).sum((-2, -1)) / n)
    step = r3 * (new - phi)
    s = torch.sqrt((step * step).sum((-2, -1)) / n)
    stable = torch.where(s < admm["warmup_tol"] * r, st["stable"] + 1,
                         torch.zeros_like(st["stable"]))
    active = st["active"] | (stable >= admm["warmup_window"])
    t_act = torch.where(active, st["t_act"] + 1.0,
                        torch.zeros_like(st["t_act"]))
    t_act = torch.where(clipped.any(-1), torch.zeros_like(t_act), t_act)
    kappa = torch.where(t_act > 0.0, 1.0 - 1.0 / (1.0 + xi * t_act) ** 2,
                        torch.zeros_like(t_act))
    lam = lam + (kappa[:, None, None] * r3 / 2.0) * resid
    lam = torch.where(clipped[..., None], admm["dual_reset"] * lam, lam)
    fac = torch.where(r > admm["mu"] * s,
                      torch.full_like(r, admm["tau_incr"]),
                      torch.where(s > admm["mu"] * r,
                                  torch.full_like(r, 1.0 / admm["tau_decr"]),
                                  torch.ones_like(r)))
    balanced = torch.clamp(rho * fac, admm["rho_min"], admm["rho_max"])
    due = active & (torch.fmod(t_act, float(admm["adapt_every"])) == 0.0) \
        & (t_act > 0.0)
    return {"phi": new, "lam": lam, "rho": torch.where(due, balanced, rho),
            "stable": stable, "t_act": t_act, "active": active}


def admm(x, mask, phi0, pri, graph: Graph, *, rho: float, xi: float,
         admm_cfg: dict, n_iters: int, replication: float, K: int,
         D: int, keep=None) -> list:
    """Algorithm 2 of one network from phi0: the iterate after each of
    `n_iters` steps, or after the steps numbered in `keep` (1, 2, ...)."""
    st = admm_init(phi0[None], rho)
    out = []
    for i in range(n_iters):
        star = local_optimum(x, mask, st["phi"][0], pri, replication, K, D)
        st = admm_step(st, star[None], graph, xi, admm_cfg, K, D)
        if keep is None or i + 1 in keep:
            out.append(st["phi"][0])
    return out


def evidence_blocks(phi: torch.Tensor, K: int, D: int) -> list:
    """A node's posterior as five blocks, each over all K components
    and each growing with the evidence behind it, read in float64 from
    the natural parameters: alpha (K), (nu - D)/2 (K), -beta/2 (K),
    beta m (K D) and the scatter W^{-1} = -2 n2 - beta m m^T (K D D),
    the part of n2 that beta m m^T hides."""
    phi = phi.to(torch.float64)
    blocks = phi[..., K:].unflatten(-1, (K, 2 + D + D * D))
    beta = -2.0 * blocks[..., 1]
    m = blocks[..., 2:2 + D] / beta[..., None]
    w_inv = (-2.0 * blocks[..., 2 + D:]
             - beta[..., None] * (m[..., :, None] * m[..., None, :]).flatten(
                 -2))
    return [phi[..., :K], blocks[..., 0], blocks[..., 1],
            blocks[..., 2:2 + D].flatten(-2), w_inv.flatten(-2)]


def node_gaps(phi: torch.Tensor, ref: torch.Tensor, K: int, D: int
              ) -> torch.Tensor:
    """(N,) each node's largest relative gap over its five blocks,
    ||block(phi) - block(ref)|| / ||block(ref)||, a block's norm taken
    over all its components, so a component that holds almost no points
    weighs by its evidence; infinity where phi or the gap is not
    finite."""
    gaps = torch.stack([(a - b).norm(dim=-1) / b.norm(dim=-1) for a, b in
                        zip(evidence_blocks(phi, K, D),
                            evidence_blocks(ref, K, D))], -1).amax(-1)
    bad = ~torch.isfinite(gaps) | ~torch.isfinite(phi).all(-1)
    return torch.where(bad, torch.full_like(gaps, math.inf), gaps)


def median_gap(phi: torch.Tensor, ref: torch.Tensor, K: int, D: int
               ) -> float:
    """The median node's gap (`node_gaps`): steady from seed to seed,
    where the largest node's swings with the few nodes whose data sit
    where two components meet."""
    return float(node_gaps(phi, ref, K, D).median())


def worst_gap(phi: torch.Tensor, ref: torch.Tensor, K: int, D: int
              ) -> float:
    """The largest node's gap (`node_gaps`)."""
    return float(node_gaps(phi, ref, K, D).max())


TAIL_Q = 0.99


def tail_gap(phi: torch.Tensor, ref: torch.Tensor, K: int, D: int
             ) -> float:
    """The 99th percentile of the node gaps (`node_gaps`), infinity if
    any node is not finite: it sees a fault confined to more than 1% of
    the nodes (a block of node indices, a tail tile, the high-degree
    nodes), which the median does not see while half of them are sound.
    The 99.9th swings with the few nodes where rounding compounds (one
    seed in twelve read 7 x its 99th at iteration 28 of ADMM)."""
    gaps = node_gaps(phi, ref, K, D)
    if not bool(torch.isfinite(gaps).all()):
        return math.inf
    return float(torch.quantile(gaps, TAIL_Q))


def gap_quantiles(phi: torch.Tensor, ref: torch.Tensor, K: int, D: int
                  ) -> dict:
    """The node gaps' median, 90th, 99th, 99.9th percentiles and largest
    (for the record on standard error)."""
    gaps = node_gaps(phi, ref, K, D)
    q = torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=gaps.dtype,
                     device=gaps.device)
    return dict(zip(("q50", "q90", "q99", "q999"),
                    torch.quantile(gaps, q).tolist()),
                max=float(gaps.max()))
