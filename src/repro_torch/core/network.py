"""Sensor-network topologies and combination-weight rules (Sec. II, Eq. 47).

Port of the dense half of `repro.core.network`, with the per-iteration
link coins of a time-varying network.  Graph generation is
host-side numpy seeded exactly as the reference, so the arrays are equal
to the reference's; they come back as float64 CPU tensors, which the
engine's entry points move to the run's device.  The paper's reference
topology is a random geometric graph: 50 nodes in a 3.5 x 3.5 square,
communication radius 0.8.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def connectivity_radius(n_nodes: int, side: float) -> float:
    """The random-geometric-graph connectivity threshold
    r_c = side * sqrt(ln n / (pi n)) (Penrose; Gupta-Kumar)."""
    n = max(int(n_nodes), 2)
    return side * math.sqrt(math.log(n) / (math.pi * n))


def _resolve_radius(n_nodes: int, side: float,
                    radius: float | None) -> float:
    """Default communication radius: the paper's 0.8, never below 1.3x the
    connectivity threshold (which the constant rule crosses at N ~ 6k).
    An explicit `radius` always wins."""
    if radius is not None:
        return float(radius)
    return max(0.8, 1.3 * connectivity_radius(n_nodes, side))


def _paper_side(n_nodes: int, side: float | None) -> float:
    """3.5 for N=50, scaled with sqrt(N/50) otherwise (constant density)."""
    if side is None:
        return 3.5 * float(np.sqrt(n_nodes / 50.0))
    return float(side)


def random_geometric_graph(n_nodes: int, *, side: float | None = None,
                           radius: float | None = None, seed: int = 0,
                           max_tries: int = 200):
    """Connected random geometric graph (dense form).

    Returns (adjacency (N, N), positions (N, 2)) as float64 CPU tensors.
    """
    side = _paper_side(n_nodes, side)
    radius = _resolve_radius(n_nodes, side, radius)
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        pos = rng.uniform(0.0, side, size=(n_nodes, 2))
        d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
        adj = (d2 <= radius * radius).astype(np.float64)
        np.fill_diagonal(adj, 0.0)
        if _is_connected(adj):
            return torch.from_numpy(adj), torch.from_numpy(pos)
    raise RuntimeError(
        f"could not sample a connected geometric graph (N={n_nodes}, "
        f"side={side}, radius={radius})")


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


def ring_graph(n_nodes: int) -> torch.Tensor:
    """1-D ring adjacency (each node talks to its +/-1 neighbours)."""
    adj = np.zeros((n_nodes, n_nodes))
    for i in range(n_nodes):
        adj[i, (i + 1) % n_nodes] = 1.0
        adj[i, (i - 1) % n_nodes] = 1.0
    return torch.from_numpy(adj)


def degrees(adj: torch.Tensor) -> torch.Tensor:
    return adj.sum(1)


def nearest_neighbor_weights(adj: torch.Tensor) -> torch.Tensor:
    """Eq. 47: w_ij = 1/(|N_i|+1) for j in N_i u {i}, else 0
    (row-stochastic)."""
    a_self = adj + torch.eye(adj.shape[0], dtype=adj.dtype,
                             device=adj.device)
    return a_self / a_self.sum(1, keepdim=True)


def metropolis_weights(adj: torch.Tensor) -> torch.Tensor:
    """Metropolis-Hastings rule — doubly stochastic."""
    deg = degrees(adj)
    off = adj / (1.0 + torch.maximum(deg[:, None], deg[None, :]))
    return off + torch.diag(1.0 - off.sum(1))


# ---------------------------------------------------------------------------
# Time-varying links: per-iteration Bernoulli link failures
# ---------------------------------------------------------------------------
def link_generator(link_seed: int, t: int, device) -> torch.Generator:
    """The generator of iteration t's link coins: a `torch.Generator` on
    `device` seeded from (link_seed, t), so the coins are a function of the
    absolute iteration (a run split at any t replays them).  The reference
    draws from `jax.random`, which torch cannot reproduce, and the CPU's and
    the card's generators differ from each other: the masks are
    deterministic per device type, and parity tests inject the reference's
    through `link_mask_fn`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(link_seed) & 0xFFFFFFFF) << 32)
                    | (int(t) & 0xFFFFFFFF))
    return gen


def link_keep_matrix(gen: torch.Generator, n: int, drop_prob: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Symmetric (N, N) 0/1 keep mask on `gen`'s device: each undirected
    link (i, j) survives with probability 1 - drop_prob (both directions
    share one coin: a failed link is failed both ways); the diagonal is
    always 1 (a node never loses itself).

    >>> k = link_keep_matrix(link_generator(0, 3, "cpu"), 5, 0.5)
    >>> bool((k == k.T).all()), bool((k.diagonal() == 1).all())
    (True, True)
    """
    u = torch.rand((n, n), generator=gen, device=gen.device,
                   dtype=torch.float32).triu(1)
    u = u + u.T                                       # one coin per pair
    keep = (u >= drop_prob).to(dtype)
    return torch.maximum(keep, torch.eye(n, dtype=dtype, device=gen.device))


def ring_link_keep(gen: torch.Generator, n: int, drop_prob: float,
                   dtype=torch.float32) -> torch.Tensor:
    """(N,) keep mask of the ring edges on `gen`'s device: entry i gates
    the undirected link (i, i+1 mod N), one coin per edge."""
    u = torch.rand((n,), generator=gen, device=gen.device,
                   dtype=torch.float32)
    return (u >= drop_prob).to(dtype)


def algebraic_connectivity(adj: torch.Tensor) -> float:
    """Second-smallest Laplacian eigenvalue."""
    lap = torch.diag(degrees(adj)) - adj
    return float(torch.linalg.eigvalsh(lap)[1])
