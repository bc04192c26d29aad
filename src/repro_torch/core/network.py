"""Sensor-network topologies and combination-weight rules (Sec. II, Eq. 47).

Port of the dense half of `repro.core.network`, with the per-iteration
link coins of a time-varying network drawn from a counter-based hash
(`hash32`) that gives the same bits on the CPU and on the card; the
streaming layer (data/stream.py) draws its epoch permutations from it
too.  Graph generation is
host-side numpy seeded exactly as the reference, so the arrays are equal
to the reference's; they come back as float64 CPU tensors, which the
engine's entry points move to the run's device.  The paper's reference
topology is a random geometric graph: 50 nodes in a 3.5 x 3.5 square,
communication radius 0.8.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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
# Counter-based random words: the same bits on every device
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
#: stream tags: which use a word is drawn for (they key the hash)
STREAM_LINKS, STREAM_PERMS = 1, 2


def _mul32(x, m: int):
    """(x * m) mod 2^32 for x in [0, 2^32) (an int64 tensor or a Python
    int) and a 32-bit constant m.  m is split into 16-bit halves, so every
    intermediate stays below 2^49: int64 never wraps on any device."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x):
    """The "lowbias32" integer finaliser (C. Wellons): a bijection of
    [0, 2^32) with full avalanche, in int64 ops (or on a Python int).

    >>> [mix32(v) for v in (0, 1)]
    [0, 1753845952]
    """
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_state(seed: int) -> int:
    """The hash state after absorbing a (64-bit) seed."""
    h = mix32((int(seed) & _M32) ^ 0x9E3779B9)
    return mix32(h ^ ((int(seed) >> 32) & _M32))


def absorb(h, *words):
    """Absorb 32-bit words into the state h (Python ints or int64 tensors,
    broadcast): h <- mix32(h ^ w).  For fixed other inputs the state is a
    bijection of each word."""
    for w in words:
        h = mix32(h ^ (w & _M32))
    return h


def hash32(seed: int, *words):
    """One 32-bit word of (seed, words...), as an int64 in [0, 2^32): a
    pure function of its inputs, computed with the same integer ops on
    every device, so a CPU and a CUDA run draw the same bits."""
    return mix32(absorb(seed_state(seed), *words))


def uniform(words: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) from 32-bit words, in float64: w / 2^32 is exact,
    so a comparison `u >= p` decides alike on every device."""
    return words.to(torch.float64) * (2.0 ** -32)


# ---------------------------------------------------------------------------
# Time-varying links: per-iteration Bernoulli link failures
# ---------------------------------------------------------------------------
class LinkCoins(NamedTuple):
    """The key of iteration t's link coins: (link_seed, t) and the device
    the coins are drawn on."""

    seed: int
    t: int
    device: torch.device


def link_generator(link_seed: int, t: int, device) -> LinkCoins:
    """The counter-based generator of iteration t's link coins: coin k is
    `hash32(link_seed, STREAM_LINKS, t, k)`, a function of the absolute
    iteration (a run split at any t replays it) that gives the same bits
    on the CPU and on the card.  The reference draws from `jax.random`,
    which torch cannot reproduce: parity tests inject its masks through
    `link_mask_fn`."""
    return LinkCoins(int(link_seed), int(t), torch.device(device))


def _link_uniforms(gen: LinkCoins, n_coins: int) -> torch.Tensor:
    k = torch.arange(n_coins, dtype=torch.int64, device=gen.device)
    h = absorb(seed_state(gen.seed), STREAM_LINKS, gen.t)     # a host int
    return uniform(mix32(absorb(h, k)))


def link_keep_matrix(gen: LinkCoins, n: int, drop_prob: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Symmetric (N, N) 0/1 keep mask on `gen`'s device: each undirected
    link (i, j), i < j, survives iff its coin (number i N + j) is
    >= drop_prob (both directions share one coin: a failed link is failed
    both ways); the diagonal is always 1 (a node never loses itself).

    >>> k = link_keep_matrix(link_generator(0, 3, "cpu"), 5, 0.5)
    >>> bool((k == k.T).all()), bool((k.diagonal() == 1).all())
    (True, True)
    """
    u = _link_uniforms(gen, n * n).reshape(n, n).triu(1)
    u = u + u.T                                       # one coin per pair
    keep = (u >= drop_prob).to(dtype)
    return torch.maximum(keep, torch.eye(n, dtype=dtype, device=gen.device))


def ring_link_keep(gen: LinkCoins, n: int, drop_prob: float,
                   dtype=torch.float32) -> torch.Tensor:
    """(N,) keep mask of the ring edges on `gen`'s device: entry i gates
    the undirected link (i, i+1 mod N), one coin (number i) per edge."""
    return (_link_uniforms(gen, n) >= drop_prob).to(dtype)


def algebraic_connectivity(adj: torch.Tensor) -> float:
    """Second-smallest Laplacian eigenvalue."""
    lap = torch.diag(degrees(adj)) - adj
    return float(torch.linalg.eigvalsh(lap)[1])
