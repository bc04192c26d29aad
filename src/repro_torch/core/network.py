"""Sensor-network topologies and combination-weight rules (Sec. II, Eq. 47).

Port of `repro.core.network`, with the per-iteration link coins of a
time-varying network drawn from a counter-based hash (`hash32`) that
gives the same bits on the CPU and on the card; the streaming layer
(data/stream.py) draws its epoch permutations from it too.  Graph
generation is host-side numpy seeded exactly as the reference, so the
arrays are equal to the reference's; they come back as CPU tensors,
which the engine's entry points move to the run's device.  The paper's
reference topology is a random geometric graph: 50 nodes in a 3.5 x 3.5
square, communication radius 0.8.

Two graph representations live here:

* **dense** — an (N, N) 0/1 adjacency and (N, N) weight matrices: the
  paper's scale, and the parity oracle of the sparse form.
* **sparse** — `SparseGraph`: directed edge lists sorted by receiver and
  per-node degrees, built by `random_geometric_edges` /
  `SparseGraph.ring` without an (N, N) array, consumed by the engine's
  segmented-sum combines.  At N = 100,000 the dense f64 matrix alone
  would be 80 GB; the edge lists are O(E + N).
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


# ---------------------------------------------------------------------------
# Sparse representation: edge lists + per-node degrees, never an N x N array
# ---------------------------------------------------------------------------
class SparseGraph:
    """Edge-list sensor graph for the engine's sparse combines.

    Every undirected link is stored twice, as a DIRECTED message edge
    (sender -> receiver), sorted by receiver (stable), so a segmented sum
    over `receivers` with the lengths `deg` reduces each node's incoming
    messages in edge order.  `edge_id` maps each directed edge back to its
    undirected link, so both directions of a link read one coin under
    `sparse_link_keep` (a failed link is failed both ways).  The arrays
    are int64 tensors (CPU until `to(device)`), equal in value to the
    reference's int32 arrays.

    >>> g = SparseGraph.ring(4)
    >>> (g.n_nodes, g.n_undirected, int(g.senders.shape[0]))
    (4, 4, 8)
    >>> g.deg.tolist()
    [2, 2, 2, 2]
    """

    __slots__ = ("senders", "receivers", "edge_id", "deg", "n_nodes",
                 "n_undirected")

    def __init__(self, senders, receivers, edge_id, deg, n_nodes: int,
                 n_undirected: int):
        self.senders = senders            # (E,) int64, E = 2 * n_undirected
        self.receivers = receivers        # (E,) int64, sorted ascending
        self.edge_id = edge_id            # (E,) int64 -> undirected link id
        self.deg = deg                    # (N,) int64 neighbour counts
        self.n_nodes = int(n_nodes)
        self.n_undirected = int(n_undirected)

    @classmethod
    def from_undirected(cls, u, v, n_nodes: int) -> "SparseGraph":
        """From undirected link lists: link k connects (u[k], v[k]).  The
        link ORDER is the coin order of `sparse_link_keep` (`ring`'s link
        k = (k, k+1 mod N) is `ring_link_keep`'s coin k).  No self-loops
        or duplicate links."""
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        if u.shape != v.shape or u.ndim != 1:
            raise ValueError("u/v must be equal-length 1-D link lists")
        if np.any(u == v):
            raise ValueError("self-loops are not links")
        if np.any(u < 0) or np.any(v < 0) or np.any(u >= n_nodes) \
                or np.any(v >= n_nodes):
            raise ValueError(f"node ids must be in [0, {n_nodes})")
        key = np.minimum(u, v) * n_nodes + np.maximum(u, v)
        if np.unique(key).size != key.size:
            raise ValueError("duplicate undirected links")
        m = u.shape[0]
        s = np.concatenate([u, v])
        r = np.concatenate([v, u])
        eid = np.concatenate([np.arange(m), np.arange(m)])
        order = np.argsort(r, kind="stable")
        deg = np.bincount(r, minlength=n_nodes)
        return cls(*(torch.from_numpy(np.ascontiguousarray(a, np.int64))
                     for a in (s[order], r[order], eid[order], deg)),
                   n_nodes, m)

    @classmethod
    def from_dense(cls, adj) -> "SparseGraph":
        """From a dense 0/1 adjacency (symmetric, zero diagonal)."""
        a = np.asarray(adj.cpu() if isinstance(adj, torch.Tensor) else adj)
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric")
        u, v = np.nonzero(np.triu(a, 1))
        return cls.from_undirected(u, v, a.shape[0])

    @classmethod
    def ring(cls, n_nodes: int) -> "SparseGraph":
        """Edge-list form of `ring_graph`: link k = (k, k+1 mod N), the
        order under which `sparse_link_keep` draws the same coins as
        `ring_link_keep`."""
        if n_nodes < 3:
            raise ValueError(f"a ring needs >= 3 nodes: {n_nodes}")
        i = np.arange(n_nodes)
        return cls.from_undirected(i, (i + 1) % n_nodes, n_nodes)

    def to(self, device) -> "SparseGraph":
        """The same graph with its arrays on `device`."""
        return SparseGraph(*(a.to(device) for a in (
            self.senders, self.receivers, self.edge_id, self.deg)),
            self.n_nodes, self.n_undirected)

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        """(N, N) adjacency as host numpy: the small-N oracle's view."""
        a = np.zeros((self.n_nodes, self.n_nodes), dtype)
        a[self.senders.cpu().numpy(), self.receivers.cpu().numpy()] = 1.0
        return a

    def __repr__(self):
        return (f"SparseGraph(n_nodes={self.n_nodes}, "
                f"n_undirected={self.n_undirected})")


class SparseWeights(NamedTuple):
    """Combination weights over a `SparseGraph`: w_edge[e] weights the
    directed message edge e and w_self[i] node i's own iterate, one
    row-stochastic combine phi_i <- w_self_i varphi_i
    + sum_e w_e varphi_send(e) without the (N, N) matrix.  The weights
    are host f64 numpy constants (bit-equal to the reference's); the
    combine casts them to the iterate's dtype on the run's device."""

    graph: SparseGraph
    w_edge: np.ndarray                # (E,) f64
    w_self: np.ndarray                # (N,) f64


def sparse_nearest_neighbor_weights(graph: SparseGraph) -> SparseWeights:
    """Eq. 47 in edge-list form: receiver i takes 1/(|N_i|+1) from itself
    and from each neighbour, `nearest_neighbor_weights`' rows.

    >>> sparse_nearest_neighbor_weights(SparseGraph.ring(3)).w_self.tolist()
    [0.3333333333333333, 0.3333333333333333, 0.3333333333333333]
    """
    inv = 1.0 / (graph.deg.cpu().numpy().astype(np.float64) + 1.0)
    return SparseWeights(graph, inv[graph.receivers.cpu().numpy()], inv)


def sparse_metropolis_weights(graph: SparseGraph) -> SparseWeights:
    """Metropolis-Hastings rule in edge-list form: symmetric, doubly
    stochastic."""
    deg = graph.deg.cpu().numpy().astype(np.float64)
    s = graph.senders.cpu().numpy()
    r = graph.receivers.cpu().numpy()
    w_e = 1.0 / (1.0 + np.maximum(deg[s], deg[r]))
    w_self = 1.0 - np.bincount(r, weights=w_e, minlength=graph.n_nodes)
    return SparseWeights(graph, w_e, w_self)


def sparse_link_keep(gen: LinkCoins, n_undirected: int, drop_prob: float,
                     dtype=torch.float32) -> torch.Tensor:
    """(E_undirected,) 0/1 keep mask on `gen`'s device: link k survives
    iff its coin (number k) is >= drop_prob; both directed edges of a
    link read coin `edge_id[e]`.  On `SparseGraph.ring(N)` it equals
    `ring_link_keep` bit for bit (the coin-order contract).

    >>> g = link_generator(5, 2, "cpu")
    >>> bool(torch.equal(sparse_link_keep(g, 6, 0.3), ring_link_keep(g, 6, 0.3)))
    True
    """
    return (_link_uniforms(gen, n_undirected) >= drop_prob).to(dtype)


def random_geometric_edges(n_nodes: int, *, side: float | None = None,
                           radius: float | None = None, seed: int = 0,
                           max_tries: int = 200):
    """Connected random geometric graph as a `SparseGraph` + positions
    ((N, 2) float64 CPU tensor): the large-N constructor.

    The same rng stream and side/radius rules as `random_geometric_graph`
    and the reference's `random_geometric_edges`: at equal arguments the
    positions, the links and their order are the reference's.  The
    links come from a cell list (`_radius_edges`), connectivity from
    edge-list label propagation: O(N + E) memory, no (N, N) or (chunk, N)
    block, N = 100,000 in seconds.
    """
    side = _paper_side(n_nodes, side)
    radius = _resolve_radius(n_nodes, side, radius)
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        pos = rng.uniform(0.0, side, size=(n_nodes, 2))
        u, v = _radius_edges(pos, radius)
        if _edges_connected(u, v, n_nodes):
            return (SparseGraph.from_undirected(u, v, n_nodes),
                    torch.from_numpy(pos))
    raise RuntimeError(
        f"could not sample a connected geometric graph (N={n_nodes}, "
        f"side={side}, radius={radius})")


def _radius_edges(pos: np.ndarray, radius: float):
    """Undirected links (u, v), u < v, ||pos_u - pos_v|| <= radius, in
    lexicographic (u, v) order: the reference's (chunk, N) blocks' order.

    A cell list: square cells of side radius (1 + 1e-9), so two points
    within `radius` lie in the same or adjacent cells whatever the
    rounding of pos / cell; each point is paired with the points of its
    3 x 3 cells, and a pair is kept on the reference's own test,
    np.sum((a - b) ** 2, -1) <= radius^2 (the same rounding: (a - b)^2 is
    (b - a)^2 exactly)."""
    n = pos.shape[0]
    cell = radius * (1.0 + 1e-9)
    ij = np.floor(pos / cell).astype(np.int64)
    ij -= ij.min(0, initial=0)
    nx, ny = (int(ij[:, 0].max(initial=0)) + 1,
              int(ij[:, 1].max(initial=0)) + 1)
    cid = ij[:, 0] * ny + ij[:, 1]
    order = np.argsort(cid, kind="stable")            # points by cell
    count = np.bincount(cid, minlength=nx * ny)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    us, vs = [], []
    r2 = radius * radius
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = ij[:, 0] + dx, ij[:, 1] + dy
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            a = np.nonzero(ok)[0]                     # points with that cell
            c = cx[a] * ny + cy[a]
            rep = count[c]
            total = int(rep.sum())
            if total == 0:
                continue
            u = np.repeat(a, rep)
            # position of each candidate inside its cell's run of `order`
            first = np.repeat(np.cumsum(rep) - rep, rep)
            v = order[np.repeat(start[c], rep) + np.arange(total) - first]
            keep = u < v
            u, v = u[keep], v[keep]
            d2 = np.sum((pos[u] - pos[v]) ** 2, axis=-1)
            keep = d2 <= r2
            us.append(u[keep])
            vs.append(v[keep])
    if not us:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    u, v = np.concatenate(us), np.concatenate(vs)
    lex = np.lexsort((v, u))                          # by u, then v
    return u[lex], v[lex]


def _edges_connected(u: np.ndarray, v: np.ndarray, n: int) -> bool:
    """Connectivity from an undirected link list: vectorised min-label
    propagation with pointer jumping, O(E) a sweep."""
    if n <= 1:
        return True
    if u.size == 0:
        return False
    lbl = np.arange(n)
    for _ in range(n):
        new = lbl.copy()
        np.minimum.at(new, u, lbl[v])
        np.minimum.at(new, v, lbl[u])
        new = new[new]                   # pointer jumping
        if np.array_equal(new, lbl):
            break
        lbl = new
    return bool((lbl == 0).all())


def two_level_partition(n_nodes: int, n_gateways: int, n_regions: int):
    """Balanced contiguous sensor -> gateway -> region assignment for
    `engine.HierarchicalFusion`: (gateway_of (N,), region_of (G,)) int64
    CPU tensors.

    >>> g, r = two_level_partition(6, 3, 2)
    >>> (g.tolist(), r.tolist())
    ([0, 0, 1, 1, 2, 2], [0, 0, 1])
    """
    if not 1 <= n_regions <= n_gateways <= n_nodes:
        raise ValueError(
            f"need 1 <= regions ({n_regions}) <= gateways ({n_gateways}) "
            f"<= nodes ({n_nodes})")
    gateway_of = (np.arange(n_nodes) * n_gateways) // n_nodes
    region_of = (np.arange(n_gateways) * n_regions) // n_gateways
    return torch.from_numpy(gateway_of), torch.from_numpy(region_of)
