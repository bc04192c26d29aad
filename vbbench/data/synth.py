"""Sensor data and network topology made on the device from a seed.

The distribution is the paper's Sec. V-A (arXiv 2011.13600): K Gaussian
components in D dimensions with an imbalanced per-node allocation (the
first 30% of the nodes draw 80% of their points from component 1, the
next 40% draw 90% from component 2, the rest 60% from component 3), the
rule `repro_torch.data.synthetic.paper_synthetic` applies on the host.
Here every draw is a `torch.Generator` on the run's device, in a few
large calls, so a 100,000-sensor field (4.92 GB of x and mask) takes a
fraction of a second instead of the host generator's minutes.

The topology is a random geometric graph: node positions uniform in a
side x side square, a link wherever two nodes lie within the
communication radius.  Both come from the configuration file.

Nothing here imports the program: the arrays are inputs that the
benchmark hands to the program and to the plain reference alike.
"""
from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1


def mix_seed(*words: int) -> int:
    """A 63-bit generator seed from whole numbers (splitmix64 steps), so
    (run seed, session index) pairs give unrelated streams."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        h = z ^ (z >> 31)
    return h >> 1


def generator(device, *words: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(mix_seed(*words))
    return gen


def node_mixture(cfg: dict, n_nodes: int, device) -> torch.Tensor:
    """(n_nodes, K) per-node component weights: row i takes the weights
    of the first band whose upper edge (a share of the nodes, rounded as
    the host generator rounds) lies above i."""
    mix = cfg["mixture"]
    out = torch.empty(n_nodes, len(mix["pi"]), dtype=torch.float64)
    lo = 0
    for edge, weights in mix["node_bands"]:
        hi = n_nodes if edge >= 1.0 else int(round(edge * n_nodes))
        w = torch.tensor(weights, dtype=torch.float64)
        out[lo:hi] = w / w.sum()
        lo = hi
    return out.to(device)


def components(cfg: dict, n_nodes: int, device) -> tuple:
    """(mu (K, D), Cholesky factors (K, D, D), cumulative node weights
    (N, K - 1)) in float32 on `device`: what every draw of a field
    reads, made once by a caller that draws many."""
    mix = cfg["mixture"]
    mu = torch.tensor(mix["mu"], dtype=torch.float64)
    L = torch.linalg.cholesky(torch.tensor(mix["sigma"], dtype=torch.float64))
    cum = node_mixture(cfg, n_nodes, device).cumsum(1)[:, :-1].float()
    return mu.to(device, torch.float32), L.to(device, torch.float32), cum


def sensor_data(cfg: dict, n_nodes: int, n_points: int, device, *words: int,
                chunk: int = 8192, labels: bool = False, comps=None):
    """(x (N, T, D) float32, mask (N, T) float32[, labels (N, T) int64])
    drawn from the generator keyed by `words`.  Labels are drawn by
    inverse CDF of one uniform a point against the node's cumulative
    weights; x = mu_k + L_k z with L_k the Cholesky factor of Sigma_k.
    Nodes are drawn `chunk` at a time from one generator, so the arrays
    depend on the seed alone.  `comps`: `components(cfg, n_nodes,
    device)`, made once by the caller."""
    mu, L, cum = comps or components(cfg, n_nodes, device)
    K, D = mu.shape
    gen = generator(device, *words)
    x = torch.empty(n_nodes, n_points, D, dtype=torch.float32, device=device)
    lab_out = (torch.empty(n_nodes, n_points, dtype=torch.int64,
                           device=device) if labels else None)
    for lo in range(0, n_nodes, chunk):
        hi = min(lo + chunk, n_nodes)
        u = torch.rand(hi - lo, n_points, generator=gen, device=device)
        lab = (u[..., None] > cum[lo:hi, None, :]).sum(-1)
        z = torch.randn(hi - lo, n_points, D, generator=gen, device=device)
        x[lo:hi] = mu[lab] + (L[lab] * z[..., None, :]).sum(-1)
        if labels:
            lab_out[lo:hi] = lab
        del u, lab, z
    mask = torch.ones(n_nodes, n_points, dtype=torch.float32, device=device)
    return (x, mask, lab_out) if labels else (x, mask)


def graph_edges(cfg: dict, n_nodes: int, device, *words: int,
                chunk: int = 1024):
    """Undirected links (u, v), u < v, as int64 CPU tensors in (u, v)
    order: node positions uniform in the configuration's square, a link
    where the squared distance is at most radius^2.  Pairs are tested a
    block of `chunk` rows at a time on the device."""
    side, radius = float(cfg["side"]), float(cfg["comm_radius"])
    gen = generator(device, *words)
    pos = torch.rand(n_nodes, 2, generator=gen, device=device,
                     dtype=torch.float64) * side
    r2 = radius * radius
    us, vs = [], []
    cols = torch.arange(n_nodes, device=device)
    for lo in range(0, n_nodes, chunk):
        hi = min(lo + chunk, n_nodes)
        d2 = ((pos[lo:hi, None, :] - pos[None, :, :]) ** 2).sum(-1)
        keep = (d2 <= r2) & (cols[None, :] > torch.arange(
            lo, hi, device=device)[:, None])
        i, j = keep.nonzero(as_tuple=True)
        us.append(i + lo)
        vs.append(j)
        del d2, keep
    return torch.cat(us).cpu(), torch.cat(vs).cpu()


def init_means(cfg: dict, seed: int) -> torch.Tensor:
    """(K, D) float64 initial component means, uniform in the
    configuration's `init_box` (the prior's means scattered over the
    data's range, the paper's random restart), from a CPU generator."""
    lo, hi = (torch.tensor(b, dtype=torch.float64) for b in cfg["init_box"])
    gen = generator("cpu", seed, 0x1217)
    u = torch.rand(cfg["K"], cfg["D"], generator=gen, dtype=torch.float64)
    return lo + (hi - lo) * u


def paper_side_radius(n_nodes: int) -> tuple[float, float]:
    """The side and radius rule of the paper's network scaled to N nodes
    at constant density (side 3.5 at 50 nodes; radius 0.8, never below
    1.3 times the connectivity threshold side sqrt(ln N / (pi N)))."""
    side = 3.5 * math.sqrt(n_nodes / 50.0)
    rc = side * math.sqrt(math.log(n_nodes) / (math.pi * n_nodes))
    return side, max(0.8, 1.3 * rc)
