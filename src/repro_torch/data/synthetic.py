"""Synthetic sensor-network data — the paper's Sec. V-A generator.

Three 2-D Gaussian components; 50 nodes x 100 points with the published
*imbalanced* allocation (nodes 1-15 draw 80% from component 1, nodes 16-35
draw 90% from component 2, nodes 36-50 draw 60% from component 3).  Also the
balanced/unequal-size variants used in Sec. V-C.

The draws are the reference's numpy draws, so the arrays equal
`repro.data.synthetic`'s; they come back as CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Paper Sec. V-A ground-truth parameters
PAPER_PI = np.array([0.32, 0.45, 0.23])
PAPER_MU = np.array([[1.5, 3.5], [4.0, 4.0], [6.5, 4.5]])
PAPER_SIGMA = np.array([
    [[0.6, 0.4], [0.4, 0.6]],
    [[0.6, -0.4], [-0.4, 0.6]],
    [[0.6, 0.4], [0.4, 0.6]],
])


class SensorData(NamedTuple):
    x: torch.Tensor        # (N_nodes, Ni_max, D), zero-padded
    mask: torch.Tensor     # (N_nodes, Ni_max) 1 = valid sample
    labels: torch.Tensor   # (N_nodes, Ni_max) true component

    @property
    def flat(self):
        """(x_all, labels_all) with padding removed."""
        m = self.mask.bool()
        return self.x[m], self.labels[m]


def _sample_component(rng, k, n):
    return rng.multivariate_normal(PAPER_MU[k], PAPER_SIGMA[k], size=n)


def _node_mixture(node: int, n_nodes: int) -> np.ndarray:
    """Per-node component mixture of Sec. V-A, rescaled to any N."""
    a, b = int(round(0.3 * n_nodes)), int(round(0.7 * n_nodes))
    if node < a:           # dominated by component 1
        return np.array([0.8, 0.1, 0.1])
    elif node < b:         # dominated by component 2
        return np.array([0.05, 0.9, 0.05])
    else:                  # dominated by component 3
        return np.array([0.2, 0.2, 0.6])


def _tensors(x, mask, labels) -> SensorData:
    return SensorData(x=torch.from_numpy(x), mask=torch.from_numpy(mask),
                      labels=torch.from_numpy(labels))


def paper_synthetic(n_nodes: int = 50, n_per_node: int = 100, *,
                    seed: int = 0, imbalanced: bool = True,
                    unequal_sizes: bool = False,
                    dtype=np.float64) -> SensorData:
    """The Sec. V-A dataset (imbalanced=True) or the Sec. V-C variants."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_nodes, n_per_node)
    if unequal_sizes:  # Sec. V-C1: 40..160 points per node
        sizes = rng.integers(40, 161, size=n_nodes)
    ni_max = int(sizes.max())
    x = np.zeros((n_nodes, ni_max, 2), dtype)
    mask = np.zeros((n_nodes, ni_max), dtype)
    labels = np.zeros((n_nodes, ni_max), np.int32)
    for i in range(n_nodes):
        p = _node_mixture(i, n_nodes) if imbalanced else PAPER_PI
        lab = rng.choice(3, size=sizes[i], p=p / p.sum())
        for k in range(3):
            idx = np.nonzero(lab == k)[0]
            if idx.size:
                x[i, idx] = _sample_component(rng, k, idx.size)
        labels[i, :sizes[i]] = lab
        mask[i, :sizes[i]] = 1.0
    return _tensors(x, mask, labels)


def gmm_data(n_nodes: int, n_per_node: int, pi, mu, sigma, *, seed: int = 0,
             dtype=np.float64) -> SensorData:
    """General balanced GMM sampler (arbitrary K, D) for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    pi = np.asarray(pi) / np.sum(pi)
    mu = np.asarray(mu)
    sigma = np.asarray(sigma)
    K, D = mu.shape
    x = np.zeros((n_nodes, n_per_node, D), dtype)
    labels = np.zeros((n_nodes, n_per_node), np.int32)
    for i in range(n_nodes):
        lab = rng.choice(K, size=n_per_node, p=pi)
        for k in range(K):
            idx = np.nonzero(lab == k)[0]
            if idx.size:
                x[i, idx] = rng.multivariate_normal(mu[k], sigma[k], idx.size)
        labels[i] = lab
    mask = np.ones((n_nodes, n_per_node), dtype)
    return _tensors(x, mask, labels)
