"""Surrogate real-data generators for the paper's Tables I/II and Fig. 13.

Port of `repro.data.datasets`.  Each surrogate matches the published
dataset's dimensionality, cardinality and class structure, so the
relative ordering of the algorithms can be checked (absolute accuracies
are not comparable digit for digit and are not claimed).  The draws are
the reference's numpy draws, so the arrays equal the reference's; they
come back as CPU tensors (x and mask float64, labels int32).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import SensorData, _tensors


def _to_sensor_data(x, labels, n_nodes, rng) -> SensorData:
    """Shuffle and deal samples uniformly to nodes (the papers' allocation
    for the real-data experiments)."""
    idx = rng.permutation(len(x))
    x, labels = x[idx], labels[idx]
    n = (len(x) // n_nodes) * n_nodes
    x, labels = x[:n], labels[:n]
    per = n // n_nodes
    xs = x.reshape(n_nodes, per, x.shape[-1])
    ls = labels.reshape(n_nodes, per)
    mask = np.ones((n_nodes, per))
    return _tensors(np.ascontiguousarray(xs), mask, ls.astype(np.int32))


def atmosphere_surrogate(n_nodes: int = 20, *, seed: int = 0) -> SensorData:
    """1600 samples x 3 features (SO2, NO2, PM10), 2 classes (clean 830 /
    polluted 770), well separated."""
    rng = np.random.default_rng(seed)
    clean = rng.multivariate_normal(
        [0.02, 0.03, 0.06], np.diag([1e-4, 2e-4, 4e-4]), 830)
    polluted = rng.multivariate_normal(
        [0.12, 0.15, 0.35], np.diag([9e-4, 1.2e-3, 4e-3]), 770)
    x = np.concatenate([clean, polluted])
    labels = np.concatenate([np.zeros(830), np.ones(770)])
    return _to_sensor_data(x, labels, n_nodes, rng)


def ionosphere_surrogate(n_nodes: int = 20, *, seed: int = 0) -> SensorData:
    """340 samples x 34 attributes, 2 overlapping classes."""
    rng = np.random.default_rng(seed)
    d = 34
    mu_good = rng.normal(0.4, 0.3, d)
    mu_bad = mu_good + rng.normal(0.0, 0.55, d)     # partial overlap
    a = rng.normal(size=(d, d)) * 0.12
    cov_good = a @ a.T + np.eye(d) * 0.25
    b = rng.normal(size=(d, d)) * 0.2
    cov_bad = b @ b.T + np.eye(d) * 0.45
    good = rng.multivariate_normal(mu_good, cov_good, 218)
    bad = rng.multivariate_normal(mu_bad, cov_bad, 122)
    x = np.concatenate([good, bad])
    labels = np.concatenate([np.zeros(218), np.ones(122)])
    return _to_sensor_data(x, labels, n_nodes, rng)


def coil20_surrogate(n_classes: int, n_nodes: int = 10, *,
                     seed: int = 0) -> SensorData:
    """COIL-20 after PCA: 72 images per object, 52 dims; rotation sweeps
    make each class an elongated low-rank cluster."""
    rng = np.random.default_rng(seed)
    d = 52
    xs, ls = [], []
    for k in range(n_classes):
        center = rng.normal(0.0, 2.2, d)
        # low-rank elongation (the turntable rotation manifold)
        basis = rng.normal(size=(d, 4)) * 0.9
        t = rng.normal(size=(72, 4))
        xs.append(center + t @ basis.T + rng.normal(0.0, 0.25, (72, d)))
        ls.append(np.full(72, k))
    x = np.concatenate(xs)
    labels = np.concatenate(ls)
    return _to_sensor_data(x, labels, n_nodes, rng)
