"""Shared machinery of the Sec. V experiments (experiments/paper_figures).

Port of `benchmarks/common.py`.  Nothing is written to disk: what a figure
hands to the next one stays in memory.  The random initial
posterior of every figure is the reference's: `jax.random.uniform(
PRNGKey(seed), (K, D), float64)` draws, generated once by
`tools/torch_reference_draws.py` into `reference_draws.npz` beside this
module (torch cannot reproduce `jax.random`).
"""
from __future__ import annotations

import functools
import itertools
import os
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import algorithms, expfam, gmm, network, refperm

DRAWS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "reference_draws.npz")


def draw_key(seed: int, K: int, D: int) -> str:
    """Name of the (K, D) draws of `seed` in reference_draws.npz."""
    return f"seed{seed}_K{K}_D{D}"


@functools.lru_cache(maxsize=None)
def _draws() -> dict:
    with np.load(DRAWS_PATH) as f:
        return {k: f[k] for k in f.files}


def reference_draws(seed: int, K: int, D: int) -> np.ndarray:
    """The reference's (K, D) uniform draws of the initial means."""
    key = draw_key(seed, K, D)
    draws = _draws()
    if key not in draws:
        raise KeyError(f"no reference draws {key} in {DRAWS_PATH}; add "
                       f"(K, D) = ({K}, {D}) to tools/torch_reference_"
                       "draws.py and run it")
    return draws[key]


def setup_gmm(data, K, D, *, seed=0, graph_seed=0, beta0=0.1, w0=10.0,
              device=None):
    """Prior, graph (adjacency and Eq. 47 weights), the Eq. 46 reference
    stack (K <= 6) and the perturbed initial posterior, on `device`."""
    dev = device_lib.resolve(device)
    prior = expfam.noninformative_prior(K, D, beta0=beta0, w0_scale=w0,
                                        dtype=torch.float64, device=dev)
    n = data.x.shape[0]
    adj, _ = network.random_geometric_graph(n, seed=graph_seed)
    W = network.nearest_neighbor_weights(adj)
    x_all, labels_all = data.flat
    ref = gmm.ground_truth_posterior(x_all.to(dev), labels_all.to(dev),
                                     prior, K)
    ref_phis = refperm.permuted_refs(ref) if K <= 6 else None
    init_q = algorithms.perturbed_init(prior, data.x.to(dev),
                                       reference_draws(seed, K, D))
    return dict(prior=prior, adj=adj.to(dev), W=W.to(dev),
                ref_phis=ref_phis, init_q=init_q, x=data.x.to(dev),
                mask=data.mask.to(dev))


def timed(fn, *args, **kw):
    """(fn(...), wall seconds), the clock stopped after the device's work
    (`torch.cuda.synchronize()` when a card is present)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def us_per_iter(wall_s: float, n_iters: int, n_repeat: int = 1) -> float:
    return wall_s / (n_iters * n_repeat) * 1e6


@functools.lru_cache(maxsize=None)
def _perms(K: int) -> torch.Tensor:
    return torch.tensor(list(itertools.permutations(range(K))))


def accuracy(data, phi_nodes, K, D) -> float:
    """Mean clustering accuracy over nodes, best label permutation per
    node (exhaustive, as the reference)."""
    x_all, labels = data.flat
    q = expfam.unpack_natural(phi_nodes, K, D)
    pred = gmm.predict_labels(x_all.to(phi_nodes.device), q).cpu()  # (N, M)
    labels = labels.long()
    perms = _perms(K)
    accs = []
    for i in range(pred.shape[0]):
        # counts[c, l]: points predicted c with label l; a permutation p
        # scores sum_c counts[c, p[c]]
        counts = torch.zeros(K, K, dtype=torch.int64)
        counts.index_put_((pred[i], labels), torch.ones_like(labels),
                          accumulate=True)
        best = int(counts[torch.arange(K), perms].sum(1).max())
        accs.append(best / labels.shape[0])
    return float(np.mean(accs))
