"""The paper's algorithms with the node axis split over the ranks of a
process group (port of `repro.core.distributed`).

These are the engine's step functions of core/algorithms.py; the only
difference is the executor: `MeshExecutor(group)` gives each rank a
contiguous block of nodes and each topology swaps its combine for the
equivalent collective:

* `Diffusion` / `ADMMConsensus` — the faithful arbitrary-graph
  algorithms: the combine `W @ varphi` needs every node's message, which
  on an arbitrary graph is an all-gather along the group followed by the
  local rows of W;
* `RingDiffusion` — the ring of ranks: each rank sends its two boundary
  rows to its ring neighbours (`ring_diffusion_combine`) and no rank
  gathers the rest.

SPMD: every rank calls with the same global inputs and returns the
whole (N, P) result.  The sharded runs are held against the single-array
runners in tests/test_torch_mesh_executor.py.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core import model as model_lib

# the ring combine primitive lives in repro_torch.dist.collectives
ring_diffusion_combine = engine.ring_combine_block


def run_dsvb_sharded(executor, x, mask, weights, prior, *, n_iters: int,
                     K: int, D: int, tau: float = 0.2, d0: float = 1.0,
                     backend=None, device=None) -> torch.Tensor:
    """Faithful dSVB with the node axis split over `executor`'s ranks.
    x (N, Ni, D), mask (N, Ni), weights (N, N) row-stochastic; returns the
    final (N, P) natural parameters on every rank.  The fused backend's
    kernel runs on each rank's rows."""
    run = engine.run_vb(
        model_lib.GMMModel(prior, K, D, backend=backend, device=device),
        (x, mask), engine.Diffusion(weights), n_iters=n_iters,
        schedule=engine.Schedule(tau=tau, d0=d0), executor=executor,
        diagnostics=False, device=device)
    return run.phi


def run_dsvb_ring_sharded(executor, x, mask, prior, *, n_iters: int,
                          K: int, D: int, tau: float = 0.2, d0: float = 1.0,
                          w_self: float = 1.0 / 3.0, backend=None,
                          device=None) -> torch.Tensor:
    """dSVB on the ring: node blocks per rank, combined by the boundary
    exchange only (no all-gather)."""
    run = engine.run_vb(
        model_lib.GMMModel(prior, K, D, backend=backend, device=device),
        (x, mask), engine.RingDiffusion(w_self), n_iters=n_iters,
        schedule=engine.Schedule(tau=tau, d0=d0), executor=executor,
        diagnostics=False, device=device)
    return run.phi


def run_admm_sharded(executor, x, mask, adj, prior, *, n_iters: int,
                     K: int, D: int, rho: float = 0.5, xi: float = 0.05,
                     project: bool = True, lam_max: float | None = None,
                     backend=None, device=None) -> torch.Tensor:
    """Faithful dVB-ADMM with the node axis split over `executor`'s
    ranks."""
    run = engine.run_vb(
        model_lib.GMMModel(prior, K, D, backend=backend, device=device),
        (x, mask), engine.ADMMConsensus(adj, rho=rho, xi=xi,
                                        project=project, lam_max=lam_max),
        n_iters=n_iters, executor=executor, diagnostics=False,
        device=device)
    return run.phi


def run_vb_sharded(executor, model, data, topology, *, n_iters: int,
                   **kw) -> engine.VBRun:
    """Any ConjugateExpModel x topology with the node axis split over
    `executor`'s ranks (`engine.run_vb`'s keywords)."""
    return engine.run_vb(model, data, topology, n_iters=n_iters,
                         executor=executor, **kw)


__all__ = [
    "ring_diffusion_combine", "run_dsvb_sharded", "run_dsvb_ring_sharded",
    "run_admm_sharded", "run_vb_sharded",
]
