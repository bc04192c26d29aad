"""The paper's five VB estimators over a sensor network — GMM instance.

Port of `repro.core.algorithms`.  All five are ONE engine call: the
Bayesian-GMM model composed with a topology:

* cVB        — FusionCenter, one-shot      phi <- mean_i phi*_i   (Eq. 20)
* noncoop-VB — Isolated, one-shot, unreplicated data
* nsg-dVB    — Diffusion, one-shot (neighbour averaging of local optima)
* dSVB       — Algorithm 1: Schedule(tau, d0) (27a) + Diffusion (27b)
* dVB-ADMM   — Algorithm 2: ADMMConsensus (38a [+38b], 39, 40)

The initial posterior is an argument (`init_q`, default the prior).  The
reference's random restart `_perturbed_init` draws from `jax.random`,
which torch cannot reproduce: `perturbed_init` takes the (K, D) uniform
draws explicitly (the reference's, for parity), or draws them from a
`torch.Generator`.  `device=None` runs on the CUDA device.

The graph arguments take either form: `weights` a dense (N, N) matrix
or a `network.SparseWeights`, `adj` a dense adjacency or a
`network.SparseGraph` (the engine's sparse combines, O(E + N)).
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, expfam
from repro_torch.core import model as model_lib
from repro_torch.core.engine import (  # noqa: F401  (re-exported API)
    VBRun, eta_schedule, kappa_schedule,
)
from repro_torch.core.expfam import GMMPosterior


def perturbed_init(prior: GMMPosterior, x, u=None, *, spread: float = 1.0,
                   generator: torch.Generator | None = None) -> GMMPosterior:
    """Random-restart initialisation: the prior with its means scattered
    over the data range, m = lo + (hi - lo) u for (K, D) uniform draws u
    (`lo`, `hi` the per-coordinate min and max of x, padding included, as
    in the reference).  `u` given: those draws (the reference's
    `jax.random.uniform(key, (K, D))`, for parity); None: drawn from
    `generator` on the CPU."""
    K, D = prior.K, prior.D
    xf = engine._as_tensor(x).reshape(-1, D).to(prior.m.device)
    lo, hi = xf.amin(0), xf.amax(0)
    if u is None:
        u = torch.rand((K, D), generator=generator, dtype=prior.m.dtype)
    u = engine._as_tensor(u).to(prior.m)
    m = lo + (hi - lo) * u
    return prior._replace(m=prior.m + spread * (m - prior.m))


def _gmm_run(x, mask, prior, topology, schedule, *, n_iters, K, D,
             replication=None, ref_phi=None, init_q=None, metric_nodes=None,
             backend=None, device=None):
    mdl = model_lib.GMMModel(prior, K, D, backend=backend, device=device)
    q0 = mdl.prior if init_q is None else init_q.to(mdl.device)
    phi0 = expfam.pack_natural(q0).expand(x.shape[0], mdl.flat_dim)
    return engine.run_vb(mdl, (x, mask), topology, n_iters=n_iters,
                         schedule=schedule, replication=replication,
                         init_phi=phi0, ref_phi=ref_phi,
                         metric_nodes=metric_nodes, device=mdl.device)


def run_cvb(x, mask, prior: GMMPosterior, *, n_iters: int, K: int, D: int,
            ref_phi=None, init_q: GMMPosterior | None = None,
            backend=None, device=None) -> VBRun:
    """cVB — the fusion centre computes Eq. 20 exactly.  All nodes share
    one iterate, so the metric is evaluated on one node (kl_nodes is
    (T, 1)) with zero spread."""
    run = _gmm_run(x, mask, prior, engine.FusionCenter(), engine.ONE_SHOT,
                   n_iters=n_iters, K=K, D=D, ref_phi=ref_phi,
                   init_q=init_q, metric_nodes=1, backend=backend,
                   device=device)
    return VBRun(phi=run.phi, kl_mean=run.kl_nodes[:, 0],
                 kl_std=run.phi.new_zeros(n_iters), kl_nodes=run.kl_nodes,
                 consensus_err=run.consensus_err)


def run_noncoop(x, mask, prior: GMMPosterior, *, n_iters: int, K: int,
                D: int, ref_phi=None, init_q: GMMPosterior | None = None,
                backend=None, device=None) -> VBRun:
    """noncoop-VB — isolated nodes, unreplicated local data."""
    return _gmm_run(x, mask, prior, engine.Isolated(), engine.ONE_SHOT,
                    n_iters=n_iters, K=K, D=D, replication=1.0,
                    ref_phi=ref_phi, init_q=init_q, backend=backend,
                    device=device)


def run_nsg_dvb(x, mask, weights, prior: GMMPosterior, *, n_iters: int,
                K: int, D: int, ref_phi=None,
                init_q: GMMPosterior | None = None, backend=None,
                device=None) -> VBRun:
    """nsg-dVB — one-step averaging of local optima (Sec. III-A)."""
    return _gmm_run(x, mask, prior, engine.Diffusion(weights),
                    engine.ONE_SHOT, n_iters=n_iters, K=K, D=D,
                    ref_phi=ref_phi, init_q=init_q, backend=backend,
                    device=device)


def run_dsvb(x, mask, weights, prior: GMMPosterior, *, n_iters: int,
             K: int, D: int, tau: float = 0.2, d0: float = 1.0,
             ref_phi=None, init_q: GMMPosterior | None = None,
             backend=None, link_drop: float = 0.0, link_seed: int = 0,
             device=None) -> VBRun:
    """dSVB — Algorithm 1 (stochastic natural gradient + diffusion);
    `link_drop` fails each link with that probability per iteration."""
    topology = engine.Diffusion(weights, link_drop=link_drop,
                                link_seed=link_seed)
    return _gmm_run(x, mask, prior, topology,
                    engine.Schedule(tau=tau, d0=d0), n_iters=n_iters,
                    K=K, D=D, ref_phi=ref_phi, init_q=init_q,
                    backend=backend, device=device)


def run_dvb_admm(x, mask, adj, prior: GMMPosterior, *, n_iters: int,
                 K: int, D: int, rho: float = 0.5, xi: float = 0.05,
                 project: bool = True, lam_max: float | None = None,
                 adaptive_rho: bool = False, per_block: bool = False,
                 dual_warmup: bool | str = "auto",
                 dual_reset: float | None | str = "auto",
                 ref_phi=None, init_q: GMMPosterior | None = None,
                 backend=None, link_drop: float = 0.0, link_seed: int = 0,
                 device=None) -> VBRun:
    """dVB-ADMM — Algorithm 2; defaults are the paper verbatim.
    `adaptive_rho=True` is the convergent adaptive-penalty configuration
    (residual balancing + dual warmup + dual reset); `link_drop` fails
    each link with that probability per iteration.  The per-iteration
    `ConsensusDiagnostics` come back on `VBRun.consensus_diag`.
    Finer-grained knobs: `engine.run_vb` with an `engine.ADMMConsensus`."""
    topology = engine.ADMMConsensus(adj, rho=rho, xi=xi, project=project,
                                    lam_max=lam_max,
                                    adaptive_rho=adaptive_rho,
                                    per_block=per_block,
                                    dual_warmup=dual_warmup,
                                    dual_reset=dual_reset,
                                    link_drop=link_drop,
                                    link_seed=link_seed)
    return _gmm_run(x, mask, prior, topology, engine.Schedule(),
                    n_iters=n_iters, K=K, D=D, ref_phi=ref_phi,
                    init_q=init_q, backend=backend, device=device)


ALGORITHMS = {
    "cvb": run_cvb,
    "noncoop": run_noncoop,
    "nsg_dvb": run_nsg_dvb,
    "dsvb": run_dsvb,
    "dvb_admm": run_dvb_admm,
}
