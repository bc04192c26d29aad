"""Second conjugate-exponential instance: distributed Bayesian linear
regression with Normal-Gamma conjugacy.

Port of `repro.core.linreg`.  The model

    y_ij = w^T x_ij + eps,   eps ~ N(0, lambda^{-1})
    lambda ~ Gamma(a0, b0),  w | lambda ~ N(m0, (lambda V0)^{-1})

has no local latent variables, so the local optimum phi*_i (Eq. 18) is an
explicit function of the replicated local sufficient statistics and the
paper's consensus machinery runs verbatim in the natural-parameter space

    u(w, lambda) = [ln lambda, lambda, lambda w, lambda w w^T]
    phi = [a - 1 + D/2,  -(b + m^T V m / 2),  V m,  -V/2]

cVB is exact single-shot averaging (Eq. 20); dSVB and dVB-ADMM converge
to the exact pooled posterior.  Every function takes leading batch
dimensions (nodes, rows of a block) on its fields and flat vectors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.expfam import ordered_sum


class NGPosterior(NamedTuple):
    """Normal-Gamma hyperparameters: lambda ~ Ga(a, b),
    w | lambda ~ N(m, (lambda V)^-1)."""

    m: torch.Tensor   # (..., D)
    V: torch.Tensor   # (..., D, D)  precision scale
    a: torch.Tensor   # (...,)
    b: torch.Tensor   # (...,)

    @property
    def D(self) -> int:
        return self.m.shape[-1]

    def to(self, *args, **kwargs) -> "NGPosterior":
        return NGPosterior(*(t.to(*args, **kwargs) for t in self))


def prior(D: int, *, a0: float = 1.0, b0: float = 1.0, v0: float = 1e-2,
          dtype=torch.float64, device="cpu") -> NGPosterior:
    """The reference's default prior (m0 = 0, V0 = v0 I), on `device`."""
    kw = {"dtype": dtype, "device": device}
    return NGPosterior(m=torch.zeros((D,), **kw),
                       V=torch.eye(D, **kw) * v0,
                       a=torch.tensor(a0, **kw), b=torch.tensor(b0, **kw))


def flat_dim(D: int) -> int:
    return 2 + D + D * D


#: block names of the flat Normal-Gamma message, in `block_labels` order:
#: n1 (Gamma shape), n2 (Gamma rate carrier), n3 (V m), n4 (-V/2).
BLOCK_NAMES = ("shape", "rate", "mean", "precision")


def block_labels(D: int) -> np.ndarray:
    """(P,) int32 block label per flat coordinate (host array)."""
    return np.asarray([0, 1] + [2] * D + [3] * (D * D), np.int32)


def _quad(m: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """m^T V m over leading dimensions."""
    return (m[..., None, :] @ V @ m[..., :, None])[..., 0, 0]


def pack(q: NGPosterior) -> torch.Tensor:
    D = q.D
    n1 = q.a - 1.0 + D / 2.0
    n2 = -(q.b + 0.5 * _quad(q.m, q.V))
    n3 = (q.V @ q.m[..., None])[..., 0]
    n4 = -0.5 * q.V
    return torch.cat([n1[..., None], n2[..., None], n3, n4.flatten(-2)], -1)


def unpack(phi: torch.Tensor, D: int) -> NGPosterior:
    n1, n2 = phi[..., 0], phi[..., 1]
    n3 = phi[..., 2:2 + D]
    V = -2.0 * phi[..., 2 + D:].reshape(phi.shape[:-1] + (D, D))
    m = torch.linalg.solve(V, n3[..., None])[..., 0]
    a = n1 + 1.0 - D / 2.0
    b = -n2 - 0.5 * _quad(m, V)
    return NGPosterior(m=m, V=V, a=a, b=b)


def log_partition(q: NGPosterior) -> torch.Tensor:
    """A(phi) = ln Gamma(a) - a ln b - 1/2 ln|V| + D/2 ln 2pi."""
    return (torch.lgamma(q.a) - q.a * torch.log(q.b)
            - 0.5 * torch.linalg.slogdet(q.V).logabsdet
            + q.D / 2.0 * math.log(2.0 * math.pi))


def expected_stats(q: NGPosterior):
    """E[u] = (E[ln l], E[l], E[l w], E[l w w^T])."""
    e_loglam = torch.digamma(q.a) - torch.log(q.b)
    e_lam = q.a / q.b
    e_lw = e_lam[..., None] * q.m
    mm = q.m[..., :, None] * q.m[..., None, :]
    e_lww = torch.linalg.inv(q.V) + e_lam[..., None, None] * mm
    return e_loglam, e_lam, e_lw, e_lww


def kl(q: NGPosterior, p: NGPosterior) -> torch.Tensor:
    """KL(q || p) via the exp-family identity (Eq. 46 analogue)."""
    e_loglam, e_lam, e_lw, e_lww = expected_stats(q)
    dq, dp = pack(q), pack(p)
    D = q.D
    diff = dq - dp
    inner = (diff[..., 0] * e_loglam + diff[..., 1] * e_lam
             + (diff[..., 2:2 + D] * e_lw).sum(-1)
             + (diff[..., 2 + D:].reshape(diff.shape[:-1] + (D, D))
                * e_lww).sum((-1, -2)))
    return inner - log_partition(q) + log_partition(p)


# ---------------------------------------------------------------------------
# Local optimum (Eq. 18) from replicated local sufficient statistics
# ---------------------------------------------------------------------------
def local_optimum(X, y, mask, q0: NGPosterior, replication: float):
    """phi*_i of node data X (..., n, D), y (..., n), mask (..., n),
    replicated `replication` times.  The sums over the points go through
    `ordered_sum`, so mask-zero padding leaves them bit-identical."""
    w = mask
    Xw = X * w[..., None]                                      # (..., n, D)
    dim = X.dim() - 2                                          # points axis
    XtX = ordered_sum(Xw[..., :, None] * X[..., None, :],
                      dim=dim) * replication
    Xty = ordered_sum(Xw * y[..., None], dim=dim) * replication
    yty = ordered_sum((y * y * w)[..., None], dim=dim)[..., 0] * replication
    n = ordered_sum(w[..., None], dim=dim)[..., 0] * replication
    V = q0.V + XtX
    rhs = (q0.V @ q0.m[:, None])[:, 0] + Xty
    m = torch.linalg.solve(V, rhs[..., None])[..., 0]
    a = q0.a + n / 2.0
    b = q0.b + 0.5 * (yty + _quad(q0.m, q0.V) - _quad(m, V))
    return pack(NGPosterior(m=m, V=V, a=a, b=b))


def pooled_posterior(X_all, y_all, q0: NGPosterior) -> NGPosterior:
    """Exact Bayesian posterior on the pooled data — the reference."""
    mask = torch.ones(X_all.shape[0], dtype=X_all.dtype,
                      device=X_all.device)
    return unpack(local_optimum(X_all, y_all, mask, q0, 1.0), q0.D)


# ---------------------------------------------------------------------------
# Distributed estimators — engine wrappers.  phi*_i is constant across
# iterations, so `LinRegModel` takes the (N, P) phi* stack as its data and
# the engine runs the paper's consensus dynamics (Eqs. 27 / 38a+39) on it.
# ---------------------------------------------------------------------------
def _fixed_point_model(phi_star: torch.Tensor, device):
    from repro_torch.core import model as model_lib
    return model_lib.LinRegModel.from_flat_dim(phi_star.shape[-1],
                                               device=device)


def run_cvb(phi_star: torch.Tensor) -> torch.Tensor:
    """Eq. 20: fusion-centre average (exact in one step)."""
    return engine.FusionCenter().combine(phi_star)[0]


def run_dsvb(phi_star, weights, *, n_iters: int, tau: float = 0.2,
             d0: float = 1.0, device=None) -> torch.Tensor:
    """Eq. 27 with fixed local optima; returns the (N, P) final iterates.
    Nodes start at their own local optimum.  `device=None` runs on the
    CUDA device."""
    run = engine.run_vb(_fixed_point_model(phi_star, device), phi_star,
                        engine.Diffusion(weights), n_iters=n_iters,
                        schedule=engine.Schedule(tau=tau, d0=d0),
                        init_phi=phi_star, diagnostics=False, device=device)
    return run.phi


def run_admm(phi_star, adj, *, n_iters: int, rho: float = 0.5,
             xi: float = 0.05, device=None) -> torch.Tensor:
    """Eqs. 38a + 39 with fixed local optima (no projection)."""
    run = engine.run_vb(_fixed_point_model(phi_star, device), phi_star,
                        engine.ADMMConsensus(adj, rho=rho, xi=xi,
                                             project=False),
                        n_iters=n_iters, init_phi=phi_star,
                        diagnostics=False, device=device)
    return run.phi
