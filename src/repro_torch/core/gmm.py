"""Bayesian Gaussian-mixture model — the paper's application (Sec. IV + App. A).

Port of `repro.core.gmm`, the REFERENCE implementation of the per-node hot
path (three passes over the data).  Each node i holds data x_i (Ni, D); the
local model uses the replicated likelihood, so every local count is scaled
by the replication factor (Appendix A: R_ik = N * sum_j r_ijk, etc.).

Where the reference vmaps over nodes, these functions take a leading node
axis written out: x (..., T, D), mask (..., T), posterior fields with the
same leading axes.  `core/backends.py` selects between this path and the
fused kernel (`kernels/gmm_estep.py`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import expfam
from repro_torch.core.expfam import GMMPosterior

_LOG_2PI = math.log(2.0 * math.pi)


class SuffStats(NamedTuple):
    """Replicated sufficient statistics of Appendix A (per component)."""

    R: torch.Tensor       # (..., K)        R_k = N * sum_j r_jk
    sum_x: torch.Tensor   # (..., K, D)     N * sum_j r_jk x_j
    sum_xx: torch.Tensor  # (..., K, D, D)  N * sum_j r_jk x_j x_j^T


def _log_rho(x: torch.Tensor, q: GMMPosterior) -> torch.Tensor:
    """ln rho_jk = E[ln pi_k] + 1/2 E[ln|L_k|] - D/2 ln 2pi
                   - 1/2 E[(x_j - mu_k)^T L_k (x_j - mu_k)],  (..., T, K)."""
    D = x.shape[-1]
    e_logpi = expfam.dirichlet_expected_log(q.alpha)
    e_logdet = expfam.wishart_expected_logdet(q.W, q.nu)
    diff = x[..., :, None, :] - q.m[..., None, :, :]             # (.,T,K,D)
    maha = torch.einsum("...tki,...kil,...tkl->...tk", diff, q.W, diff)
    e_quad = D / q.beta[..., None, :] + q.nu[..., None, :] * maha
    return (e_logpi[..., None, :] + 0.5 * e_logdet[..., None, :]
            - 0.5 * D * _LOG_2PI - 0.5 * e_quad)


def responsibilities(x: torch.Tensor, q: GMMPosterior,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """r_jk (Bishop 10.46 / Appendix A), shape (..., T, K)."""
    r = torch.softmax(_log_rho(x, q), dim=-1)
    if mask is not None:
        r = r * mask[..., None]
    return r


def estep_terms(q: GMMPosterior, dtype=None, shift=None):
    """Per-component terms consumed by the fused VBE kernel:

      log_prior (..., K)      = E[ln pi] + 1/2 E[ln|L|] - D/2 ln 2pi
      Wn (..., K, D, D)       = nu W          (E[Lambda])
      b  (..., K, D)          = nu W m        (E[Lambda mu])
      c  (..., K)             = D/beta + nu m^T W m

    so that ln rho_jk = log_prior_k - (x^T Wn x - 2 x^T b + c) / 2.  With a
    per-component `shift` s (..., K, D), m is replaced by m - s: the terms
    of the same ln rho in the coordinates y = x - s_k (for s = m: b = 0,
    c = D/beta).
    """
    D = q.D
    log_prior = (expfam.dirichlet_expected_log(q.alpha)
                 + 0.5 * expfam.wishart_expected_logdet(q.W, q.nu)
                 - 0.5 * D * _LOG_2PI)
    Wn = q.nu[..., None, None] * q.W
    m = q.m if shift is None else q.m - shift
    b = (Wn @ m[..., None])[..., 0]
    c = D / q.beta + (m * b).sum(-1)
    if dtype is not None:
        log_prior, Wn, b, c = (a.to(dtype) for a in (log_prior, Wn, b, c))
    return log_prior, Wn, b, c


def sufficient_stats(x: torch.Tensor, r: torch.Tensor,
                     replication: float) -> SuffStats:
    """Replicated stats (Appendix A).  The data-axis sums go through
    `expfam.ordered_sum`, so trailing mask-zero padding leaves them
    bit-identical."""
    R = replication * expfam.ordered_sum(r, dim=-2)
    rx = r[..., :, :, None] * x[..., :, None, :]                 # (.,T,K,D)
    sum_x = replication * expfam.ordered_sum(rx, dim=-3)
    sum_xx = replication * expfam.ordered_sum(
        rx[..., None] * x[..., :, None, None, :], dim=-4)        # (.,K,D,D)
    return SuffStats(R=R, sum_x=sum_x, sum_xx=sum_xx)


def posterior_from_stats(stats: SuffStats, prior: GMMPosterior,
                         eps: float = 1e-12, shift=None) -> GMMPosterior:
    """Hyperparameter updates of Appendix A given (replicated) stats.

    With a per-component `shift` s, the stats are centred on it
    (sum r (x - s_k), sum r (x - s_k)(x - s_k)^T, as the fused kernel
    returns them): the scatter R*S is translation invariant, so it is
    formed from the centred stats without the sum_xx - R xbar xbar^T
    cancellation that costs f32 statistics most of their digits when the
    data sit far from the origin.
    """
    R = stats.R
    alpha = prior.alpha + R
    beta = prior.beta + R
    nu = prior.nu + R
    xbar = stats.sum_x / (R[..., None] + eps)
    sum_x = stats.sum_x if shift is None \
        else stats.sum_x + R[..., None] * shift
    m = (prior.beta[..., None] * prior.m + sum_x) / beta[..., None]
    # R*S = sum_xx - R xbar xbar^T ;  prior cross term beta0 R/(beta0+R)(..)
    RS = stats.sum_xx - R[..., None, None] * (
        xbar[..., :, None] * xbar[..., None, :])
    diff = xbar - prior.m if shift is None else xbar + shift - prior.m
    cross = (prior.beta * R / (prior.beta + R))[..., None, None] * (
        diff[..., :, None] * diff[..., None, :])
    W_inv = expfam._inv(prior.W) + RS + cross
    W_inv = 0.5 * (W_inv + W_inv.transpose(-1, -2))
    return GMMPosterior(alpha=alpha, m=m, beta=beta, W=expfam._inv(W_inv),
                        nu=nu)


def local_vbm_optimum(x: torch.Tensor, q_global: GMMPosterior,
                      prior: GMMPosterior, replication: float,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """One VBE step + local VBM optimum -> phi*_{theta,i} (Eqs. 17a, 18),
    as the flat natural-parameter message of Eq. 45."""
    r = responsibilities(x, q_global, mask)
    stats = sufficient_stats(x, r, replication)
    return expfam.pack_natural(posterior_from_stats(stats, prior))


def local_vbm_optimum_nodes(x: torch.Tensor, phi: torch.Tensor,
                            prior: GMMPosterior, replication: float,
                            K: int, D: int,
                            mask: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """x (N, Ni, D), phi (N, P) -> (N, P) local optima, node axis batched."""
    if mask is None:
        mask = x.new_ones(x.shape[:2])
    return local_vbm_optimum(x, expfam.unpack_natural(phi, K, D), prior,
                             replication, mask)


def elbo(x: torch.Tensor, q: GMMPosterior, prior: GMMPosterior,
         replication: float = 1.0) -> torch.Tensor:
    """Local variational lower bound L_i (Eq. 15) up to y-entropy terms;
    for monitoring and tests, not used inside the algorithms."""
    log_rho = _log_rho(x, q)
    r = torch.softmax(log_rho, dim=-1)
    e_loglik = replication * (r * log_rho).sum((-1, -2))
    ent_y = -replication * (r * torch.log(r + 1e-30)).sum((-1, -2))
    return e_loglik + ent_y - expfam.gmm_kl(q, prior)


def ground_truth_posterior(x_all: torch.Tensor, labels: torch.Tensor,
                           prior: GMMPosterior, K: int) -> GMMPosterior:
    """Closed-form conjugate posterior given the TRUE component labels
    (Sec. V-A) — the reference of Eq. 46."""
    r = torch.nn.functional.one_hot(labels.long(), K).to(x_all.dtype)
    return posterior_from_stats(sufficient_stats(x_all, r, 1.0), prior)


def predict_labels(x: torch.Tensor, q: GMMPosterior) -> torch.Tensor:
    """Hard cluster assignment under the variational posterior."""
    return responsibilities(x, q).argmax(-1)
