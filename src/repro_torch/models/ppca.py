"""PPCAModel: Bayesian probabilistic PCA / factor analysis over the block
layer.

Port of `repro.models.ppca`.  Each sensor observes T iid D-dimensional
points from a shared Q-dimensional latent subspace,

    z_j ~ N(0, I_Q),   x_jd | z_j ~ N(w_d^T z_j, lambda_d^{-1}),

with a per-row Normal-Gamma prior on (w_d, lambda_d).  The posterior over
the loading matrix is a bank of D Normal-Gamma rows,
`blocks.NormalGammaBlock(Q, rows=D)`: Bayesian linear regression with the
latent factors as the (inferred) design matrix.

VBE step (per node): Sigma_z = (I_Q + sum_d E[lambda_d w_d w_d^T])^{-1},
mu_j = Sigma_z sum_d E[lambda_d w_d] x_jd.  VBM optimum (per row d): the
linear-regression update with the replicated latent statistics
Szz = sum_j w_j (Sigma_z + mu_j mu_j^T), Szx_d = sum_j w_j mu_j x_jd,
Sxx_d = sum_j w_j x_jd^2, n = sum_j w_j — every row of every node in one
batched `torch.linalg.solve`.  The sample-axis reductions go through
`expfam.ordered_sum`.  `sample_sensors` is numpy-seeded: its arrays equal
the reference's.

Data convention: `(x (N, T, D), mask (N, T))`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import blocks, expfam, linreg
from repro_torch.core.linreg import NGPosterior


def prior(D: int, Q: int, *, a0: float = 1.0, b0: float = 1.0,
          v0: float = 1e-2, dtype=torch.float64,
          device="cpu") -> NGPosterior:
    """Row-stacked broad Normal-Gamma prior over the (D, Q) loading
    matrix: m (D, Q), V (D, Q, Q), a and b (D,)."""
    one = linreg.prior(Q, a0=a0, b0=b0, v0=v0, dtype=dtype, device=device)
    return NGPosterior(m=one.m.expand(D, Q).clone(),
                       V=one.V.expand(D, Q, Q).clone(),
                       a=one.a.expand(D).clone(), b=one.b.expand(D).clone())


def latent_posterior(x: torch.Tensor, q: NGPosterior):
    """VBE step, batched over leading axes: x (..., T, D) points and the
    rows posterior (fields (..., D, ...)) -> (Sigma_z (..., Q, Q),
    mu (..., T, Q)) of the per-point latent factors."""
    Q = q.m.shape[-1]
    e_lam = q.a / q.b                                             # (..., D)
    e_lww = torch.linalg.inv(q.V) + e_lam[..., None, None] * (
        q.m[..., :, None] * q.m[..., None, :])                    # (.,D,Q,Q)
    sigma_inv = (torch.eye(Q, dtype=x.dtype, device=x.device)
                 + e_lww.sum(-3))
    sigma = torch.linalg.inv(sigma_inv)                           # (.,Q,Q)
    A = e_lam[..., None] * q.m                                    # (.,D,Q)
    mu = (x @ A) @ sigma.transpose(-1, -2)                        # (.,T,Q)
    return sigma, mu


class PPCAModel(blocks.BlockModel):
    """Bank-of-Normal-Gamma-rows factor analysis (Bayesian PPCA).
    `device` (None = CUDA) is where the prior, and so the run, lives; the
    local optimum runs on the reference path only (`backend="fused"`
    falls back)."""

    def __init__(self, prior: NGPosterior, D: int | None = None,
                 Q: int | None = None, *, device=None):
        self.device = device_lib.resolve(device)
        self.prior = prior.to(self.device)
        self.D = D if D is not None else prior.m.shape[0]
        self.Q = Q if Q is not None else prior.m.shape[-1]
        self.blocks = (blocks.NormalGammaBlock(self.Q, rows=self.D),)

    def split_hyper(self, q: NGPosterior) -> tuple:
        return (q,)

    def join_hyper(self, parts: tuple) -> NGPosterior:
        return parts[0]

    def local_optimum(self, data, phi_nodes, replication):
        """(x (N, T, D), w (N, T) scaled mask), (N, P) iterates -> (N, P)
        local optima."""
        x, w = data
        sigma, mu = latent_posterior(x, self.unpack(phi_nodes))
        wx = x * w[..., None]                                     # (N,T,D)
        muw = mu * w[..., None]                                   # (N,T,Q)
        n = expfam.ordered_sum(w[..., None], dim=1)[..., 0] * replication
        Szz = (expfam.ordered_sum(muw[..., :, None] * mu[..., None, :],
                                  dim=1) * replication
               + n[:, None, None] * sigma)                        # (N,Q,Q)
        Szx = expfam.ordered_sum(wx[..., :, None] * mu[..., None, :],
                                 dim=1) * replication             # (N,D,Q)
        Sxx = expfam.ordered_sum(wx * x, dim=1) * replication     # (N, D)

        # every (node, row) of the Normal-Gamma update at once
        p0 = self.prior
        V = p0.V + Szz[:, None]                                   # (N,D,Q,Q)
        rhs = (p0.V @ p0.m[..., None])[..., 0] + Szx              # (N,D,Q)
        m = torch.linalg.solve(V, rhs[..., None])[..., 0]
        a = p0.a + n[:, None] / 2.0
        b = p0.b + 0.5 * (Sxx + linreg._quad(p0.m, p0.V)
                          - linreg._quad(m, V))
        return self.pack(NGPosterior(m=m, V=V, a=a.expand_as(b), b=b))


def perturbed_init(prior: NGPosterior, noise=None, *, scale: float = 0.1,
                   generator: torch.Generator | None = None
                   ) -> NGPosterior:
    """Random-restart initialisation: the loading-row means jittered by
    `scale` x (D, Q) standard normal draws (the reference's
    `jax.random.normal` draws, for parity; None: drawn from `generator`
    on the CPU).  The zero-mean prior is a fixed point of the iteration,
    so runs start off it."""
    if noise is None:
        noise = torch.randn(prior.m.shape, generator=generator,
                            dtype=prior.m.dtype)
    if not isinstance(noise, torch.Tensor):
        noise = torch.from_numpy(np.array(noise))
    noise = noise.to(prior.m)
    return prior._replace(m=prior.m + scale * noise)


# ---------------------------------------------------------------------------
# Synthetic sensor subspace data (examples + tests)
# ---------------------------------------------------------------------------
def sample_sensors(n_nodes: int, n_per_node: int, *, D: int = 6, Q: int = 2,
                   seed: int = 0, noise: float = 0.1, dtype=np.float64):
    """Ground-truth PPCA data (the reference's numpy draws): one shared
    (D, Q) loading matrix, iid latent factors per point, per-dimension
    noise 1/lambda = noise^2.  Returns CPU tensors (x (N, T, D),
    mask (N, T), W_true (D, Q))."""
    rng = np.random.default_rng(seed)
    W_true = rng.normal(size=(D, Q)) / np.sqrt(Q)
    z = rng.normal(size=(n_nodes, n_per_node, Q))
    x = z @ W_true.T + noise * rng.normal(size=(n_nodes, n_per_node, D))
    return tuple(torch.from_numpy(a) for a in (
        x.astype(dtype), np.ones((n_nodes, n_per_node), dtype),
        W_true.astype(dtype)))
