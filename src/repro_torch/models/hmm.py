"""HMMModel: conjugate hidden Markov chains over the block layer.

Port of `repro.models.hmm`.  Each sensor observes S iid chains of length L:

    z_1 ~ Cat(pi),  z_{l+1} | z_l ~ Cat(A[z_l]),  x_l | z_l ~ N(mu_k, L_k^-1)

with pi ~ Dir, A[k] ~ Dir per row and (mu_k, L_k) ~ Normal-Wishart.  The
posterior is three exponential-family blocks, so the adapter is a
`blocks.BlockModel`:

    DirichletBlock(K, rows=1, "pi")     initial-state weights
    DirichletBlock(K, rows=K, "trans")  one Dirichlet per transition row
    NormalWishartBlock(K, D)            the GMM emission bank

The VBE step is Beal's variational forward-backward in log space over the
sub-normalised parameters exp E[ln pi], exp E[ln A], exp E[ln emission];
the VBM optimum adds the replicated expected counts to the prior
(Eqs. 17a/18).  Where the reference scans one chain (`lax.scan`, vmapped
over chains and nodes), `forward_backward` loops over the chain length L
in Python with (nodes, chains) as batch axes: on the card that is about
2L small launches per step of the recursion each iteration (PERF.md
counts them).

Data convention: `(x (N, S, L, D), mask (N, S))` — the chain is the
sample unit, so streaming minibatches subsample chains, and the
chain-axis reductions go through `expfam.ordered_sum` (mask-zero chains
add exact zeros).  `sample_chains` is numpy-seeded: its arrays equal the
reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import blocks, expfam, gmm
from repro_torch.core.expfam import GMMPosterior, NWParams


class HMMPosterior(NamedTuple):
    """Hyperparameters of the three-block HMM posterior (leading batch
    axes allowed on every field)."""

    pi: torch.Tensor     # (..., K)     Dirichlet over the initial state
    trans: torch.Tensor  # (..., K, K)  one Dirichlet per transition row
    m: torch.Tensor      # (..., K, D)  Normal-Wishart emission bank
    beta: torch.Tensor   # (..., K)
    W: torch.Tensor      # (..., K, D, D)
    nu: torch.Tensor     # (..., K)

    @property
    def K(self) -> int:
        return self.pi.shape[-1]

    @property
    def D(self) -> int:
        return self.m.shape[-1]

    def to(self, *args, **kwargs) -> "HMMPosterior":
        return HMMPosterior(*(a.to(*args, **kwargs) for a in self))


def noninformative_prior(K: int, D: int, *, alpha0: float = 1.0,
                         trans0: float = 1.0, beta0: float = 1.0,
                         nu0: float | None = None, w0_scale: float = 1.0,
                         dtype=torch.float64, device="cpu") -> HMMPosterior:
    """Broad conjugate prior: uniform Dirichlets + the GMM emission prior."""
    g = expfam.noninformative_prior(K, D, alpha0=alpha0, beta0=beta0,
                                    nu0=nu0, w0_scale=w0_scale, dtype=dtype,
                                    device=device)
    return HMMPosterior(pi=g.alpha,
                        trans=torch.full((K, K), trans0, dtype=dtype,
                                         device=device),
                        m=g.m, beta=g.beta, W=g.W, nu=g.nu)


def _emission_loglik(x: torch.Tensor, nw: NWParams) -> torch.Tensor:
    """x (..., L, D) chains -> (..., L, K) expected emission log-densities
    E[ln N(x_l | mu_k, L_k^-1)]; the fields of `nw` carry the same
    leading axes as x (or broadcast to them)."""
    D = x.shape[-1]
    e_logdet = expfam.wishart_expected_logdet(nw.W, nw.nu)       # (..., K)
    diff = x[..., :, None, :] - nw.m[..., None, :, :]            # (.,L,K,D)
    maha = torch.einsum("...lki,...kij,...lkj->...lk", diff, nw.W, diff)
    e_quad = D / nw.beta[..., None, :] + nw.nu[..., None, :] * maha
    return (0.5 * e_logdet[..., None, :]
            - 0.5 * D * math.log(2.0 * math.pi) - 0.5 * e_quad)


def forward_backward(log_emit: torch.Tensor, log_pi: torch.Tensor,
                     log_A: torch.Tensor):
    """Variational forward-backward in log space, batched over leading
    axes: log_emit (..., L, K), log_pi (..., K) = E[ln pi], log_A
    (..., K, K) = E[ln A].  Returns (gamma (..., L, K) state marginals,
    xi (..., L-1, K, K) pairwise marginals), both normalised.  The
    recursions loop over L."""
    L = log_emit.shape[-2]
    la = log_pi + log_emit[..., 0, :]
    alphas = [la]
    for l in range(1, L):
        la = (torch.logsumexp(la[..., :, None] + log_A, dim=-2)
              + log_emit[..., l, :])
        alphas.append(la)
    log_alpha = torch.stack(alphas, dim=-2)                      # (.,L,K)
    lb = torch.zeros_like(log_pi + log_emit[..., 0, :])
    betas = [lb]
    for l in range(L - 1, 0, -1):
        lb = torch.logsumexp(log_A + (log_emit[..., l, :] + lb)[..., None, :],
                             dim=-1)
        betas.append(lb)
    log_beta = torch.stack(betas[::-1], dim=-2)                  # (.,L,K)
    gamma = torch.softmax(log_alpha + log_beta, dim=-1)
    lx = (log_alpha[..., :-1, :, None] + log_A[..., None, :, :]
          + (log_emit[..., 1:, :] + log_beta[..., 1:, :])[..., None, :])
    K = log_emit.shape[-1]
    xi = torch.softmax(lx.flatten(-2), dim=-1).unflatten(-1, (K, K))
    return gamma, xi


class HMMModel(blocks.BlockModel):
    """Dirichlet(pi) x Dirichlet-rows(A) x Normal-Wishart emission HMM.
    `device` (None = CUDA) is where the prior, and so the run, lives; the
    local optimum runs on the reference path only (`FusedBackend`'s
    kernel is the GMM E-step: `backend="fused"` falls back)."""

    def __init__(self, prior: HMMPosterior, K: int | None = None,
                 D: int | None = None, *, device=None):
        self.device = device_lib.resolve(device)
        self.prior = prior.to(self.device)
        self.K = K if K is not None else prior.K
        self.D = D if D is not None else prior.D
        self.blocks = (blocks.DirichletBlock(self.K, name="pi"),
                       blocks.DirichletBlock(self.K, rows=self.K,
                                             name="trans"),
                       blocks.NormalWishartBlock(self.K, self.D))

    def split_hyper(self, q: HMMPosterior) -> tuple:
        return (q.pi[..., None, :], q.trans,
                NWParams(m=q.m, beta=q.beta, W=q.W, nu=q.nu))

    def join_hyper(self, parts: tuple) -> HMMPosterior:
        pi, trans, nw = parts
        return HMMPosterior(pi=pi[..., 0, :], trans=trans, m=nw.m,
                            beta=nw.beta, W=nw.W, nu=nw.nu)

    def local_optimum(self, data, phi_nodes, replication):
        """(x (N, S, L, D), w (N, S) scaled mask), (N, P) iterates ->
        (N, P) local optima."""
        x, w = data
        N, S, L, D = x.shape
        K = self.K
        q = self.unpack(phi_nodes)
        log_pi = expfam.dirichlet_expected_log(q.pi)              # (N, K)
        log_A = expfam.dirichlet_expected_log(q.trans)            # (N, K, K)
        nw = NWParams(m=q.m[:, None], beta=q.beta[:, None],
                      W=q.W[:, None], nu=q.nu[:, None])
        gamma, xi = forward_backward(_emission_loglik(x, nw),
                                     log_pi[:, None], log_A[:, None])

        # expected counts, replicated; the chain axis is the sample axis
        pi_counts = replication * expfam.ordered_sum(
            w[..., None] * gamma[:, :, 0, :], dim=1)              # (N, K)
        trans_counts = replication * expfam.ordered_sum(
            w[..., None, None] * xi.sum(2), dim=1)                # (N, K, K)
        # emissions: the gamma-weighted chains flattened to one sample
        # axis (padded chains stay at the tail), the GMM statistics and
        # Appendix-A update
        r = (w[..., None, None] * gamma).reshape(N, S * L, K)
        stats = gmm.sufficient_stats(x.reshape(N, S * L, D), r, replication)
        p = self.prior
        emis = gmm.posterior_from_stats(
            stats, GMMPosterior(alpha=p.pi, m=p.m, beta=p.beta, W=p.W,
                                nu=p.nu))
        return self.pack(HMMPosterior(
            pi=p.pi + pi_counts, trans=p.trans + trans_counts, m=emis.m,
            beta=emis.beta, W=emis.W, nu=emis.nu))


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


def perturbed_init(prior: HMMPosterior, x, u=None, *, spread: float = 1.0,
                   generator: torch.Generator | None = None
                   ) -> HMMPosterior:
    """Random-restart initialisation: the prior with the emission means
    scattered over the data range, m = lo + (hi - lo) u for (K, D)
    uniform draws u (the reference's `jax.random.uniform` draws, for
    parity; None: drawn from `generator` on the CPU).  The prior's
    exchangeable components are a fixed point of the iteration, so runs
    start off it."""
    K, D = prior.K, prior.D
    xf = _tensor(x).reshape(-1, D).to(prior.m.device)
    lo, hi = xf.amin(0), xf.amax(0)
    if u is None:
        u = torch.rand((K, D), generator=generator, dtype=prior.m.dtype)
    u = _tensor(u).to(prior.m)
    m = lo + (hi - lo) * u
    return prior._replace(m=prior.m + spread * (m - prior.m))


# ---------------------------------------------------------------------------
# Synthetic sensor chains (examples + tests)
# ---------------------------------------------------------------------------
def sample_chains(n_nodes: int, n_chains: int, length: int, *,
                  K: int = 3, D: int = 2, seed: int = 0,
                  self_loop: float = 0.8, sep: float = 4.0,
                  dtype=np.float64):
    """Ground-truth HMM chains per sensor: sticky uniform-offdiagonal
    transitions, well-separated spherical Gaussian emissions; the same
    numpy draws, in the same order, as the reference.  Returns CPU
    tensors (x (N, S, L, D), mask (N, S), pi_true, A_true, means)."""
    rng = np.random.default_rng(seed)
    pi = np.full(K, 1.0 / K)
    A = np.full((K, K), (1.0 - self_loop) / (K - 1))
    np.fill_diagonal(A, self_loop)
    ang = 2.0 * np.pi * np.arange(K) / K
    means = np.zeros((K, D))
    circ = sep * np.stack([np.cos(ang), np.sin(ang)], -1)
    means[:, :min(D, 2)] = circ[:, :min(D, 2)]
    x = np.zeros((n_nodes, n_chains, length, D), dtype)
    for i in range(n_nodes):
        for s in range(n_chains):
            z = rng.choice(K, p=pi)
            for l in range(length):
                x[i, s, l] = means[z] + rng.normal(size=D)
                z = rng.choice(K, p=A[z])
    mask = np.ones((n_nodes, n_chains), dtype)
    return tuple(torch.from_numpy(a) for a in (x, mask, pi, A, means))
