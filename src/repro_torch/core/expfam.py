"""Exponential-family machinery of the conjugate-exponential VB framework.

Port of `repro.core.expfam`: the natural-parameter space of the Bayesian
GMM's global posterior, Dir(alpha) x prod_k NW(m, beta, W, nu), with the
flat packing exchanged between nodes (Eq. 45), the domain projection
(Eq. 38b), the log partitions and the KL metric (Eq. 46).

Layout of the flat natural-parameter vector for K components in D dims::

    [ alpha-1 (K) | per-component blocks (K * (2 + D + D*D)) ]
    block_k = [ n1, n4, n3 (D), vec(n2) (D*D) ]
      n1 = (nu - D) / 2
      n2 = -1/2 W^{-1} - beta/2 m m^T
      n3 = beta m
      n4 = -beta / 2

Where the JAX module is written for one posterior and vmapped, every
function here takes arbitrary LEADING batch dimensions (a node axis, a
reference-permutation axis, ...) written out: hyperparameter fields are
(..., K), (..., K, D), (..., K, D, D); flat vectors are (..., P).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse without the host sync `torch.linalg.inv` spends on
    its singularity check (a singular W shows up as inf/nan downstream,
    as it does in the reference)."""
    return torch.linalg.inv_ex(a).inverse


def _logdet(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.slogdet(a).logabsdet


def multigammaln(a: torch.Tensor, d: int) -> torch.Tensor:
    """log Gamma_d(a), elementwise.  `torch.special.multigammaln` checks
    its domain on the host (a device sync per call) and raises; this
    returns nan outside the domain, as the reference does."""
    j = torch.arange(d, dtype=a.dtype, device=a.device)
    return (torch.lgamma(a[..., None] - 0.5 * j).sum(-1)
            + 0.25 * d * (d - 1) * math.log(math.pi))


def ordered_sum(a: torch.Tensor, chunk: int = 32, dim: int = 0
                ) -> torch.Tensor:
    """Sum over axis `dim`, BIT-invariant to appended zero rows.

    The axis is padded to a multiple of `chunk` (a power of two), each
    fixed-shape chunk is summed by repeated halving (a fixed pairwise
    tree of elementwise adds), and the chunk sums are folded by a
    sequential loop.  Appending zero rows only appends all-zero chunks,
    and `acc + 0.0` is exact, so the result does not change.

    >>> a = torch.linspace(0.0, 1.0, 7)[:, None]
    >>> b = torch.cat([a, torch.zeros(90, 1)])
    >>> bool(torch.equal(ordered_sum(a), ordered_sum(b)))
    True
    """
    if chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two: {chunk}")
    a = a.movedim(dim, 0)
    T = a.shape[0]
    Tp = max(chunk, -(-T // chunk) * chunk)
    if Tp != T:
        a = torch.cat([a, a.new_zeros((Tp - T,) + a.shape[1:])])
    s = a.reshape((Tp // chunk, chunk) + a.shape[1:])
    n = chunk
    while n > 1:
        n //= 2
        s = s[:, :n] + s[:, n:2 * n]
    acc = a.new_zeros(a.shape[1:])
    for blk in s[:, 0]:
        acc = acc + blk
    return acc


# ---------------------------------------------------------------------------
# Hyperparameter containers
# ---------------------------------------------------------------------------
class GMMPosterior(NamedTuple):
    """Hyperparameters of Dir(alpha) x prod_k NW(m, beta, W, nu)."""

    alpha: torch.Tensor  # (..., K)
    m: torch.Tensor      # (..., K, D)
    beta: torch.Tensor   # (..., K)
    W: torch.Tensor      # (..., K, D, D)  Wishart scale matrix
    nu: torch.Tensor     # (..., K)        Wishart dof

    @property
    def K(self) -> int:
        return self.alpha.shape[-1]

    @property
    def D(self) -> int:
        return self.m.shape[-1]

    def to(self, *args, **kwargs) -> "GMMPosterior":
        return GMMPosterior(*(a.to(*args, **kwargs) for a in self))


class NWParams(NamedTuple):
    """A bank of K Normal-Wishart factors (the GMM posterior minus its
    Dirichlet part).  Every nw_* function reads only (m, beta, W, nu), so
    it accepts an `NWParams` or a `GMMPosterior`."""

    m: torch.Tensor      # (..., K, D)
    beta: torch.Tensor   # (..., K)
    W: torch.Tensor      # (..., K, D, D)
    nu: torch.Tensor     # (..., K)

    @property
    def K(self) -> int:
        return self.beta.shape[-1]

    @property
    def D(self) -> int:
        return self.m.shape[-1]


def noninformative_prior(K: int, D: int, *, alpha0: float = 1.0,
                         beta0: float = 1.0, nu0: float | None = None,
                         w0_scale: float = 1.0, m0=None,
                         dtype=torch.float64, device=None) -> GMMPosterior:
    """Broad conjugate prior (paper Sec. V: 'non-informative priors')."""
    if nu0 is None:
        nu0 = float(D)
    kw = dict(dtype=dtype, device=device)
    m0 = (torch.zeros(D, **kw) if m0 is None
          else torch.as_tensor(m0).to(**kw))
    return GMMPosterior(
        alpha=torch.full((K,), alpha0, **kw),
        m=m0.expand(K, D).clone(),
        beta=torch.full((K,), beta0, **kw),
        W=(torch.eye(D, **kw) * w0_scale).expand(K, D, D).clone(),
        nu=torch.full((K,), nu0, **kw),
    )


# ---------------------------------------------------------------------------
# Natural parameters <-> hyperparameters  (Eq. 45 + Appendix B)
# ---------------------------------------------------------------------------
def flat_dim(K: int, D: int) -> int:
    return K + K * (2 + D + D * D)


#: names of the natural-parameter blocks of the flat GMM message, in the
#: order of the `block_labels` ids.
BLOCK_NAMES = ("alpha", "nu", "beta", "mean", "winv")


def block_labels(K: int, D: int) -> np.ndarray:
    """(P,) int32 block-type label per coordinate of the flat message
    (indexes `BLOCK_NAMES`); static packing structure, so host numpy."""
    per = [1, 2] + [3] * D + [4] * (D * D)
    return np.asarray([0] * K + per * K, np.int32)


def _outer(m: torch.Tensor) -> torch.Tensor:
    return m[..., :, None] * m[..., None, :]


def _nw_blocks(n1, n4, n3, n2) -> torch.Tensor:
    K, D = n3.shape[-2], n3.shape[-1]
    blocks = torch.cat([n1[..., None], n4[..., None], n3,
                        n2.reshape(n2.shape[:-2] + (D * D,))], dim=-1)
    return blocks.reshape(blocks.shape[:-2] + (K * (2 + D + D * D),))


def nw_pack(q) -> torch.Tensor:
    """Normal-Wishart bank -> its flat natural-parameter segment."""
    D = q.m.shape[-1]
    n1 = (q.nu - D) / 2.0
    n4 = -q.beta / 2.0
    n3 = q.beta[..., None] * q.m
    n2 = -0.5 * _inv(q.W) - 0.5 * q.beta[..., None, None] * _outer(q.m)
    return _nw_blocks(n1, n4, n3, n2)


def _split_nw(seg: torch.Tensor, K: int, D: int):
    blocks = seg.reshape(seg.shape[:-1] + (K, 2 + D + D * D))
    n1 = blocks[..., 0]
    n4 = blocks[..., 1]
    n3 = blocks[..., 2:2 + D]
    n2 = blocks[..., 2 + D:].reshape(blocks.shape[:-1] + (D, D))
    return n1, n4, n3, n2


def nw_unpack(seg: torch.Tensor, K: int, D: int) -> NWParams:
    """Flat Normal-Wishart segment -> NWParams (inverse of `nw_pack`)."""
    n1, n4, n3, n2 = _split_nw(seg, K, D)
    beta = -2.0 * n4
    m = n3 / beta[..., None]
    nu = 2.0 * n1 + D
    W_inv = -2.0 * n2 - beta[..., None, None] * _outer(m)
    return NWParams(m=m, beta=beta, W=_inv(W_inv), nu=nu)


def pack_natural(q: GMMPosterior) -> torch.Tensor:
    """GMMPosterior -> flat natural-parameter message (Eq. 45)."""
    return torch.cat([q.alpha - 1.0, nw_pack(q)], dim=-1)


def unpack_natural(phi: torch.Tensor, K: int, D: int) -> GMMPosterior:
    """Flat natural-parameter message -> GMMPosterior (inverse of pack)."""
    nw = nw_unpack(phi[..., K:], K, D)
    return GMMPosterior(alpha=phi[..., :K] + 1.0, m=nw.m, beta=nw.beta,
                        W=nw.W, nu=nw.nu)


#: the largest batch handed to one `torch.linalg.eigh` call: the
#: batched cuSOLVER path (cusolverDnXsyevBatched, torch 2.11 with CUDA
#: 12.8 on an H100) rejects batches of 32,766 matrices and more with
#: CUSOLVER_STATUS_INVALID_VALUE in its workspace query (30,000 pass;
#: tools/eigh_batch_probe.py); the Normal-Wishart projection at 100,000
#: sensors x K=3 is 300,000.  Its workspace grows with the batch, ~537 KB
#: a 2x2 matrix: a chunk holds 8.8 GB while it runs, half the chunk half
#: that, and 300,000 matrices take 4.9 ms in chunks of 16,384, 6.3 ms in
#: chunks of 8,192 (the same probe, an H100)
EIGH_MAX_BATCH = 1 << 14


def _eigh(a: torch.Tensor):
    """`torch.linalg.eigh` over the leading batch, in chunks of at most
    EIGH_MAX_BATCH matrices (a card's batched eigh rejects larger batches;
    each matrix is solved on its own, so the chunks change no result)."""
    flat = a.reshape(-1, *a.shape[-2:])
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_MAX_BATCH)]
    return (torch.cat([p[0] for p in parts]).reshape(a.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(a.shape))


def nw_project(seg: torch.Tensor, K: int, D: int, *,
               min_beta: float = 1e-6, min_eig: float = 1e-8
               ) -> torch.Tensor:
    """Projection of a flat Normal-Wishart segment onto its domain: clamps
    beta and nu and projects the W^{-1} carrier onto the PSD cone by
    eigenvalue clipping (the closest point in Frobenius norm)."""
    n1, n4, n3, n2 = _split_nw(seg, K, D)
    n4 = torch.clamp(n4, max=-min_beta / 2.0)            # beta >= min_beta
    beta = -2.0 * n4
    m = n3 / beta[..., None]
    nu = torch.clamp(2.0 * n1 + D, min=(D - 1.0) + 1e-3)
    n1 = (nu - D) / 2.0
    mmT = _outer(m)
    W_inv = -2.0 * n2 - beta[..., None, None] * mmT
    W_inv = 0.5 * (W_inv + W_inv.transpose(-1, -2))
    eigval, eigvec = _eigh(W_inv)
    # relative floor: eigh's reconstruction error scales with ||W^-1||
    floor = torch.clamp(1e-10 * eigval.abs().amax(-1, keepdim=True),
                        min=min_eig)
    eigval = torch.maximum(eigval, floor)
    W_inv = (eigvec * eigval[..., None, :]) @ eigvec.transpose(-1, -2)
    n2 = -0.5 * W_inv - 0.5 * beta[..., None, None] * mmT
    return _nw_blocks(n1, n4, n3, n2)


def project_to_domain(phi: torch.Tensor, K: int, D: int, *,
                      min_alpha: float = 1e-3, min_beta: float = 1e-6,
                      min_eig: float = 1e-8) -> torch.Tensor:
    """Euclidean projection onto (the interior of) the domain Omega
    (Eq. 38b): alpha_k > 0, beta_k > 0, nu_k > D - 1, W^{-1} > 0.  The
    Dirichlet and Normal-Wishart segments project independently."""
    alpha = torch.clamp(phi[..., :K] + 1.0, min=min_alpha)
    return torch.cat([alpha - 1.0,
                      nw_project(phi[..., K:], K, D, min_beta=min_beta,
                                 min_eig=min_eig)], dim=-1)


def in_domain(phi: torch.Tensor, K: int, D: int) -> torch.Tensor:
    """Boolean (per leading index): does phi lie in Omega (Eq. 8)?"""
    q = unpack_natural(phi, K, D)
    n1, n4, n3, n2 = _split_nw(phi[..., K:], K, D)
    beta = -2.0 * n4
    m = n3 / beta[..., None]
    W_inv = -2.0 * n2 - beta[..., None, None] * _outer(m)
    eigs = torch.linalg.eigvalsh(0.5 * (W_inv + W_inv.transpose(-1, -2)))
    return ((q.alpha > 0).all(-1) & (q.beta > 0).all(-1)
            & (q.nu > D - 1).all(-1) & (eigs > 0).flatten(-2).all(-1))


# ---------------------------------------------------------------------------
# Log-partition functions A(phi) and expected sufficient statistics
# ---------------------------------------------------------------------------
def dirichlet_log_partition(alpha: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))


def dirichlet_expected_log(alpha: torch.Tensor) -> torch.Tensor:
    """E[ln pi_k] = psi(alpha_k) - psi(sum alpha)."""
    return (torch.special.digamma(alpha)
            - torch.special.digamma(alpha.sum(-1, keepdim=True)))


def wishart_expected_logdet(W: torch.Tensor, nu: torch.Tensor
                            ) -> torch.Tensor:
    """E[ln |Lambda|] for Lambda ~ W(W, nu)  (Appendix A)."""
    D = W.shape[-1]
    j = torch.arange(1, D + 1, dtype=W.dtype, device=W.device)
    return (torch.special.digamma((nu[..., None] + 1.0 - j) / 2.0).sum(-1)
            + D * math.log(2.0) + _logdet(W))


def nw_log_partition(q) -> torch.Tensor:
    """A(phi_k) for each Normal-Wishart component (Appendix B), (..., K)."""
    D = q.m.shape[-1]
    return (-D / 2.0 * torch.log(q.beta)
            + q.nu / 2.0 * _logdet(q.W)
            + q.nu * D / 2.0 * math.log(2.0)
            + multigammaln(q.nu / 2.0, D))


def nw_expected_stats(q):
    """E[u] = (E[ln|L|], E[L], E[L mu], E[mu^T L mu]) per component."""
    D = q.m.shape[-1]
    e_logdet = wishart_expected_logdet(q.W, q.nu)
    e_L = q.nu[..., None, None] * q.W
    e_Lmu = (e_L @ q.m[..., None])[..., 0]
    e_quad = D / q.beta + (q.m * e_Lmu).sum(-1)
    return e_logdet, e_L, e_Lmu, e_quad


def gmm_log_partition(q: GMMPosterior) -> torch.Tensor:
    """A(phi) of the joint Dir x prod NW global distribution."""
    return dirichlet_log_partition(q.alpha) + nw_log_partition(q).sum(-1)


def nw_expected_stats_flat(q) -> torch.Tensor:
    """E[u] of the Normal-Wishart bank laid out exactly like `nw_pack`:
    per-component [E ln|L|, E mu'L mu, E L mu, vec(E L)], flattened."""
    e_logdet, e_L, e_Lmu, e_quad = nw_expected_stats(q)
    return _nw_blocks(e_logdet, e_quad, e_Lmu, e_L)


def expected_sufficient_stats(q: GMMPosterior) -> torch.Tensor:
    """grad_phi A(phi) = E[u(z)] (Eq. 10a), laid out like the packing."""
    return torch.cat([dirichlet_expected_log(q.alpha),
                      nw_expected_stats_flat(q)], dim=-1)


# ---------------------------------------------------------------------------
# KL divergences (Appendix B) -- the paper's performance metric (Eq. 46)
# ---------------------------------------------------------------------------
def dirichlet_kl(alpha: torch.Tensor, alpha_hat: torch.Tensor
                 ) -> torch.Tensor:
    e_logpi = dirichlet_expected_log(alpha)
    return (((alpha - alpha_hat) * e_logpi).sum(-1)
            - dirichlet_log_partition(alpha)
            + dirichlet_log_partition(alpha_hat))


def _nw_natural(q):
    D = q.m.shape[-1]
    n1 = (q.nu - D) / 2.0
    n2 = -0.5 * _inv(q.W) - 0.5 * q.beta[..., None, None] * _outer(q.m)
    n3 = q.beta[..., None] * q.m
    n4 = -q.beta / 2.0
    return n1, n2, n3, n4


def nw_kl(q, p) -> torch.Tensor:
    """sum_k KL(NW(q_k) || NW(p_k)) via the exp-family identity
    KL = (phi_q - phi_p)^T E_q[u] - A(phi_q) + A(phi_p)."""
    q1, q2, q3, q4 = _nw_natural(q)
    p1, p2, p3, p4 = _nw_natural(p)
    e_logdet, e_L, e_Lmu, e_quad = nw_expected_stats(q)
    inner = ((q1 - p1) * e_logdet
             + ((q2 - p2) * e_L).sum((-1, -2))
             + ((q3 - p3) * e_Lmu).sum(-1)
             + (q4 - p4) * e_quad)
    return (inner - nw_log_partition(q) + nw_log_partition(p)).sum(-1)


def gmm_kl(q: GMMPosterior, p: GMMPosterior) -> torch.Tensor:
    """d(phi, phi_hat) of Eq. 46: KL(Q(theta|phi) || P(theta|phi_hat))."""
    return dirichlet_kl(q.alpha, p.alpha) + nw_kl(q, p)


def gmm_kl_flat(phi: torch.Tensor, phi_hat: torch.Tensor, K: int, D: int
                ) -> torch.Tensor:
    return gmm_kl(unpack_natural(phi, K, D), unpack_natural(phi_hat, K, D))
