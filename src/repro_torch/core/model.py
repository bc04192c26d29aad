"""Conjugate-exponential model adapters for the unified VB engine.

Port of `repro.core.model`: the GMM instance and the Normal-Gamma
linear-regression instance (`LinRegModel`).  Every algorithm touches a
model only through (a) the flat natural-parameter vector phi exchanged
between nodes (Eq. 45), (b) the per-node local VBM optimum phi*_i
(Eq. 18), (c) the projection onto the domain Omega (Eq. 38b) and (d) the
KL metric (Eq. 46).  `ConjugateExpModel` names that surface;
`engine.run_vb` is written against it.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import backends, blocks, linreg
from repro_torch.core.expfam import GMMPosterior, NWParams
from repro_torch.core.linreg import NGPosterior


@runtime_checkable
class ConjugateExpModel(Protocol):
    """What the engine needs from a conjugate-exponential model."""

    @property
    def flat_dim(self) -> int:
        """Length P of the flat natural-parameter message (Eq. 45)."""
        ...

    def pack(self, q) -> torch.Tensor:
        ...

    def unpack(self, phi: torch.Tensor):
        ...

    def init_phi(self) -> torch.Tensor:
        """Default (P,) starting point (the prior's natural parameters)."""
        ...

    def local_optimum(self, data: Any, phi_nodes: torch.Tensor,
                      replication: float) -> torch.Tensor:
        """Per-node VBE step + local VBM optimum phi*_i (Eqs. 17a, 18):
        (N, P) iterates -> (N, P) local optima."""
        ...

    def project_to_domain(self, phi: torch.Tensor) -> torch.Tensor:
        """Projection of (..., P) points onto Omega (Eq. 38b)."""
        ...

    def kl(self, phi: torch.Tensor, phi_ref: torch.Tensor) -> torch.Tensor:
        """d(phi, phi_ref) of Eq. 46, broadcast over leading axes."""
        ...

    def block_labels(self) -> np.ndarray:
        """(P,) int32 block-type label per flat coordinate."""
        ...

    def data_mask(self, data: Any) -> torch.Tensor:
        """(N, T) per-sample validity mask of the stacked node data."""
        ...


class GMMModel(blocks.BlockModel):
    """Dirichlet x Normal-Wishart mixture posterior in natural-param space.

    `backend` selects the hot path's implementation ("reference",
    "fused", or a `backends.Backend` instance).  `device` (None = CUDA)
    is where the prior, and so the run, lives.
    """

    #: capability tag consumed by `backends.Backend.supports`
    kernel_family = "gmm"

    def __init__(self, prior: GMMPosterior, K: int | None = None,
                 D: int | None = None, backend=None, *, device=None):
        self.device = device_lib.resolve(device)
        self.prior = prior.to(self.device)
        self.K = K if K is not None else prior.K
        self.D = D if D is not None else prior.D
        self.backend = backends.resolve(backend)
        self.blocks = (blocks.DirichletBlock(self.K),
                       blocks.NormalWishartBlock(self.K, self.D))

    def with_backend(self, backend) -> "GMMModel":
        """Same model, different compute backend."""
        return GMMModel(self.prior, self.K, self.D, backend=backend,
                        device=self.device)

    def split_hyper(self, q: GMMPosterior) -> tuple:
        return (q.alpha[..., None, :],
                NWParams(m=q.m, beta=q.beta, W=q.W, nu=q.nu))

    def join_hyper(self, parts: tuple) -> GMMPosterior:
        alpha, nw = parts
        return GMMPosterior(alpha=alpha[..., 0, :], m=nw.m, beta=nw.beta,
                            W=nw.W, nu=nw.nu)

    def stream_data(self, data):
        """(x, mask) as the backend's hot path reads them (the backend's
        `stream_data`; as given for a backend without one, such as the
        reference); `engine.vb_init` calls it once per session."""
        stream = getattr(self.backend, "stream_data", None)
        return tuple(data) if stream is None else stream(*data)

    def local_optimum(self, data, phi_nodes, replication):
        x, mask = data
        return self.backend.local_vbm_optimum_nodes(
            x, mask, phi_nodes, self.prior, replication, self.K, self.D)


# ---------------------------------------------------------------------------
# Bayesian linear regression (Normal-Gamma) — the generality instance
# ---------------------------------------------------------------------------
class LinRegModel(blocks.BlockModel):
    """y = w^T x + N(0, lambda^-1), lambda ~ Ga, w | lambda ~ N
    (conjugate).  `device` (None = CUDA) is where the prior, and so the
    run, lives.  Only the reference backend applies (`with_backend`): the
    local optimum is a closed form with no per-iteration data pass."""

    def __init__(self, prior: NGPosterior | None = None,
                 D: int | None = None, *, device=None):
        if prior is None and D is None:
            raise ValueError("LinRegModel needs a prior or a dimension D")
        self.device = device_lib.resolve(device)
        self.prior = None if prior is None else prior.to(self.device)
        self.D = D if D is not None else prior.D
        self.blocks = (blocks.NormalGammaBlock(self.D),)

    @classmethod
    def from_flat_dim(cls, P: int, *, device=None) -> "LinRegModel":
        """Recover D from P = 2 + D + D^2 (integer root)."""
        D = int(round((-1.0 + (1.0 + 4.0 * (P - 2)) ** 0.5) / 2.0))
        if linreg.flat_dim(D) != P:
            raise ValueError(f"no integer D with flat_dim(D) == {P}")
        return cls(D=D, device=device)

    def split_hyper(self, q: NGPosterior) -> tuple:
        return (NGPosterior(m=q.m[..., None, :], V=q.V[..., None, :, :],
                            a=q.a[..., None], b=q.b[..., None]),)

    def join_hyper(self, parts: tuple) -> NGPosterior:
        h = parts[0]
        return NGPosterior(m=h.m[..., 0, :], V=h.V[..., 0, :, :],
                           a=h.a[..., 0], b=h.b[..., 0])

    def _is_phi_stack(self, data) -> bool:
        return (isinstance(data, torch.Tensor) and data.dim() == 2
                and data.shape[-1] == self.flat_dim)

    def local_optimum(self, data, phi_nodes, replication):
        # No local latents: phi*_i does not depend on the current iterate.
        # `data` is a precomputed (N, P) phi* stack or raw (X, y, mask).
        if self._is_phi_stack(data):
            return data
        X, y, mask = data
        return linreg.local_optimum(X, y, mask, self.prior, replication)

    def _raw_data(self, data):
        if self._is_phi_stack(data):
            raise ValueError(
                "cannot minibatch a precomputed (N, P) phi* stack; pass "
                "raw (X, y, mask) node data to stream LinRegModel")
        return data

    def data_mask(self, data):
        return self._raw_data(data)[-1]

    def take_minibatch(self, data, idx, mb_mask):
        return super().take_minibatch(self._raw_data(data), idx, mb_mask)

    def append_node_data(self, data, node, points):
        """`points` is an (X_new (M, D), y_new (M,)) pair, written into
        node `node`'s first free mask-zero slots of (X, y, mask)."""
        X, y, mask = self._raw_data(data)
        X_new, y_new = (torch.as_tensor(np.asarray(a), dtype=ref.dtype,
                                        device=ref.device)
                        for a, ref in zip(points, (X, y)))
        if X_new.dim() == 1:
            X_new, y_new = X_new[None], y_new.reshape(1)
        slots = self._free_slots(mask, node, X_new.shape[0])
        X, y, mask = X.clone(), y.clone(), mask.clone()
        X[node, slots] = X_new
        y[node, slots] = y_new
        mask[node, slots] = 1
        return (X, y, mask)
