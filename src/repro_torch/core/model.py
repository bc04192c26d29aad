"""Conjugate-exponential model adapters for the unified VB engine.

Port of `repro.core.model` (the GMM instance).  Every algorithm touches a
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
from repro_torch.core import backends, blocks
from repro_torch.core.expfam import GMMPosterior, NWParams


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
