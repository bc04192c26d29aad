"""Composable exponential-family blocks — the model layer's building bricks.

Port of `repro.core.blocks`: the GMM's two families and the Normal-Gamma
bank of the linear-regression instance.  A
conjugate-exponential global posterior factorises into independent
exponential-family *blocks*; the flat Eq. 45 message, the Eq. 38b
projection, the Eq. 46 KL and the per-block labels are concatenations of
per-block quantities:

* `ExpFamBlock` names the per-block surface;
* `DirichletBlock` and `NormalWishartBlock` are the GMM's families,
  `NormalGammaBlock` the linear-regression instance's;
* `BlockModel` derives the `model.ConjugateExpModel` surface from a block
  tuple, with the streaming layer's `data_mask` and `take_minibatch`.

Every method takes leading batch dimensions (nodes, reference
permutations) on its flat segments and hyper containers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import backends, expfam, linreg
from repro_torch.core.expfam import NWParams
from repro_torch.core.linreg import NGPosterior


@runtime_checkable
class ExpFamBlock(Protocol):
    """One exponential-family factor bank = one contiguous segment of the
    flat natural-parameter message (`dim` coordinates)."""

    @property
    def dim(self) -> int:
        ...

    @property
    def label_names(self) -> tuple:
        ...

    def labels(self) -> np.ndarray:
        """(dim,) int32 group label per coordinate, indexing label_names."""
        ...

    def pack(self, h) -> torch.Tensor:
        ...

    def unpack(self, x: torch.Tensor):
        ...

    def log_partition(self, h) -> torch.Tensor:
        """A(phi) of the block, summed over its rows."""
        ...

    def expected_stats(self, h) -> torch.Tensor:
        """grad_phi A = E[u], laid out exactly like `pack`."""
        ...

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Projection of the segment onto the block's domain (Eq. 38b)."""
        ...

    def kl(self, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        ...


def default_kl(block: ExpFamBlock, x: torch.Tensor,
               x_ref: torch.Tensor) -> torch.Tensor:
    """Family-generic block KL via the exp-family identity
    KL = (phi_q - phi_p)' E_q[u] - A(q) + A(p)."""
    hq, hp = block.unpack(x), block.unpack(x_ref)
    inner = ((x - x_ref) * block.expected_stats(hq)).sum(-1)
    return inner - block.log_partition(hq) + block.log_partition(hp)


@dataclasses.dataclass(frozen=True)
class DirichletBlock:
    """Bank of `rows` independent Dirichlet factors over K categories
    (rows=1 is the GMM mixing-weight block).  Hyper container: alpha
    (..., rows, K).  Flat coords: alpha - 1."""

    K: int
    rows: int = 1
    name: str = "alpha"
    min_alpha: float = 1e-3

    @property
    def dim(self) -> int:
        return self.rows * self.K

    @property
    def label_names(self) -> tuple:
        return (self.name,)

    def labels(self) -> np.ndarray:
        return np.zeros(self.dim, np.int32)

    def pack(self, alpha: torch.Tensor) -> torch.Tensor:
        return (alpha - 1.0).flatten(-2)

    def unpack(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[:-1] + (self.rows, self.K)) + 1.0

    def log_partition(self, alpha: torch.Tensor) -> torch.Tensor:
        return expfam.dirichlet_log_partition(alpha).sum(-1)

    def expected_stats(self, alpha: torch.Tensor) -> torch.Tensor:
        return expfam.dirichlet_expected_log(alpha).flatten(-2)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x + 1.0, min=self.min_alpha) - 1.0

    def kl(self, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        aq, ap = self.unpack(x), self.unpack(x_ref)
        inner = ((aq - ap) * expfam.dirichlet_expected_log(aq)).sum((-1, -2))
        return (inner - expfam.dirichlet_log_partition(aq).sum(-1)
                + expfam.dirichlet_log_partition(ap).sum(-1))


@dataclasses.dataclass(frozen=True)
class NormalWishartBlock:
    """Bank of K Normal-Wishart factors (mu_k, Lambda_k) in D dims.
    Hyper container: `expfam.NWParams`; flat layout per component
    [n1, n4, n3 (D), vec(n2) (D*D)] (Eq. 45)."""

    K: int
    D: int
    min_beta: float = 1e-6
    min_eig: float = 1e-8

    @property
    def dim(self) -> int:
        return self.K * (2 + self.D + self.D * self.D)

    @property
    def label_names(self) -> tuple:
        return ("nu", "beta", "mean", "winv")

    def labels(self) -> np.ndarray:
        per = [0, 1] + [2] * self.D + [3] * (self.D * self.D)
        return np.asarray(per * self.K, np.int32)

    def pack(self, h: NWParams) -> torch.Tensor:
        return expfam.nw_pack(h)

    def unpack(self, x: torch.Tensor) -> NWParams:
        return expfam.nw_unpack(x, self.K, self.D)

    def log_partition(self, h: NWParams) -> torch.Tensor:
        return expfam.nw_log_partition(h).sum(-1)

    def expected_stats(self, h: NWParams) -> torch.Tensor:
        return expfam.nw_expected_stats_flat(h)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return expfam.nw_project(x, self.K, self.D, min_beta=self.min_beta,
                                 min_eig=self.min_eig)

    def kl(self, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        return expfam.nw_kl(self.unpack(x), self.unpack(x_ref))


@dataclasses.dataclass(frozen=True)
class NormalGammaBlock:
    """Bank of `rows` independent Normal-Gamma factors over D coefficients
    (rows=1 is Bayesian linear regression).  Hyper container:
    `linreg.NGPosterior` with a rows axis before each field's own axes
    (m (..., rows, D), V (..., rows, D, D), a and b (..., rows)); flat
    layout per row: [n1, n2, n3 (D), vec(n4)].

    `project` is the identity: consensus averages of Normal-Gamma
    naturals stay in the domain."""

    D: int
    rows: int = 1

    @property
    def dim(self) -> int:
        return self.rows * linreg.flat_dim(self.D)

    @property
    def label_names(self) -> tuple:
        return linreg.BLOCK_NAMES

    def labels(self) -> np.ndarray:
        return np.tile(linreg.block_labels(self.D), self.rows)

    def pack(self, h: NGPosterior) -> torch.Tensor:
        return linreg.pack(h).flatten(-2)

    def unpack(self, x: torch.Tensor) -> NGPosterior:
        rows = x.reshape(x.shape[:-1] + (self.rows, linreg.flat_dim(self.D)))
        return linreg.unpack(rows, self.D)

    def log_partition(self, h: NGPosterior) -> torch.Tensor:
        return linreg.log_partition(h).sum(-1)

    def expected_stats(self, h: NGPosterior) -> torch.Tensor:
        e_loglam, e_lam, e_lw, e_lww = linreg.expected_stats(h)
        return torch.cat([e_loglam[..., None], e_lam[..., None], e_lw,
                          e_lww.flatten(-2)], -1).flatten(-2)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def kl(self, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
        return linreg.kl(self.unpack(x), self.unpack(x_ref)).sum(-1)


class BlockModel:
    """`ConjugateExpModel` defaults derived from a tuple of `ExpFamBlock`s.

    Subclasses set `self.blocks` and `self.prior` and implement
    `split_hyper`, `join_hyper` and `local_optimum`; the data convention
    is a tuple `(*arrays, mask)` with the per-node sample axis at
    position 1.
    """

    blocks: tuple = ()
    prior: Any = None
    #: `local_optimum` on a fleet launches nothing that waits for the host,
    #: so a serving fleet may replay its iteration as a CUDA graph
    #: (serving/driver.py).  False unless a model says so: LinReg and PPCA
    #: call `torch.linalg.inv` / `solve`, which read their error flags back
    #: on the host; the HMM's step has not been captured on the card
    sync_free_step = False

    @property
    def flat_dim(self) -> int:
        return sum(b.dim for b in self.blocks)

    def _segments(self):
        """[(block, start, stop)] of each block's flat segment."""
        out, off = [], 0
        for b in self.blocks:
            out.append((b, off, off + b.dim))
            off += b.dim
        return out

    def split_hyper(self, q) -> tuple:
        raise NotImplementedError

    def join_hyper(self, parts: tuple):
        raise NotImplementedError

    def pack(self, q) -> torch.Tensor:
        parts = self.split_hyper(q)
        return torch.cat([b.pack(h) for b, h in zip(self.blocks, parts)],
                         dim=-1)

    def unpack(self, phi: torch.Tensor):
        return self.join_hyper(tuple(
            b.unpack(phi[..., lo:hi]) for b, lo, hi in self._segments()))

    def init_phi(self) -> torch.Tensor:
        if self.prior is None:
            raise ValueError(f"{type(self).__name__} built without a prior")
        return self.pack(self.prior)

    def project_to_domain(self, phi: torch.Tensor) -> torch.Tensor:
        return torch.cat([b.project(phi[..., lo:hi])
                          for b, lo, hi in self._segments()], dim=-1)

    def kl(self, phi: torch.Tensor, phi_ref: torch.Tensor) -> torch.Tensor:
        total = None
        for b, lo, hi in self._segments():
            term = b.kl(phi[..., lo:hi], phi_ref[..., lo:hi])
            total = term if total is None else total + term
        return total

    @property
    def BLOCK_NAMES(self) -> tuple:
        return tuple(n for b in self.blocks for n in b.label_names)

    def block_labels(self) -> np.ndarray:
        parts, base = [], 0
        for b in self.blocks:
            parts.append(b.labels().astype(np.int32) + base)
            base += len(b.label_names)
        return np.concatenate(parts).astype(np.int32)

    def local_optimum(self, data: Any, phi_nodes: torch.Tensor,
                      replication: float) -> torch.Tensor:
        raise NotImplementedError

    def with_backend(self, backend) -> "BlockModel":
        """Default: only the reference path exists."""
        resolved = backends.resolve(backend)
        if resolved.name != "reference":
            raise ValueError(
                f"{type(self).__name__} has no {resolved.name!r} compute "
                "backend; its local VBM optimum runs on the reference "
                "path only")
        return self

    def data_mask(self, data: Any) -> torch.Tensor:
        return data[-1]

    def take_minibatch(self, data: Any, idx: torch.Tensor,
                       mb_mask: torch.Tensor) -> Any:
        """The iteration's minibatch: every array gathered along the
        sample axis (1) at `idx` (N, B), its trailing axes kept, and the
        mask replaced by the scaled minibatch mask `mb_mask` (N, B)."""
        out = []
        for a in data[:-1]:
            ix = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
            out.append(torch.gather(a, 1, ix.expand(idx.shape
                                                    + a.shape[2:])))
        return (*out, mb_mask)

    # -- serving: fixed-capacity buffers (host-side, at slice boundaries) --
    def append_node_data(self, data: Any, node: int, points: Any) -> Any:
        """New `(x, mask)` buffers with `points` (leading axis = new
        samples, trailing axes = x's per-sample shape) written into node
        `node`'s first free mask-zero slots: the same shapes and dtypes,
        so a fleet slot takes them in place.  Raises ValueError when the
        node has fewer free slots than points."""
        x, mask = data
        points = torch.as_tensor(np.asarray(points), dtype=x.dtype,
                                 device=x.device)
        if points.dim() == x.dim() - 2:
            points = points[None]
        slots = self._free_slots(mask, node, points.shape[0])
        x, mask = x.clone(), mask.clone()
        x[node, slots] = points
        mask[node, slots] = 1
        return (x, mask)

    def _free_slots(self, mask: torch.Tensor, node: int,
                    n_new: int) -> torch.Tensor:
        """The first `n_new` mask-zero slots of node `node` (a host read
        of the node's mask row)."""
        free = torch.nonzero(mask[node] <= 0).flatten()
        if free.shape[0] < n_new:
            raise ValueError(
                f"node {node}: buffer full ({int(free.shape[0])} free "
                f"slot(s), {n_new} new point(s))")
        return free[:n_new]

    def pad_to_capacity(self, data: Any, capacity: int) -> Any:
        """Every buffer padded along the sample axis (1) to `capacity`
        with zeros: mask-zero slots that change no statistic.  Raises
        ValueError below the current capacity."""
        T = self.data_mask(data).shape[1]
        if capacity < T:
            raise ValueError(
                f"capacity {capacity} < current buffer size {T}")
        if capacity == T:
            return data
        return tuple(_pad_axis1(torch.as_tensor(a), capacity - T)
                     for a in data)


def _pad_axis1(a: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])], 1)
