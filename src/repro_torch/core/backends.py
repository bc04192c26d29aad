"""Compute backends: WHICH implementation runs the per-iteration hot path.

Port of `repro.core.backends`.  For the Bayesian GMM the per-node VBE step
plus local VBM optimum (Eqs. 17a/18, Appendix A) dominates every paper
experiment; everything exchanged between nodes stays in natural-parameter
space, only the arithmetic that produces phi* varies:

* `ReferenceBackend` ("reference") — the three-pass path of core/gmm.py.
* `FusedBackend` ("fused") — data -> phi* as
    1. unpack phi and precompute the per-node kernel terms
       (gmm.estep_terms) in `PrecisionPolicy.accum_dtype`, centred on
       the component means,
    2. the node-batched single-pass kernel (kernels/gmm_estep.py):
       responsibilities + per-component centred sufficient statistics in
       ONE sweep over the data, f32 accumulation, replication applied at
       emit,
    3. the Appendix-A VBM update (gmm.posterior_from_stats on the centred
       statistics) and expfam.pack_natural, batched over nodes in
       `accum_dtype`.
  Data may stream in bf16 (`PrecisionPolicy.data_dtype`) while
  accumulation stays f32.  `stream_data` casts x and mask to the
  streaming dtype; `engine.vb_init` calls it once per session (through
  `GMMModel.stream_data`), so an iteration reads the session's cast copy
  instead of copying the data again.
  The centring is this port's departure from the reference's fused
  path: the same function, but the reference's expanded form
  (x'Wn x - 2 x'b + c and sum_xx - R xbar xbar^T) cancels most of an
  f32 statistic's digits at deployment scale (N=1000 x 4096 points), where
  the Eq. 46 metric of cVB then moves by ~1e-3 between two f32
  implementations (PERF.md, PR 11).

A model the asked-for backend cannot run (`Backend.supports` says no: an
HMM, a PPCA or a linear-regression model with `backend="fused"`, or a GMM
past the wide kernel's shared memory) runs the reference backend, as in
the reference: `engine.vb_init` warns once per (backend, model type)
through `fallback` ("... falling back to the reference backend"),
counts every fallback in `backend_fallback_total{backend,model}`, and
carries on.  That is the only fallback: a kernel that fails to build or
to launch raises, and the fused backend never gives way to the plain
version on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch import telemetry
from repro_torch.core import expfam, gmm
from repro_torch.core.expfam import GMMPosterior


class PrecisionPolicy(NamedTuple):
    """Dtype contract of the fused hot path.

    data_dtype : streaming dtype of x/mask entering the kernel (None =
        as given; bf16 halves the bytes the kernel reads).
    accum_dtype : dtype of the unpack/precompute and the VBM post-stage
        (None = the incoming iterate's; the kernel's statistics always
        accumulate in f32).  f64 iterates keep an f64 post-stage, which
        the reference's fixed f32 default would round away.
    out_dtype : dtype of the returned phi* stack (None = the incoming
        iterate's).

    >>> FusedBackend(precision=PrecisionPolicy(data_dtype=torch.bfloat16)
    ...              ).precision.data_dtype
    torch.bfloat16
    """

    data_dtype: Any = None
    accum_dtype: Any = None
    out_dtype: Any = None


@runtime_checkable
class Backend(Protocol):
    """What a GMM compute backend provides to GMMModel.local_optimum.

    >>> resolve(None).name, resolve("fused").name
    ('reference', 'fused')
    """

    name: str

    def supports(self, model) -> bool:
        """Can this backend run `model`'s hot path?  When the answer is no,
        `engine.vb_init` falls back to the reference backend (`fallback`).
        """
        ...

    def local_vbm_optimum_nodes(self, x, mask, phi_nodes,
                                prior: GMMPosterior, replication,
                                K: int, D: int) -> torch.Tensor:
        """(N, Ni, D) data + (N, P) iterates -> (N, P) local optima phi*."""
        ...


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """core/gmm.py as-is: three passes over the data per iteration."""

    name: str = dataclasses.field(default="reference", init=False)

    def supports(self, model) -> bool:
        return True

    def local_vbm_optimum_nodes(self, x, mask, phi_nodes, prior,
                                replication, K, D):
        return gmm.local_vbm_optimum_nodes(x, phi_nodes, prior, replication,
                                           K, D, mask)


@dataclasses.dataclass(frozen=True)
class FusedBackend:
    """Single-pass VBE kernel + batched VBM post-stage."""

    block_t: int = 512
    precision: PrecisionPolicy = PrecisionPolicy()
    name: str = dataclasses.field(default="fused", init=False)

    def supports(self, model) -> bool:
        """The kernels implement exactly the GMM E-step (models tag their
        hot-path family with `kernel_family`) at every K, D >= 1
        (`kernels.gmm_estep.supported`: the wide path splits a node's
        statistics over blocks where one block cannot hold them)."""
        from repro_torch.kernels.gmm_estep import supported
        return (getattr(model, "kernel_family", None) == "gmm"
                and supported(getattr(model, "K", 0), getattr(model, "D", 0)))

    def stream_data(self, x, mask):
        """x and mask in the kernel's streaming dtype: the policy's
        `data_dtype`, else f32 for f64 data (the kernel streams f32 or
        bf16), else x's own.  Already-streamed data pass through without
        a copy."""
        dtype = self.precision.data_dtype
        if dtype is None:
            dtype = torch.float32 if x.dtype == torch.float64 else x.dtype
        return x.to(dtype), mask.to(dtype)

    def local_vbm_optimum_nodes(self, x, mask, phi_nodes, prior,
                                replication, K, D):
        from repro_torch.kernels import ops

        p = self.precision
        acc = p.accum_dtype if p.accum_dtype is not None else phi_nodes.dtype
        out = p.out_dtype if p.out_dtype is not None else phi_nodes.dtype
        q = expfam.unpack_natural(phi_nodes.to(acc), K, D)
        # centre each component on its mean, as the kernel sees it (f32)
        shift = q.m.float().contiguous()
        terms = gmm.estep_terms(q, dtype=torch.float32, shift=shift)
        x, mask = self.stream_data(x, mask)
        _, R, sum_x, sum_xx = ops.gmm_estep_nodes(
            x, mask, *(t.contiguous() for t in terms), float(replication),
            shift=shift, block_t=self.block_t, return_r=False)
        stats = gmm.SuffStats(R=R.to(acc), sum_x=sum_x.to(acc),
                              sum_xx=sum_xx.to(acc))
        q_star = gmm.posterior_from_stats(stats, prior.to(dtype=acc),
                                          shift=shift.to(acc))
        return expfam.pack_natural(q_star).to(out)


def fallback(backend, model) -> "ReferenceBackend":
    """The reference backend, for a model `backend` does not support:
    counts every fallback (`backend_fallback_total{backend,model}`) and
    warns the first time each (backend, model type) pair falls back (a
    session re-opened many times warns once; `telemetry.reset()` lets it
    warn again)."""
    model_name = type(model).__name__
    telemetry.inc("backend_fallback_total", backend=backend.name,
                  model=model_name)
    telemetry.warn_once(
        f"backend-fallback:{backend.name}:{model_name}",
        f"backend {backend.name!r} does not support {model_name} "
        "(Backend.supports returned False); falling back to the reference "
        "backend", stacklevel=3)
    return ReferenceBackend()


_BY_NAME = {"reference": ReferenceBackend, "fused": FusedBackend}


def resolve(backend) -> Backend:
    """None -> reference; a name -> default instance; instances pass."""
    if backend is None:
        return ReferenceBackend()
    if isinstance(backend, str):
        try:
            return _BY_NAME[backend]()
        except KeyError:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{sorted(_BY_NAME)} or a Backend instance") from None
    if not isinstance(backend, Backend):
        raise TypeError(f"not a compute backend: {backend!r}")
    return backend
