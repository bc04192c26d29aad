"""Public wrappers around the port's kernels (`repro.kernels.ops`).

`gmm_estep_nodes`, `gmm_estep`, `flash_attention` and `ssd_scan` wrap
the kernel modules' wrappers with a `kernel/<name>` span a call
(`_instrument`); `ops.<name>.launches` (and `gmm_estep_nodes`'
`variant_launches`) read and write the kernel's own launch count: a
plain integer that a run can zero and read to show that the main path
went through the kernel.  `launch_counts`, `set_launch_counts` and
`add_launch_counts` keep them counting what the device runs across a
CUDA graph's capture and replays (serving/driver.py).

`flash_attention` takes the GQA layout of `repro.kernels.ops` directly
(q (B,S,Hq,hd), k/v (B,S,Hkv,hd)): the kernel indexes the kv head, where
the JAX wrapper repeats k and v to the query heads.
"""
from __future__ import annotations

import functools

from repro_torch import telemetry
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm_estep as _ge
from repro_torch.kernels import ssd_scan as _ss


class _instrument:
    """A `kernel/<name>` trace span per call while telemetry records
    (host telemetry on, or a torch profiler recording: then the span is
    also a profiler range around the launch, beside the kernel's device
    time); one bool check and one profiler-state check otherwise.  The
    span covers the host's call, not the kernel: its device time is the
    profiler's to read.

    The reference spans only eager calls (the engine's jitted calls pass
    through); every call of the port is eager, so every launch on the
    hot path has its span.  Errors propagate: nothing is caught."""

    def __init__(self, name: str, fn):
        functools.update_wrapper(self, fn, updated=())
        self.name = name
        self._span = f"kernel/{name}"

    # the kernel's own counters, read and written through the wrapper
    @property
    def launches(self) -> int:
        return self.__wrapped__.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.__wrapped__.launches = value

    def __getattr__(self, attr):
        if attr == "__wrapped__":           # not set yet: no recursion
            raise AttributeError(attr)
        return getattr(self.__wrapped__, attr)

    def __call__(self, *args, **kwargs):
        with telemetry.span(self._span):
            return self.__wrapped__(*args, **kwargs)


gmm_estep_nodes = _instrument("gmm_estep_nodes", _ge.gmm_estep_nodes)
gmm_estep = _instrument("gmm_estep", _ge.gmm_estep)
flash_attention = _instrument("flash_attention", _fa.flash_attention)
ssd_scan = _instrument("ssd_scan", _ss.ssd_scan)

#: the kernels that keep a launch counter (`gmm_estep` counts through
#: `gmm_estep_nodes`)
_COUNTED = (gmm_estep_nodes, flash_attention, ssd_scan)


def launch_counts() -> dict:
    """Every kernel's launch counters: {name: launches} and, for
    `gmm_estep_nodes`, {(name, variant): launches}.  A CUDA graph capture
    launches nothing: a caller takes the counts before it, puts them back
    after (`set_launch_counts`), and adds what the graph holds at each
    replay (`add_launch_counts`), so the counters read what the device
    ran."""
    out = {}
    for k in _COUNTED:
        out[k.name] = k.launches
        for variant, n in getattr(k, "variant_launches", {}).items():
            out[(k.name, variant)] = n
    return out


def set_launch_counts(counts: dict) -> None:
    for k in _COUNTED:
        k.launches = counts[k.name]
        for variant in getattr(k, "variant_launches", {}):
            k.variant_launches[variant] = counts[(k.name, variant)]


def add_launch_counts(delta: dict, times: int) -> None:
    """Add `times` x `delta` (a difference of two `launch_counts`)."""
    now = launch_counts()
    set_launch_counts({key: n + times * delta[key] for key, n in now.items()})


def _gmm_estep_from_posterior(x, mask, q, *, block_t: int = 512,
                              compute_dtype=None):
    """Compute the kernel's per-component terms from a GMMPosterior (in
    `compute_dtype`, default the posterior's own), then run the fused
    step.  Matches gmm.responsibilities + gmm.sufficient_stats
    (replication 1).  The kernel takes f32 terms."""
    from repro_torch.core import gmm
    terms = gmm.estep_terms(q, dtype=compute_dtype)
    return _ge.gmm_estep(x, mask, *(t.float().contiguous() for t in terms),
                         block_t=block_t)


gmm_estep_from_posterior = _instrument("gmm_estep_from_posterior",
                                       _gmm_estep_from_posterior)
