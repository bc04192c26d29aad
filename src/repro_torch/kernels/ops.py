"""Public wrappers around the port's kernels (the GMM part of
`repro.kernels.ops`).

`gmm_estep_nodes` and `gmm_estep` are the kernel module's wrappers
themselves, so `ops.gmm_estep_nodes.launches` is the kernel's launch
count: a plain integer that a run can zero and read to show that the main
path went through the kernel.
"""
from __future__ import annotations

from repro_torch.kernels import gmm_estep as _ge

gmm_estep_nodes = _ge.gmm_estep_nodes
gmm_estep = _ge.gmm_estep


def gmm_estep_from_posterior(x, mask, q, *, block_t: int = 512,
                             compute_dtype=None):
    """Compute the kernel's per-component terms from a GMMPosterior (in
    `compute_dtype`, default the posterior's own), then run the fused
    step.  Matches gmm.responsibilities + gmm.sufficient_stats
    (replication 1).  The kernel takes f32 terms."""
    from repro_torch.core import gmm
    terms = gmm.estep_terms(q, dtype=compute_dtype)
    return gmm_estep(x, mask, *(t.float().contiguous() for t in terms),
                     block_t=block_t)
