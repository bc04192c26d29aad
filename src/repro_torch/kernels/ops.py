"""Public wrappers around the port's kernels (`repro.kernels.ops`).

`gmm_estep_nodes`, `gmm_estep`, `flash_attention` and `ssd_scan` are the
kernel modules' wrappers themselves, so `ops.<name>.launches` is the
kernel's launch count: a plain integer that a run can zero and read to
show that the main path went through the kernel.

`flash_attention` takes the GQA layout of `repro.kernels.ops` directly
(q (B,S,Hq,hd), k/v (B,S,Hkv,hd)): the kernel indexes the kv head, where
the JAX wrapper repeats k and v to the query heads.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm_estep as _ge
from repro_torch.kernels import ssd_scan as _ss

gmm_estep_nodes = _ge.gmm_estep_nodes
gmm_estep = _ge.gmm_estep
flash_attention = _fa.flash_attention
ssd_scan = _ss.ssd_scan


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
