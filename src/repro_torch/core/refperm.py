"""Component-permutation utilities for the Eq. 46 metric.

Mixture components carry no canonical order, so the KL between an estimate
and the ground-truth posterior is only meaningful modulo a permutation of
components: the stack of all K! permuted references is built once and the
engine takes the min.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.core import expfam
from repro_torch.core.expfam import GMMPosterior


def permuted_refs(ref: GMMPosterior, max_k_factorial: int = 720
                  ) -> torch.Tensor:
    """(K!, P) stack of pack_natural over all component permutations."""
    perms = list(itertools.permutations(range(ref.K)))
    if len(perms) > max_k_factorial:
        raise ValueError(
            f"K={ref.K} too large for exhaustive permutation matching")
    idx = torch.as_tensor(perms, device=ref.alpha.device)      # (K!, K)
    return expfam.pack_natural(GMMPosterior(*(a[idx] for a in ref)))
