"""AdamW over a model's named parameters (port of `repro.optim.adamw`).

Parameters, gradients and moments are dicts {name: tensor} with the
model's parameter names (`nn.Module.named_parameters()`; a module may be
passed for its parameters).  The moments are float32 whatever the
parameter dtype, and the update runs in float32 and is cast to the
parameter's dtype (mixed precision: bf16 params, f32 state).  The
reference returns new trees; the port updates the parameters, the moments
and (in `clip_by_global_norm`) the gradients in place, under
`torch.no_grad()`, which keeps one copy of each in device memory.  The
scalars (bias corrections, lr) are the reference's float32 values.

On a device mesh the parameters, gradients and moments are DTensors of
one layout (the moments are made like their parameters): the update is
elementwise on each rank's block, and `global_norm` sums every leaf's
squares across its shards (DTensor reductions), so it is the norm of the
whole model wherever its leaves are model- or data-sharded.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: int


def named(params) -> dict:
    """{name: tensor} of a module's parameters (a dict passes through)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def init(params) -> AdamState:
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in named(params).items()}
    return AdamState(mu=zeros(), nu=zeros(), count=0)


@torch.no_grad()
def update(grads: dict, state: AdamState, params, *, lr,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1):
    """One AdamW step, in place.  Returns (params, the state with
    count + 1); `lr` is a Python or numpy float (a float32 in the
    reference)."""
    count = state.count + 1
    cf = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** cf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** cf)
    lr = float(np.float32(lr))
    for name, p in named(params).items():
        g = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + (1.0 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a replicated
    DTensor scalar when the leaves are DTensors)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2)
                          for t in tree.values()))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled in place by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm
