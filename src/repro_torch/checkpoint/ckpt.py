"""Carry state across from the JAX reference (read side of its checkpoints).

This system has no network weights: what carries over is the prior
posterior, the initial iterate and the session state (phi, the absolute t,
the ADMM duals and the last `ConsensusDiagnostics`).  The reference's
`repro.checkpoint.ckpt.save` writes a compressed .npz whose `__meta__`
entry is a JSON manifest mapping each pytree key path (`.phi`, `.t`,
`.carry`, `.diag.<field>`) to an array name and dtype, with bf16 stored as
a uint16 view.  This module reads it with numpy alone.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core.engine import VBState
from repro_torch.core.expfam import GMMPosterior

_BF16 = "bfloat16"


def posterior_from_numpy(alpha, m, beta, W, nu, *, device,
                         dtype=torch.float64) -> GMMPosterior:
    """A GMMPosterior from host arrays (e.g. a reference prior)."""
    return GMMPosterior(*(torch.as_tensor(np.asarray(a), dtype=dtype,
                                          device=device)
                          for a in (alpha, m, beta, W, nu)))


def read_npz(path: str) -> dict[str, np.ndarray]:
    """{key path: array} of a reference checkpoint."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out = {}
        for key, info in meta.items():
            arr = z[info["name"]]
            if info["dtype"] == _BF16:
                # bf16 is stored as its uint16 bit pattern
                arr = torch.from_numpy(arr.astype(np.uint16).view(np.int16)
                                       ).view(torch.bfloat16)
            out[key] = arr
    return out


def _load(arr, like: torch.Tensor, key: str) -> torch.Tensor:
    t = torch.as_tensor(arr)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def state_from_arrays(arrays: dict, like: VBState) -> VBState:
    """`like` (a `vb_init` state of the same configuration) with its
    arrays replaced by the reference checkpoint's; shapes are checked."""
    def get(key):
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        return arrays[key]

    t = np.asarray(get(".t"))
    if t.shape != ():
        raise ValueError(f".t: shape {t.shape} != ()")
    carry = like.carry
    if carry is not None:
        carry = _load(get(".carry"), carry, ".carry")
    diag = like.diag
    if diag is not None:
        diag = type(diag)(**{
            f: _load(get(f".diag.{f}"), getattr(diag, f), f".diag.{f}")
            for f in diag._fields})
    return like.replace(phi=_load(get(".phi"), like.phi, ".phi"),
                        t=int(t), carry=carry, diag=diag)


def load_reference_checkpoint(path: str, like: VBState) -> VBState:
    """Resume a session the JAX package checkpointed: read its .npz and
    load it into `like` (see `state_from_arrays`)."""
    return state_from_arrays(read_npz(path), like)
