"""Learning-rate and consensus-step schedules (port of
`repro.optim.schedules`).

`eta` / `kappa` are the paper's Eq. 29 / Eq. 40 from the port's VB
engine, reused by the consensus layer (`optim.consensus`) so the training
layer runs the schedules the VB layer validated.  The arithmetic is the
reference's float32: each function returns a numpy float32.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import eta_schedule as eta      # noqa: F401
from repro_torch.core.engine import kappa_schedule as kappa  # noqa: F401


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> np.float32:
    """Linear warmup to `peak_lr` over `warmup` steps, then a cosine decay
    to `floor * peak_lr` at `total`.

    >>> [round(float(cosine_warmup(s, peak_lr=1.0, warmup=2, total=4)), 3)
    ...  for s in (1, 2, 4)]
    [0.5, 1.0, 0.1]
    """
    s = np.float32(step)
    warm = s / np.float32(max(warmup, 1))
    prog = np.clip((s - np.float32(warmup))
                   / np.float32(max(total - warmup, 1)),
                   np.float32(0.0), np.float32(1.0))
    cos = np.float32(floor) + np.float32(1.0 - floor) * np.float32(0.5) * (
        np.float32(1.0) + np.cos(np.float32(np.pi) * prog))
    return np.float32(peak_lr) * (warm if s < warmup else cos)
