"""Device resolution for the port's entry points.

`None` means the CUDA device.  The CPU runs only when the caller names it:
nothing here falls back to the CPU because no card was found.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """Entry-point device: None -> "cuda"; raises without a card unless the
    caller asked for the CPU explicitly.

    >>> resolve("cpu")
    device(type='cpu')
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return dev
