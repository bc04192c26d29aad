"""Request-admission helpers of the LM serving engine (the numpy part of
`repro.serving.admission`).

The LM `serving.engine.Engine` admits variable-length prompts and packs
them into one right-aligned (B, L) token batch (`right_aligned_batch`),
grouping prompts into waves by `bucket_capacity` rung when bucketing is
enabled.  The VB fleet's signatures and `data_axis_mesh` wait for ROADMAP
Queue 1 items 13 and 14.
"""
from __future__ import annotations

import numpy as np


def bucket_capacity(n: int, *, growth: float = 2.0,
                    min_size: int = 8) -> int:
    """Smallest ladder rung >= n.  Rungs start at `min_size` and grow
    geometrically by `growth` (2.0 = power-of-two; ~1.25 gives finer
    boundaries at the cost of more distinct batch shapes).

    >>> [bucket_capacity(n) for n in (1, 8, 9, 25, 64, 65)]
    [8, 8, 16, 32, 64, 128]
    >>> bucket_capacity(25, growth=1.25, min_size=8)   # 8,10,13,17,22,28
    28
    """
    if n < 1:
        raise ValueError(f"capacity must be >= 1: {n}")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1.0: {growth}")
    cap = int(min_size)
    while cap < n:
        # max(+1) keeps the ladder strictly increasing for tiny growth
        cap = max(cap + 1, int(-(-cap * growth // 1)))
    return cap


def right_aligned_batch(seqs, length: int | None = None,
                        dtype=np.int32, pad_value: int = 0) -> np.ndarray:
    """Stack variable-length 1-D sequences into a right-aligned (B, L)
    array (left-padded with `pad_value`), the layout the LM prefill
    expects.  `length` pads to a fixed L and must cover the longest
    sequence (ValueError otherwise — truncation is the caller's policy);
    default: the longest sequence.

    >>> right_aligned_batch([[1, 2, 3], [7]]).tolist()
    [[1, 2, 3], [0, 0, 7]]
    >>> right_aligned_batch([[1, 2]], length=4).tolist()
    [[0, 0, 1, 2]]
    """
    seqs = [np.asarray(s, dtype) for s in seqs]
    longest = max((s.shape[0] for s in seqs), default=0)
    if length is None:
        length = longest
    if length < longest:
        raise ValueError(f"length {length} < longest sequence {longest}")
    out = np.full((len(seqs), length), pad_value, dtype)
    for i, s in enumerate(seqs):
        if s.shape[0]:
            out[i, length - s.shape[0]:] = s
    return out
