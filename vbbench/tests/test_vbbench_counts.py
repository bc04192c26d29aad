"""The frozen work counts: against a hand count at a small (N, T, K, D)
and against the bring-up smoke script's E-step bound at 1000 x 4096."""
from __future__ import annotations

import sys

import torch

from vbbench.counts import gmm_work
from conftest import REPO


def test_hand_count_small():
    N, T, K, D = 2, 5, 3, 2
    w = gmm_work.estep_work(N, T, K, D)
    # x (2 f32 a point) and mask (1 f32 a point): 2 * 5 * 3 * 4 bytes
    data = 120
    # log_prior 3, Wn 12, b 6, c 3, shift 6 = 30 f32 a node
    terms = 2 * 30 * 4
    # R 3, sum_x 6, sum_xx 12 = 21 f32 a node
    stats = 2 * 21 * 4
    assert w["bytes"] == data + terms + stats
    per = N * T * K                              # 30 point-components
    # log rho: (D+1)(D+2) + 2(D+1) = 18; stats: D^2 + 3D + 1 = 11
    assert w["f64_ops"] == per * (18 + 11)
    assert w["f32_ops"] == per * 10
    it = gmm_work.iteration_work(N, T, K, D, graph_bytes=1000)
    assert it["bytes"] == data + 2 * N * 27 * 8 + 1000
    least = gmm_work.least_seconds(w)
    assert least == max(w["bytes"] / 3.35e12,
                        w["f64_ops"] / 67e12 + w["f32_ops"] / 67e12)


def test_matches_the_smoke_scripts_bound_at_1000_x_4096():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    N, T, K, D = 1000, 4096, 3, 2
    meta = dict(device="meta", dtype=torch.float32)
    x, mask = torch.empty(N, T, D, **meta), torch.empty(N, T, **meta)
    terms = (torch.empty(N, K, **meta), torch.empty(N, K, D, D, **meta),
             torch.empty(N, K, D, **meta), torch.empty(N, K, **meta))
    shift = torch.empty(N, K, D, **meta)
    ms, by, n_bytes, flops = chip_smoke._gmm_bound(x, mask, terms, shift,
                                                   K, D)
    w = gmm_work.estep_work(N, T, K, D)
    # the one departure: the statistics written, K (1 + D + D^2) a node
    # here against K D (2 + D) there
    assert w["bytes"] == n_bytes - N * K * D * (2 + D) * 4 \
        + N * K * (1 + D + D * D) * 4
    assert w["f64_ops"] + w["f32_ops"] == flops
    assert by == "bytes"
    assert abs(gmm_work.least_seconds(w) * 1e3 - ms) / ms < 1e-3
