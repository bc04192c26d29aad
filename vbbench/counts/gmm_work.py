"""Frozen work counts of the GMM VB iteration, and its least times at the
H100's published peaks (`h100_sxm.json` beside this file).

The E-step count is a frozen copy of the bound the bring-up's chip smoke
script prices the `gmm_estep_nodes` call with, so the roofline reads the
same work whatever implements the kernel: x and mask read once in their
dtype, the float32 per-component terms and shift read once, the
statistics written once, and per point and component the least
arithmetic the function needs (log rho as the quadratic form of
x' = (x, 1) on U_k's upper triangle and its row dot, priced at the FP64
tensor cores; the combine and softmax, ~10, at the float32 peak; the
statistics r y, sum_x, the upper triangle of sum_xx and R).  One
departure: the statistics written are R (K), sum_x (K D) and sum_xx
(K D D) a node, where the smoke script counted K D (2 + D).

The whole iteration's least time counts its inputs read once and its
outputs written once: the data, the float64 iterate in and out, and the
graph (edge lists and weights, or the dense weight matrix); its
operations are the E-step's (the post-stage and the combine are O(N P)
and O(E P), nothing beside 409.6 M points).
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("h100_sxm.json")).read_text())


def estep_work(n_nodes: int, n_points: int, K: int, D: int,
               data_bytes: int = 4, mask_bytes: int = 4) -> dict:
    """Bytes and operations of one `gmm_estep_nodes` call without r."""
    N, T = n_nodes, n_points
    terms = N * (K + K * D * D + K * D + K + K * D) * 4  # + shift
    stats = N * K * (1 + D + D * D) * 4
    n_bytes = N * T * (D * data_bytes + mask_bytes) + terms + stats
    per = N * T * K
    f64_ops = per * ((D + 1) * (D + 2) + 2 * (D + 1)) + per * (D * D + 3 * D
                                                             + 1)
    f32_ops = per * 10
    return {"bytes": n_bytes, "f64_ops": f64_ops, "f32_ops": f32_ops}


def least_seconds(work: dict) -> float:
    """The larger of bytes over HBM bandwidth and the operations over
    their peaks."""
    return max(work["bytes"] / PEAKS["hbm_bytes_per_s"],
               work["f64_ops"] / PEAKS["f64_tensor_flop_per_s"]
               + work["f32_ops"] / PEAKS["f32_flop_per_s"])


def iteration_work(n_nodes: int, n_points: int, K: int, D: int, *,
                   graph_bytes: int, data_bytes: int = 4,
                   mask_bytes: int = 4) -> dict:
    """One VB iteration over `n_nodes` nodes (a fleet's slots times
    nodes): the data read once, the float64 iterate read and written
    once, the graph read once; the E-step's operations."""
    P = K + K * (2 + D + D * D)
    e = estep_work(n_nodes, n_points, K, D, data_bytes, mask_bytes)
    n_bytes = (n_nodes * n_points * (D * data_bytes + mask_bytes)
               + 2 * n_nodes * P * 8 + graph_bytes)
    return {"bytes": n_bytes, "f64_ops": e["f64_ops"],
            "f32_ops": e["f32_ops"]}


def sparse_graph_bytes(n_nodes: int, n_links: int) -> int:
    """Directed edges' senders and receivers (int64) and float64 weights,
    and a float64 self weight a node."""
    return 2 * n_links * (8 + 8 + 8) + n_nodes * 8


def dense_graph_bytes(n_nodes: int) -> int:
    return n_nodes * n_nodes * 8
