"""The plain reference agrees with the port's plain path (the reference
backend, core/gmm.py, in float64 through `engine.vb_run`) at a tiny
size, for dSVB over the sparse and the dense graph and for adaptive
dVB-ADMM; and its sparse and dense graphs are the same graph."""
from __future__ import annotations

import pytest
import torch

from vbbench import harness
from vbbench.data import synth
from vbbench.drivers import batch_vb
from vbbench.reference import gmm_vb

N, T, STEPS = 60, 48, 6


def _inputs(seed=5):
    cfg = harness.cell("k3d2_100k.dsvb")["config"]
    side, radius = synth.paper_side_radius(N)
    cfg = dict(cfg, n_nodes=N, n_per_node=T, side=side, comm_radius=radius)
    return cfg, batch_vb.make_inputs(cfg, seed, "cpu")


@pytest.mark.parametrize("algorithm", ["dsvb", "admm"])
def test_reference_follows_the_ports_plain_path(algorithm, monkeypatch):
    from repro_torch.core import backends
    cfg, inp = _inputs()
    mix = {"algorithm": algorithm}
    # the port's plain path: the same session on the reference backend
    monkeypatch.setattr(backends, "_BY_NAME", dict(
        backends._BY_NAME, fused=backends.ReferenceBackend))
    state = batch_vb.open_session(cfg, mix, inp, "cpu")
    state, snaps = batch_vb.first_steps(state, STEPS)
    refs = batch_vb.reference_steps(cfg, mix, inp,
                                    list(range(1, STEPS + 1)),
                                    torch.float64, "cpu")
    for got, want in zip(snaps, refs):
        assert gmm_vb.worst_gap(got, want, 3, 2) < 1e-10


def test_sparse_and_dense_graph_agree():
    cfg, inp = _inputs(6)
    sparse = gmm_vb.Graph(inp["u"], inp["v"], N, "cpu")
    dense = gmm_vb.Graph(inp["u"], inp["v"], N, "cpu", dense=True)
    z = torch.randn(2, N, 27, dtype=torch.float64)
    assert torch.allclose(sparse.nsum(z), dense.nsum(z), rtol=1e-13)
    assert torch.allclose(sparse.diffuse(z), dense.diffuse(z), rtol=1e-13)
    assert torch.equal(sparse.deg, dense.adj.sum(1))


def test_gap_reads_a_wrong_block():
    cfg, inp = _inputs(7)
    ref = batch_vb.reference_steps(cfg, {"algorithm": "dsvb"}, inp, [1],
                                   torch.float64, "cpu")[0]
    assert gmm_vb.median_gap(ref, ref, 3, 2) == 0.0
    bad = ref.clone()
    bad[:, [4, 12, 20]] *= 1.0 + 1e-3  # every component's -beta/2
    assert gmm_vb.median_gap(bad, ref, 3, 2) > 1e-4
    bad = ref.clone()
    bad[:, 3:27] *= 1.0 + 1e-6         # a change far under the weakest
    assert gmm_vb.median_gap(bad, ref, 3, 2) < 1e-5
    bad = ref.clone()
    bad[0, 0] = float("nan")
    assert gmm_vb.worst_gap(bad, ref, 3, 2) == float("inf")
    assert gmm_vb.tail_gap(bad, ref, 3, 2) == float("inf")


def test_tail_reads_a_minority_of_nodes():
    cfg, inp = _inputs(8)
    ref = batch_vb.reference_steps(cfg, {"algorithm": "dsvb"}, inp, [1],
                                   torch.float64, "cpu")[0]
    bad = ref.clone()
    bad[N - N // 10:] *= 1.0 + 1e-4    # the last tenth of the nodes
    assert gmm_vb.median_gap(bad, ref, 3, 2) == 0.0
    assert gmm_vb.tail_gap(bad, ref, 3, 2) > 5e-5
