"""The device generator draws the paper's Sec. V-A distribution: per-node
mixture proportions and per-component moments agree with the program's
host generator (`repro_torch.data.synthetic.paper_synthetic`) within
sampling error at a small size."""
from __future__ import annotations

import numpy as np
import torch

from vbbench import harness
from vbbench.data import synth

N, T = 50, 2000


def _cfg():
    return harness.cell("k3d2_100k.dsvb")["config"]


def test_mixture_and_moments_match_the_host_generator():
    from repro_torch.data.synthetic import paper_synthetic
    cfg = _cfg()
    x, mask, lab = synth.sensor_data(cfg, N, T, "cpu", 2**31 + 99,
                                     labels=True, chunk=16)
    host = paper_synthetic(N, T, seed=3, dtype=np.float64)
    assert x.shape == (N, T, 2) and x.dtype == torch.float32
    assert bool((mask == 1).all())
    hx, hlab = host.x.double(), host.labels.long()
    # per node, each component's share: binomial error sqrt(p (1-p) / T)
    for k in range(3):
        mine = (lab == k).double().mean(1)
        theirs = (hlab == k).double().mean(1)
        p = theirs.clamp(0.02, 0.98)
        tol = 5.0 * torch.sqrt(2.0 * p * (1 - p) / T)
        assert bool(((mine - theirs).abs() <= tol).all()), k
    # each component's mean and covariance over all points
    for k in range(3):
        a = x.double()[lab == k]
        b = hx[hlab == k]
        n = min(len(a), len(b))
        assert n > 5000
        se = 5.0 * np.sqrt(0.6 / n)
        assert torch.allclose(a.mean(0), b.mean(0), atol=se)
        ca, cb = torch.cov(a.T), torch.cov(b.T)
        assert torch.allclose(ca, cb, atol=10.0 * 0.6 / np.sqrt(n))


def test_same_seed_same_arrays_other_seed_other_arrays():
    cfg = _cfg()
    a = synth.sensor_data(cfg, 20, 64, "cpu", 7, 1)
    b = synth.sensor_data(cfg, 20, 64, "cpu", 7, 1, chunk=3)
    c = synth.sensor_data(cfg, 20, 64, "cpu", 8, 1)
    assert torch.equal(a[0], synth.sensor_data(cfg, 20, 64, "cpu", 7, 1)[0])
    assert not torch.equal(a[0], c[0])
    # the chunk size changes the draw order, not the distribution
    assert b[0].shape == a[0].shape
    assert synth.mix_seed(2**31 + 5) != synth.mix_seed(2**31 + 6)
    assert 0 <= synth.mix_seed(2**40, 3) < 2**63


def test_graph_links_are_the_radius_rule():
    cfg = dict(_cfg(), side=5.0, comm_radius=1.1)
    u, v = synth.graph_edges(cfg, 200, "cpu", 11, chunk=37)
    gen = synth.generator("cpu", 11)
    pos = torch.rand(200, 2, generator=gen, dtype=torch.float64) * 5.0
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    i, j = torch.triu(d2 <= 1.1 ** 2, 1).nonzero(as_tuple=True)
    assert torch.equal(u, i) and torch.equal(v, j)
