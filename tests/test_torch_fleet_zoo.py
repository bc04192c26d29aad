"""HMM and PPCA fleets through the port's `VBService`, on the CPU (the
reference's tests/test_model_zoo.py serving cases): sessions of mixed
capacity on one ladder rung share one fleet group stepped at one shape
(`compiles == 1`), and each tenant is bit-equal to the port's solo
`run_vb` of the same length (6 nodes, f64, 8 iterations in slices of 4).
The serving stack needs no model-specific code."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine, network
from repro_torch.models import hmm, ppca
from repro_torch.serving.vb_service import VBRequest, VBService

K, D_HMM, N_NODES = 3, 2, 6
D_PPCA, Q = 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (see tests/test_torch_vb_driver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet_vs_solo(mdl, datasets, topo, init_phi=None):
    svc = VBService(slice_iters=4, max_fleet=4, device="cpu")
    rids = [svc.submit(VBRequest(model=mdl, data=d, topology=topo,
                                 n_iters=8, init_phi=init_phi))
            for d in datasets]
    out = svc.run()
    assert len(svc._groups) == 1 and svc.stats().compiles == 1
    for d, rid in zip(datasets, rids):
        solo = engine.run_vb(mdl, d, topo, n_iters=8, init_phi=init_phi,
                             device="cpu")
        assert out[rid].t == 8
        assert torch.equal(solo.phi, out[rid].phi), rid


def test_mixed_capacity_hmm_sessions_share_fleet():
    """Chain counts 9 and 10 round to one rung; Diffusion (Metropolis
    weights)."""
    prior = hmm.noninformative_prior(K, D_HMM, beta0=0.1, w0_scale=10.0)
    mdl = hmm.HMMModel(prior, device="cpu")
    adj, _ = network.random_geometric_graph(N_NODES, seed=3)
    datasets = [hmm.sample_chains(N_NODES, chains, 8, K=K, D=D_HMM,
                                  seed=10 + i)[:2]
                for i, chains in enumerate([9, 10])]
    _fleet_vs_solo(mdl, datasets,
                   engine.Diffusion(network.metropolis_weights(adj)))


def test_mixed_capacity_ppca_sessions_share_fleet():
    """21 and 29 points round to rung 32; RingDiffusion, a perturbed
    start."""
    mdl = ppca.PPCAModel(ppca.prior(D_PPCA, Q), device="cpu")
    noise = np.random.default_rng(5).normal(size=(D_PPCA, Q))
    phi0 = mdl.pack(ppca.perturbed_init(mdl.prior, noise)).expand(
        N_NODES, -1).clone()
    datasets = [ppca.sample_sensors(N_NODES, t, D=D_PPCA, Q=Q,
                                    seed=20 + i)[:2]
                for i, t in enumerate([21, 29])]
    _fleet_vs_solo(mdl, datasets, engine.RingDiffusion(), phi0)
