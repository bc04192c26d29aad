"""Why a serving fleet issues the dense combine's product slot by slot.

    python3 tools/fleet_vs_solo_probe.py

On a CUDA card (f64, no TF32): (1) for the Eq. 47 weights W and the 0/1
adjacency of `random_geometric_graph(1000, seed=0)` and S = 1, 4, 8
random (S, 1000, 27) stacks, whether each batched form of the product
(the folded `matmul`, `bmm` over an expanded matrix, `matmul` over it,
`einsum`, one wide GEMM over the slots' columns) equals the solo
(N, N) @ (N, P) product slot by slot, and whether a batch-1 `bmm` does;
(2) the fleet's Normal-Wishart projection against a solo one, per slot;
(3) eight Diffusion tenants (the paper's instance, 1000 sensors x 4096
points, seeds 0-7, tau 0.2, fused backend, f64 iterates) served one
iteration a slice, against their solo sessions: each iteration the
largest relative difference over the slots and how many slots are
bit-equal, with the fleet's product issued slot by slot
(`engine._dense_apply`, the shipped form) and folded into one batched
product.  Prints one JSON line per measurement and the card's name and
power limit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import engine, expfam, network  # noqa: E402
from repro_torch.core.model import GMMModel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import vb_service  # noqa: E402

N, P, S = 1000, 27, 8
MARKS = (1, 2, 5, 10, 20, 50, 100, 150, 200)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def product_forms(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    adj, _ = network.random_geometric_graph(N, seed=0)
    mats = {"W": network.nearest_neighbor_weights(adj).to(dev),
            "adj": adj.to(dev)}
    for name, M in mats.items():
        for s in (1, 4, 8):
            vf = torch.randn(s, N, P, dtype=torch.float64, device=dev,
                             generator=g)
            solo = [M @ vf[i] for i in range(s)]
            forms = {
                "matmul_fold": M @ vf,
                "bmm_expand": torch.bmm(M.expand(s, N, N), vf),
                "matmul_expand": torch.matmul(M.expand(s, N, N), vf),
                "einsum": torch.einsum("ij,sjp->sip", M, vf),
                "one_wide_gemm": (M @ vf.transpose(0, 1).reshape(
                    N, s * P)).reshape(N, s, P).transpose(0, 1),
                "bmm_batch1": torch.stack([torch.bmm(
                    M[None], vf[i:i + 1])[0] for i in range(s)]),
                "slot_by_slot": engine._dense_apply(M, vf)}
            emit(probe="product", matrix=name, slots=s, equal_to_solo={
                f: [bool(torch.equal(out[i], solo[i])) for i in range(s)]
                for f, out in forms.items()})
    prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                        dtype=torch.float64, device=dev)
    mdl = GMMModel(prior, 3, 2, device=dev)
    phi = mdl.init_phi().expand(S, N, mdl.flat_dim) + 0.3 * torch.randn(
        S, N, mdl.flat_dim, dtype=torch.float64, device=dev, generator=g)
    fleet = mdl.project_to_domain(phi)
    emit(probe="projection", equal_to_solo=[
        bool(torch.equal(fleet[i], mdl.project_to_domain(phi[i])))
        for i in range(S)])


def drift(dev, form: str):
    adj, _ = network.random_geometric_graph(N, seed=0)
    W = network.nearest_neighbor_weights(adj)
    prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0,
                                        dtype=torch.float64, device=dev)
    mdl = GMMModel(prior, 3, 2, backend="fused", device=dev)
    data = []
    for s in range(S):
        d = synthetic.paper_synthetic(n_nodes=N, n_per_node=4096, seed=s,
                                      dtype=np.float32)
        data.append((d.x.to(dev), d.mask.to(dev)))
    # the main path's start: the prior with its means spread over the
    # data's range (chip_smoke.py's _instance)
    u = np.random.default_rng(0).uniform(size=(3, 2))
    x0 = data[0][0].reshape(-1, 2)
    lo, hi = x0.amin(0), x0.amax(0)
    q0 = prior._replace(m=(lo + (hi - lo) * torch.tensor(
        u, dtype=torch.float32, device=dev)).double())
    phi0 = expfam.pack_natural(q0).expand(N, mdl.flat_dim)
    sched, topo = engine.Schedule(tau=0.2), engine.Diffusion(W)
    shipped = engine._dense_apply
    if form == "folded":
        engine._dense_apply = lambda M, z: M @ z
    try:
        svc = vb_service.VBService(slice_iters=1, max_fleet=S, device=dev)
        for d in data:
            svc.submit(vb_service.VBRequest(
                model=mdl, data=d, topology=topo, n_iters=max(MARKS),
                init_phi=phi0, schedule=sched))
        solos = [engine.vb_init(mdl, d, topo, init_phi=phi0,
                                schedule=sched, diagnostics=False,
                                device=dev) for d in data]
        for it in range(1, max(MARKS) + 1):
            svc.step_slice()
            (g,) = svc._groups.values()
            # a solo session's (N, P) product is `M @ z` in either form
            solos = [engine.vb_step(s) for s in solos]
            if it in MARKS:
                rel = [float((g.phi[i] - solos[i].phi).abs().max()
                             / solos[i].phi.abs().max()) for i in range(S)]
                emit(probe="drift", product=form, iteration=it,
                     max_rel=max(rel), bit_equal_slots=sum(
                         bool(torch.equal(g.phi[i], solos[i].phi))
                         for i in range(S)))
    finally:
        engine._dense_apply = shipped


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fleet_vs_solo_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    product_forms(dev)
    for form in ("slot_by_slot", "folded"):
        drift(dev, form)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
