"""The port's consensus training steps (diffusion, ADMM, adaptive-rho
ADMM) on 4 gloo ranks against the reference on a 1-D 4-device host mesh
in a subprocess (`("data",)`, the mesh its own
`test_admm_adaptive_rho_is_dynamic_state` runs on; never the 2-D mesh of
ROADMAP R2).  The f32 yi_6b smoke config, the reference's initial
parameters carried to every rank, three steps on the same global batches
on the port's (4, 1) ("data", "model") mesh (replica r takes rows 2r,
2r+1, as the reference's batch sharding does).

Bars: each replica's parameters at 1e-4 relative L2 error per tensor
(tests/test_torch_lm_train.py's reason), the rho trajectory equal, the
averaged metrics (loss, ce, grad_norm, lr) at 1e-5 relative, the global
ADMM residual norms and rank 0's `consensus_residual` (each rank's own:
the reference's replicated output is its first device's) at 1e-4.  Both
sides start at once: the reference's subprocess and the ranks run in
parallel."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.training import train_step as jts
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from test_torch_mesh_collectives import REPO, launch_ranks

WORLD, STEPS, BATCH, SEQ = 4, 3, 8, 32
HYPER = "peak_lr=1e-3, warmup=2, total_steps=10"
CASES = (("diffusion", "diffusion", ""), ("admm", "admm", ""),
         ("adaptive", "admm", "adaptive_rho=True, rho_mu=0.5"))
CASES_SRC = repr(CASES)

REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.dist import compat
from repro.training import train_step as ts
cfg = get_smoke_config("yi_6b")
mesh = jax.make_mesh((4,), ("data",))
inp = dict(np.load(sys.argv[1]))
out = {}
for name, mode, kw in CASES:
    hyper = eval(f"ts.TrainHyper(HYPER, {kw})")
    with compat.use_mesh(mesh):
        state = ts.init_state(cfg, jax.random.PRNGKey(0), dp_mode=mode,
                              n_replicas=4, hyper=hyper)
        state = jax.device_put(state, ts.state_shardings(
            state, cfg, mesh, dp_mode=mode, consensus_axis="data"))
        fn = jax.jit(ts.make_train_step(cfg, mesh, dp_mode=mode,
                                        consensus_axis="data", hyper=hyper))
        for i in range(STEPS):
            b = jax.device_put({"tokens": jnp.asarray(inp[f"tokens{i}"])},
                               ts.batch_sharding(mesh))
            state, m = fn(state, b)
            for k, v in m.items():
                out[f"{name}/m{i}/{k}"] = np.asarray(v)
            if state.rho is not None:
                out[f"{name}/rho{i}"] = np.asarray(state.rho)
    for p, a in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        out[f"{name}/params" + jax.tree_util.keystr(p)] = np.asarray(a)
np.savez(sys.argv[2], **out)
'''.replace("CASES", CASES_SRC).replace("HYPER", HYPER).replace(
    "STEPS", str(STEPS))

PORT = r'''
from repro_torch.configs.base import get_smoke_config
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.training import train_step as ts
cfg = get_smoke_config("yi_6b")
MESH = mesh_lib.make_test_mesh(WORLD, 1, device="cpu")
init = {k[5:]: v for k, v in INPUTS.items() if k.startswith("init/")}
for name, mode, kw in CASES:
    hyper = eval(f"ts.TrainHyper(HYPER, {kw})")
    params = ts.train_state_from_arrays(cfg, init, device="cpu").params
    state = ts.init_state(cfg, dp_mode=mode, hyper=hyper, params=params,
                          mesh=MESH, consensus_axis="data")
    step = ts.make_train_step(cfg, MESH, dp_mode=mode,
                              consensus_axis="data", hyper=hyper)
    for i in range(STEPS):
        # the global batch: the step takes the replica's rows
        batch = ts.batch_to({"tokens": INPUTS[f"tokens{i}"]}, "cpu")
        state, m = step(state, batch)
        for k, v in m.items():
            put((f"rank/{name}/m{i}/{k}" if k == "consensus_residual"
                 else f"{name}/m{i}/{k}"), v)
        if state.rho is not None:
            put(f"{name}/rho{i}", state.rho)
    assert state.step == STEPS
    for n, p in adamw.named(state.params).items():
        put(f"rank/{name}/params/{n}", sharding.full(p))

# admm_residual_norms gives admm_step's norms from the same iterates
import torch
from repro_torch.optim import consensus
g = torch.Generator().manual_seed(RANK)
prev = {"a": torch.randn(5, 3, generator=g),
        "b": torch.randn(7, generator=g).bfloat16()}
star = {k: v + 0.1 * torch.randn(v.shape, generator=g).to(v.dtype)
        for k, v in prev.items()}
new, _, norms = consensus.admm_step(
    {k: v.clone() for k, v in star.items()}, prev,
    consensus.admm_init_duals(prev), EX, rho=torch.tensor(0.7), kappa=0.3,
    return_residuals=True)
put("admm_step_norms", torch.stack(norms))
put("residual_norms", torch.stack(consensus.admm_residual_norms(
    new, prev, EX, rho=torch.tensor(0.7))))

# a consensus Trainer's checkpoint: the replicas gathered, the mesh's
# first rank writes, every rank restores its own replica
from repro_torch.training.trainer import Trainer
kw = dict(dp_mode="admm", global_batch=8, seq_len=16, device="cpu",
          ckpt_dir=os.path.join(os.path.dirname(os.environ["MESH_OUT"]),
                                "ckpt"))
a = Trainer(cfg, MESH, **kw)
a.run(2, log_every=1)
path = a.save(2)
assert (path is not None) == (RANK == 0)
b = Trainer(cfg, MESH, seed=1, **kw)
b.restore(2)
assert b.state.step == 2 and float(b.state.rho) == float(a.state.rho)
full = sharding.full
same = all(torch.equal(full(x), full(y)) for x, y in zip(
    a.state.params.parameters(), b.state.params.parameters()))
same &= all(torch.equal(full(a.state.duals[k]), full(b.state.duals[k]))
            for k in a.state.duals)
same &= all(torch.equal(full(a.state.opt.nu[k]), full(b.state.opt.nu[k]))
            for k in a.state.opt.nu)
put("restored_equal", same)
'''.replace("CASES", CASES_SRC).replace("HYPER", HYPER).replace(
    "STEPS", str(STEPS)).replace("BATCH", str(BATCH))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference arrays, rank 0's arrays with every rank's) from the two
    runs, started together."""
    work = tmp_path_factory.mktemp("lm_consensus")
    cfg = jbase.get_smoke_config("yi_6b")
    state = jts.init_state(cfg, jax.random.PRNGKey(0))
    inputs = {"init/" + jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(state)[0]}
    batcher = jtokens.Batcher(cfg.vocab_size, BATCH, SEQ, seed=0)
    for i in range(STEPS):
        inputs[f"tokens{i}"] = batcher.next_batch()["tokens"]
    ref_in, ref_out = str(work / "ref_in.npz"), str(work / "ref_out.npz")
    np.savez(ref_in, **{k: v for k, v in inputs.items()
                        if k.startswith("tokens")})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, ref_in,
                            ref_out], cwd=REPO, env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ranks = launch_ranks(PORT, WORLD, work / "ranks", inputs=inputs)
    try:
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, out + err
    return dict(np.load(ref_out)), ranks.result()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_replicas_match_reference(runs, case):
    want, got = runs
    prefix = f"{case}/params"
    stacked = {k[len(prefix):]: v for k, v in want.items()
               if k.startswith(prefix)}
    assert stacked
    for r, rank in enumerate(got["ranks"]):
        want_r = ckpt._lm_named(tbase.get_smoke_config("yi_6b"), stacked,
                                replica=r)
        names = [k[len(f"rank/{case}/params/"):] for k in rank
                 if k.startswith(f"rank/{case}/params/")]
        assert sorted(names) == sorted(want_r)
        for n in names:
            assert _rel(rank[f"rank/{case}/params/{n}"], want_r[n]) <= 1e-4, \
                (r, n)


def test_residual_norms_and_trainer_checkpoint(runs):
    """`admm_residual_norms` equals `admm_step`'s norms on 4 ranks; a
    consensus Trainer's checkpoint restores every rank's replica, its
    moments, duals and rho bit for bit."""
    _, got = runs
    np.testing.assert_allclose(got["residual_norms"], got["admm_step_norms"],
                               rtol=1e-6)
    assert float(got["admm_step_norms"][0]) > 0
    assert bool(got["restored_equal"])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_metrics_and_rho_match_reference(runs, case):
    want, got = runs
    rhos = []
    for i in range(STEPS):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert float(got[f"{case}/m{i}/{k}"]) == pytest.approx(
                float(want[f"{case}/m{i}/{k}"]), rel=1e-5), (i, k)
        for k in ("admm_primal_resid", "admm_dual_resid"):
            assert float(got[f"{case}/m{i}/{k}"]) == pytest.approx(
                float(want[f"{case}/m{i}/{k}"]), rel=1e-4, abs=1e-12), (i, k)
        assert float(got["ranks"][0][f"rank/{case}/m{i}/consensus_residual"]
                     ) == pytest.approx(
            float(want[f"{case}/m{i}/consensus_residual"]), rel=1e-4)
        assert float(got[f"{case}/m{i}/admm_rho"]) == float(
            want[f"{case}/m{i}/admm_rho"])
        if case != "diffusion":
            assert float(got[f"{case}/rho{i}"]) == float(
                want[f"{case}/rho{i}"])
            rhos.append(float(got[f"{case}/rho{i}"]))
    # plain ADMM keeps rho; the balancing rule moves it
    if case == "admm":
        assert rhos == [0.5] * STEPS
    if case == "adaptive":
        assert any(r != 0.5 for r in rhos), rhos
