"""The port stands alone: no jax, no repro; the card unless told otherwise;
the one fallback is the reference's (a backend that cannot run a model
warns and runs the reference backend); unported options raise, and the
ones ported since run."""
import warnings
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import telemetry
from repro_torch.core import algorithms, backends, blocks, engine, expfam
from repro_torch.core import network
from repro_torch.core import model as model_lib
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import model as lm_lib
from repro_torch.serving import engine as lm_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_repro():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for m in ("repro_torch.kernels.gmm_estep",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ssd_scan", "repro_torch.models.model",
              "repro_torch.models.mamba2", "repro_torch.serving.engine",
              "repro_torch.launch.serve", "repro_torch.configs.yi_6b",
              "repro_torch.core.linreg", "repro_torch.data.datasets",
              "repro_torch.experiments.common",
              "repro_torch.experiments.paper_figures",
              "repro_torch.experiments.streaming",
              "repro_torch.data.stream", "repro_torch.models.hmm",
              "repro_torch.models.ppca", "repro_torch.core.network",
              "repro_torch.checkpoint.ckpt",
              "repro_torch.experiments.topology_scale",
              "repro_torch.serving.admission", "repro_torch.serving.driver",
              "repro_torch.serving.vb_service",
              "repro_torch.launch.vb_serve", "repro_torch.telemetry",
              "repro_torch.telemetry.metrics",
              "repro_torch.telemetry.tracing",
              "repro_torch.telemetry.taps", "repro_torch.dist",
              "repro_torch.dist.collectives", "repro_torch.dist.sharding",
              "repro_torch.core.distributed", "repro_torch.models.moe",
              "repro_torch.models.rglru", "repro_torch.data.tokens",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.schedules", "repro_torch.optim.consensus",
              "repro_torch.training.train_step",
              "repro_torch.training.trainer", "repro_torch.launch.train",
              "repro_torch.launch.mesh", "repro_torch.models.layers",
              "repro_torch.models.kernel_adapters"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")


def test_no_raise_names_item_16():
    """The LM sharding (ROADMAP Queue 1 item 16, steps 1-3) is ported: no
    `raise` in the port names the item any more."""
    import ast
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            src = open(os.path.join(dirpath, f)).read()
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.Raise):
                    seg = ast.get_source_segment(src, node) or ""
                    assert "item 16" not in seg, (f, seg)


def test_launch_train_host_devices():
    """`launch.train --host_devices 4` starts four gloo ranks itself and
    trains on a (2, 2) mesh."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi_6b",
         "--smoke", "--steps", "2", "--host_devices", "4", "--data_axis",
         "2", "--model_axis", "2", "--device", "cpu", "--seq_len", "16",
         "--global_batch", "4", "--log_every", "1"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert [ln.split()[:2] for ln in lines] == [["step", "1"], ["step", "2"]]


def _tiny():
    prior = expfam.noninformative_prior(3, 2, beta0=0.1, w0_scale=10.0)
    x = torch.zeros(4, 10, 2, dtype=torch.float64)
    mask = torch.ones(4, 10, dtype=torch.float64)
    return prior, x, mask


def test_default_device_is_cuda(monkeypatch):
    """Without a card, entry points called without device= raise; the CPU
    runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prior, x, mask = _tiny()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        model_lib.GMMModel(prior)
    mdl = model_lib.GMMModel(prior, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        engine.run_vb(mdl, (x, mask), engine.FusionCenter(), n_iters=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        algorithms.run_cvb(x, mask, prior, n_iters=1, K=3, D=2)
    run = engine.run_vb(mdl, (x, mask), engine.FusionCenter(), n_iters=1,
                        device="cpu")
    assert run.phi.device.type == "cpu"


def test_vb_service_defaults_to_cuda(monkeypatch):
    """`VBService` / `VBDriver` and the `vb_serve` launcher run on the
    card unless given device="cpu"; a fleet never moves to the CPU on its
    own, and an executor that is not a `dist.MeshExecutor` raises."""
    from repro_torch.launch import vb_serve
    from repro_torch.serving import driver, vb_service

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vb_service.VBService()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        driver.VBDriver()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vb_serve.main(["--sessions", "1", "--budgets", "2"])
    with pytest.raises(TypeError, match="MeshExecutor"):
        vb_service.VBService(executor=object(), device="cpu")
    prior, x, mask = _tiny()
    svc = vb_service.VBService(slice_iters=2, device="cpu")
    rid = svc.submit(vb_service.VBRequest(
        model=model_lib.GMMModel(prior, device="cpu"), data=(x, mask),
        topology=engine.RingDiffusion(), n_iters=2))
    out = svc.run()[rid]
    assert out.done and out.phi.device.type == "cpu"
    vb_serve.main(["--device", "cpu", "--sessions", "2", "--budgets",
                   "3", "--nodes", "4", "--per-node", "6", "--slice", "2"])


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """The LM entry points (`init_params`/`LM`, `Engine`, `init_cache`)
    raise without a card unless given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("yi_6b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm_lib.init_params(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm_lib.LM(cfg)
    params = lm_lib.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm_engine.Engine(cfg, params)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm_lib.init_cache(cfg, 1, 8)
    e = lm_engine.Engine(cfg, params, device="cpu", max_seq=12)
    out = e.generate([lm_engine.Request(np.arange(4, dtype=np.int32), 2)])
    assert out[0].shape == (6,)
    # training: the state, the trainer and the launcher
    from repro_torch.launch import train
    from repro_torch.training import train_step, trainer
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_step.init_state(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trainer.Trainer(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train.main(["--arch", "yi_6b", "--smoke", "--steps", "1"])
    tr = trainer.Trainer(cfg, device="cpu", global_batch=2, seq_len=8)
    tr.run(1)
    assert tr.state.params.device.type == "cpu"


class _OtherModel(blocks.BlockModel):
    """A conjugate-exponential model the fused GMM kernel cannot run."""

    def __init__(self):
        self.prior = np.zeros(3)
        self.blocks = (blocks.DirichletBlock(3),)

    def split_hyper(self, q):
        return (q[None],)

    def join_hyper(self, parts):
        return parts[0][0]

    def local_optimum(self, data, phi_nodes, replication):
        return phi_nodes


def test_fused_backend_on_unsupported_model_falls_back():
    """backend="fused" on a model the kernel cannot run warns once per
    (backend, model type), "falling back to the reference backend", and
    gives the reference backend's result."""
    prior, x, mask = _tiny()

    def check(model, data, phi0=None):
        telemetry.reset()          # the warn-once keys
        want = engine.run_vb(model, data, engine.Isolated(), n_iters=2,
                             init_phi=phi0, backend="reference",
                             device="cpu")
        with pytest.warns(UserWarning, match="falling back to the "
                                             "reference backend"):
            got = engine.run_vb(model, data, engine.Isolated(), n_iters=2,
                                init_phi=phi0, backend="fused", device="cpu")
        assert torch.equal(got.phi, want.phi)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            engine.vb_init(model, data, engine.Isolated(), init_phi=phi0,
                           backend="fused", device="cpu")

    check(_OtherModel(), (x, mask), torch.zeros(4, 3))
    # the port's PPCA has no fused kernel (the kernel is the GMM E-step)
    from repro_torch.models import ppca
    pp = ppca.PPCAModel(ppca.prior(4, 2), device="cpu")
    assert not backends.FusedBackend().supports(pp)
    px, pmask = ppca.sample_sensors(2, 6, D=4, Q=2, seed=1)[:2]
    noise = np.random.default_rng(0).normal(size=(4, 2))
    check(pp, (px, pmask), pp.pack(ppca.perturbed_init(
        pp.prior, noise)).expand(2, -1).clone())
    # a GMM past the first wide kernel's shared memory (K > 12 at D = 64)
    # now has its fused kernel
    assert backends.FusedBackend().supports(model_lib.GMMModel(
        expfam.noninformative_prior(13, 64), device="cpu"))
    # the Normal-Gamma instance has no fused backend
    lin = model_lib.LinRegModel(D=2, device="cpu")
    check(lin, torch.randn(2, lin.flat_dim, dtype=torch.float64),
          torch.zeros(2, lin.flat_dim, dtype=torch.float64))
    assert backends.FusedBackend().supports(
        model_lib.GMMModel(prior, device="cpu"))


@pytest.mark.parametrize("K,D", [(13, 64), (2, 110)])
def test_fused_backend_runs_past_the_first_wide_limit(K, D):
    """backend="fused" runs a GMM past the first wide kernel's shared
    memory (K = 13 at D = 64; D >= 108) without the fallback warning, and
    matches backend="reference" at 1e-4 (2 nodes, a handful of points, 3
    iterations; on the CPU the fused backend runs the kernel's plain
    version)."""
    rng = np.random.default_rng(K + D)
    prior = expfam.noninformative_prior(K, D, beta0=0.05, w0_scale=5.0)
    x = torch.tensor(rng.normal(size=(2, 9, D)), dtype=torch.float64)
    mask = torch.ones(2, 9, dtype=torch.float64)
    init_q = algorithms.perturbed_init(prior, x, rng.uniform(size=(K, D)))
    runs = {}
    telemetry.reset()
    for be in ("fused", "reference"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            runs[be] = algorithms.run_dsvb(
                x, mask, torch.full((2, 2), 0.5), prior, n_iters=3, K=K,
                D=D, init_q=init_q, backend=be, device="cpu")
    torch.testing.assert_close(runs["fused"].phi, runs["reference"].phi,
                               rtol=1e-4, atol=1e-4)


def test_unported_options_raise():
    prior, x, mask = _tiny()
    mdl = model_lib.GMMModel(prior, device="cpu")
    adj = torch.ones(4, 4) - torch.eye(4)
    # item 14 (the mesh executor) is ported: only a MeshExecutor is one
    with pytest.raises(TypeError, match="MeshExecutor"):
        engine.vb_init(mdl, (x, mask), engine.Isolated(), executor=object(),
                       device="cpu")
    # item 11 (sparse topologies) is ported: its options run
    g = network.SparseGraph.from_dense(adj)
    gw, rg = network.two_level_partition(4, 2, 1)
    for topo in (engine.RingDiffusion(graph=network.SparseGraph.ring(4)),
                 engine.Diffusion(network.sparse_nearest_neighbor_weights(g)),
                 engine.PairwiseGossip(g, p_activate=0.5),
                 engine.HierarchicalFusion(gw, rg),
                 engine.ADMMConsensus(g),
                 engine.ADMMConsensus(g, adaptive_rho=True)):
        run = engine.run_vb(mdl, (x, mask), topo, n_iters=2, device="cpu")
        assert bool(torch.isfinite(run.phi).all()), type(topo).__name__
    with pytest.raises(ValueError, match="SparseGraph.ring"):
        engine.RingDiffusion(graph=g)
    with pytest.raises(ValueError, match="natural-gradient"):
        engine.vb_init(mdl, (x, mask), engine.ADMMConsensus(adj),
                       schedule=engine.ONE_SHOT, device="cpu")
