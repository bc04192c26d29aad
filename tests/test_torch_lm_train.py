"""The port's LM training path against the JAX package, on the CPU, in the
f32 smoke configs with the JAX state carried across
(`checkpoint.ckpt.train_state_from_arrays`): the token pipeline
(`Batcher` arrays bit-equal), the schedules and AdamW (1e-6 relative over
three updates), `loss_fn` and its gradients against `jax.value_and_grad`,
three `allreduce` steps for every arch (loss and metrics at 1e-5
relative, each parameter tensor at 1e-4 relative L2 error: AdamW divides
by the root of the second moment, so an entry whose gradient is at
rounding level moves by up to lr whatever the gradient's digits, and no
per-entry bar holds there; the moments at 1e-3), the reference's
`test_loss_decreases` on the port, the `Trainer` checkpoint round trip and
a reference `Trainer` checkpoint restored, and the launcher.  One jitted
JAX function per arch returns the loss, the gradients and the stepped
state, so each arch compiles once."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import tokens as jtokens
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro.training import train_step as jts
from repro.training.trainer import Trainer as JTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens
from repro_torch.optim import adamw, schedules
from repro_torch.training import train_step as ts
from repro_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER = dict(peak_lr=1e-3, warmup=2, total_steps=10)
STEPS, BATCH, SEQ = 3, 4, 32
METRIC_RTOL = 1e-5
PARAM_RTOL = 1e-4
# tests/test_training_serving.py's tiny config
TINY = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want) -> float:
    """Relative L2 error."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _params_close(cfg, lm_or_named, jax_params, rtol=PARAM_RTOL):
    want = ckpt._lm_named(cfg, _arrays(jax_params))
    got = adamw.named(lm_or_named)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert _rel(t.detach().numpy(), want[name]) <= rtol, name


# ---------------------------------------------------------------------------
# Token pipeline, schedules, AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frontend_len", [0, 5])
def test_batcher_bit_equal(frontend_len):
    kw = dict(seed=3, frontend_len=frontend_len, d_model=16)
    a = tokens.Batcher(97, 3, 20, **kw)
    b = jtokens.Batcher(97, 3, 20, **kw)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_schedules():
    for step in range(0, 70, 3):
        got = schedules.cosine_warmup(step, peak_lr=3e-3, warmup=5,
                                      total=60)
        want = jschedules.cosine_warmup(jnp.int32(step), peak_lr=3e-3,
                                        warmup=5, total=60)
        assert got == pytest.approx(float(want), rel=1e-6, abs=1e-12)
    for t in (1.0, 7.0, 100.0):
        assert schedules.kappa(np.float32(t), 0.05) == pytest.approx(
            float(jschedules.kappa(jnp.float32(t), 0.05)), rel=1e-6)
        assert schedules.eta(t, 0.5) == pytest.approx(
            float(jschedules.eta(t, 0.5)), rel=1e-12)


def test_adamw_and_clip():
    """Three AdamW updates of an f32 and a bf16 leaf with clipped
    gradients, against the reference at 1e-6 relative (bf16: one ulp of
    the stored parameter)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    jp = {"a": jnp.asarray(p0["a"]), "b": jnp.asarray(p0["b"],
                                                      jnp.bfloat16)}
    tp = {"a": torch.tensor(p0["a"]),
          "b": torch.tensor(p0["b"]).bfloat16()}
    jst, tst = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * 3 for k, s in
             shapes.items()}
        jg, norm = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}, 1.0)
        tg, tnorm = adamw.clip_by_global_norm(
            {k: torch.tensor(v).to(tp[k].dtype) for k, v in g.items()}, 1.0)
        assert float(tnorm) == pytest.approx(float(norm), rel=1e-6)
        lr = schedules.cosine_warmup(i + 1, peak_lr=1e-2, warmup=2, total=5)
        jp, jst = jadamw.update(jg, jst, jp, lr=jnp.float32(lr))
        tp, tst = adamw.update(tg, tst, tp, lr=lr)
        assert tst.count == int(jst.count) == i + 1
        for k in shapes:
            assert tp[k].dtype == {"a": torch.float32,
                                   "b": torch.bfloat16}[k]
            assert tst.mu[k].dtype == tst.nu[k].dtype == torch.float32
            for got, want in ((tst.mu[k], jst.mu[k]), (tst.nu[k],
                                                       jst.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12)
            rtol = 1e-6 if k == "a" else 2 ** -7
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=rtol)
    assert float(adamw.global_norm(tp)) == pytest.approx(
        float(jadamw.global_norm(jp)), rel=1e-6)


# ---------------------------------------------------------------------------
# loss_fn, its gradients and three allreduce steps, every arch
# ---------------------------------------------------------------------------
def _reference_run(arch):
    """The reference's loss, gradients and stepped state over STEPS
    batches, from one jitted function."""
    cfg = jbase.get_smoke_config(arch)
    hyper = jts.TrainHyper(**HYPER)
    state = jts.init_state(cfg, jax.random.PRNGKey(0), hyper=hyper)
    step_fn = jts.make_train_step(cfg, None, hyper=hyper)

    @jax.jit
    def fn(state, batch):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jts.loss_fn(cfg, p, batch), has_aux=True)(
                state.params)
        new, metrics = step_fn(state, batch)
        return loss, aux, grads, new, metrics

    batcher = jtokens.Batcher(cfg.vocab_size, BATCH, SEQ, seed=0,
                              frontend_len=cfg.frontend_len,
                              d_model=cfg.d_model)
    first = _arrays(state)
    batches, outs = [], []
    for _ in range(STEPS):
        batch = batcher.next_batch()
        loss, aux, grads, state, metrics = fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        batches.append(batch)
        outs.append({"loss": float(loss), "aux": aux, "grads": grads,
                     "metrics": {k: float(v) for k, v in metrics.items()}})
    return cfg, first, batches, outs, state


@pytest.fixture(scope="module", params=jbase.ARCH_IDS)
def run(request):
    return request.param, _reference_run(request.param)


def test_loss_and_grads(run):
    arch, (cfg, first, batches, outs, _) = run
    tcfg = tbase.get_smoke_config(arch)
    state = ts.train_state_from_arrays(tcfg, first, device="cpu")
    batch = ts.batch_to(batches[0], "cpu")
    loss, aux = ts.loss_fn(tcfg, state.params, batch)
    named = adamw.named(state.params)
    grads = torch.autograd.grad(loss, list(named.values()))
    assert float(loss.detach()) == pytest.approx(outs[0]["loss"],
                                                 rel=METRIC_RTOL)
    for k in ("ce", "aux"):
        assert float(aux[k]) == pytest.approx(float(outs[0]["aux"][k]),
                                              rel=METRIC_RTOL, abs=1e-7)
    want = ckpt._lm_named(tcfg, _arrays(outs[0]["grads"]))
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_allreduce_steps(run):
    arch, (cfg, first, batches, outs, final) = run
    tcfg = tbase.get_smoke_config(arch)
    state = ts.train_state_from_arrays(tcfg, first, device="cpu")
    step = ts.make_train_step(tcfg, hyper=ts.TrainHyper(**HYPER))
    for batch, out in zip(batches, outs):
        state, metrics = step(state, ts.batch_to(batch, "cpu"))
        assert sorted(metrics) == sorted(out["metrics"])
        for k, v in metrics.items():
            assert float(v) == pytest.approx(out["metrics"][k],
                                             rel=METRIC_RTOL, abs=1e-12), k
    assert state.step == STEPS and state.opt.count == STEPS
    _params_close(tcfg, state.params, final.params)
    for field in ("mu", "nu"):
        _params_close(tcfg, getattr(state.opt, field),
                      getattr(final.opt, field), rtol=1e-3)


def test_use_kernels_with_gradients_raises():
    cfg = tbase.get_smoke_config("yi_6b")
    state = ts.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = ts.batch_to(tokens.Batcher(cfg.vocab_size, 2, 16).next_batch(),
                        "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        ts.loss_fn(cfg, state.params, batch, use_kernels=True)
    # a train step with the kernels is refused when it is built
    with pytest.raises(RuntimeError, match="no backward"):
        ts.make_train_step(cfg, use_kernels=True)
    # the kernels refuse any input that requires gradients (the SSD too)
    from repro_torch.kernels import ops
    q = torch.zeros(1, 16, 2, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q.detach(), q.detach())
    mcfg = tbase.get_smoke_config("mamba2_370m")
    mstate = ts.init_state(mcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        ts.loss_fn(mcfg, mstate.params, batch, use_kernels=True)
    with torch.no_grad():         # without gradients the kernel path runs
        ts.loss_fn(cfg, state.params, batch, use_kernels=True)


def test_sharding_is_the_next_item():
    """The LM sharding (ROADMAP Queue 1 item 16) is ported: the state's
    specs on a one-rank layout replicate everything, and a consensus mode
    needs a device mesh."""
    cfg = tbase.get_smoke_config("yi_6b")
    state = ts.init_state(cfg, dp_mode="admm", device="cpu")
    spec = ts.state_shardings(state, cfg, {"data": 1, "model": 1},
                              dp_mode="admm", consensus_axis="data")
    assert spec.params.keys() == spec.duals.keys() == spec.opt.mu.keys()
    assert all(set(sp) <= {None} for sp in spec.params.values())
    assert spec.step == spec.rho == spec.opt.count == ()
    with pytest.raises(ValueError, match="device mesh"):
        ts.make_train_step(cfg, dp_mode="admm")


# ---------------------------------------------------------------------------
# Trainer: the reference's loss-decrease test, checkpoints, the launcher
# ---------------------------------------------------------------------------
def test_loss_decreases():
    """tests/test_training_serving.py::test_loss_decreases on the port."""
    tr = Trainer(ModelConfig(**TINY), global_batch=8, seq_len=64,
                 hyper=ts.TrainHyper(peak_lr=3e-3, warmup=5,
                                     total_steps=60), device="cpu")
    hist = tr.run(60, log_every=20)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5, hist


def _states_equal(a, b):
    ta, tb = ts.train_state_tree(a), ts.train_state_tree(b)
    fa, fb = ckpt._flatten(ta), ckpt._flatten(tb)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_trainer_checkpoint_roundtrip(tmp_path, param_dtype):
    """Save at step 2, restore into a fresh trainer: the state bit for bit
    (bf16 leaves stay bf16), and the next step equal."""
    cfg = ModelConfig(**dict(TINY, param_dtype=param_dtype,
                             compute_dtype=param_dtype))
    kw = dict(global_batch=4, seq_len=16, device="cpu",
              ckpt_dir=str(tmp_path), hyper=ts.TrainHyper(**HYPER))
    a = Trainer(cfg, **kw)
    a.run(2, log_every=1)
    path = a.save(2)
    assert os.path.exists(path) and ckpt.latest_step(str(tmp_path)) == 2
    b = Trainer(cfg, **dict(kw, seed=1))
    b.restore(2)
    _states_equal(a.state, b.state)
    assert b.state.params.embed.tok.dtype == getattr(torch, param_dtype)
    assert b.state.params.embed.tok.requires_grad
    again = ts.train_state_from_arrays(cfg, ckpt.read_npz(path),
                                       device="cpu")
    _states_equal(a.state, again)
    b.batcher = tokens.Batcher(cfg.vocab_size, 4, 16, seed=0)
    b.batcher.step = a.batcher.step
    for t in (a, b):
        t.run(1)
    _states_equal(a.state, b.state)


def test_restore_reference_trainer_checkpoint(tmp_path):
    """A checkpoint of the reference's Trainer (after two steps) restored
    into the port's, then one more step on both."""
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    hyper = dict(HYPER)
    jt = JTrainer(jcfg, jax.make_mesh((1,), ("data",)), global_batch=4,
                  seq_len=16, hyper=jts.TrainHyper(**hyper),
                  ckpt_dir=str(tmp_path))
    jt.run(2, log_every=1)
    jt.save(2)
    t = Trainer(cfg, global_batch=4, seq_len=16, device="cpu",
                hyper=ts.TrainHyper(**hyper), ckpt_dir=str(tmp_path))
    t.restore(2)
    assert t.state.step == 2 and t.state.opt.count == 2
    _params_close(cfg, t.state.params, jt.state.params, rtol=0.0)
    t.batcher.step = jt.batcher.step
    want = jt.run(1)[-1]
    got = t.run(1)[-1]
    assert got["loss"] == pytest.approx(want["loss"], rel=METRIC_RTOL)
    _params_close(cfg, t.state.params, jt.state.params)


def test_launch_train_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite_moe_3b_a800m", "--smoke", "--device", "cpu", "--steps",
         "3", "--seq_len", "16", "--global_batch", "2", "--log_every", "1",
         "--dp_mode", "admm"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", str(i)]
                                                for i in (1, 2, 3)]
    assert "resid" in lines[0]
    # a mesh whose size is not the number of ranks raises
    for flags in (["--model_axis", "2"], ["--host_devices", "4"]):
        bad = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "yi_6b", "--smoke", "--device", "cpu", *flags],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and "must equal" in bad.stderr
