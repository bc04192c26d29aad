"""The port's serving engine against the JAX package's: for the f32 smoke
configs of yi_6b and mamba2_370m, with the JAX weights carried across
(`checkpoint.ckpt.lm_params_from_arrays`), greedy `Engine.generate` with
the kernels on gives EXACTLY the JAX engine's tokens (the JAX engine runs
its Pallas kernels in interpret mode on `admission.data_axis_mesh()`), in
one wave, in `max_batch=2` waves and with pow2 prompt bucketing, and
`stats()` gives the JAX counters.  Prompts are drawn with numpy."""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.serving import admission as jadmission
from repro.serving import engine as jengine
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.serving import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=["yi_6b", "mamba2_370m"])
def pair(request):
    """(jax cfg, port cfg, jax params, port LM) for one smoke config."""
    cfg = jbase.get_smoke_config(request.param)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    arrays = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    tcfg = tbase.get_smoke_config(request.param)
    return cfg, tcfg, params, ckpt.lm_params_from_arrays(tcfg, arrays,
                                                         device="cpu")


def _requests(cfg, lengths, max_new, mod):
    rng = np.random.default_rng(len(lengths))
    return [mod.Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        m) for n, m in zip(lengths, max_new)]


@pytest.mark.parametrize("kw,lengths", [
    ({}, (16, 16, 16)),                              # a single wave
    ({"max_batch": 2}, (16, 16, 16)),                # two waves
    ({"bucket": "pow2", "bucket_min": 4}, (16, 7, 3, 16)),   # 16, 8, 4
])
def test_generate_matches_jax(pair, kw, lengths):
    cfg, tcfg, params, tlm = pair
    max_new = [6, 4, 6, 5][:len(lengths)]
    want_engine = jengine.Engine(cfg, jadmission.data_axis_mesh(), params,
                                 max_seq=32, use_kernels=True, **kw)
    want = want_engine.generate(_requests(cfg, lengths, max_new, jengine))
    got_engine = engine.Engine(tcfg, tlm, max_seq=32, use_kernels=True,
                               device="cpu", **kw)
    got = got_engine.generate(_requests(tcfg, lengths, max_new, engine))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ws, gs = want_engine.stats(), got_engine.stats()
    for field in ("admitted", "evicted", "slices", "capacity"):
        assert getattr(gs, field) == getattr(ws, field), field
    for field in ("occupancy", "padding_waste"):
        assert getattr(gs, field) == pytest.approx(getattr(ws, field)), field
    assert got_engine._waves == want_engine._waves


def test_temperature_sampling_is_seeded(pair):
    """Temperature sampling cannot match jax.random; it is reproducible
    from the engine's seed, and temperature 0 is greedy."""
    cfg, tcfg, params, tlm = pair
    reqs = _requests(tcfg, (16, 16), (5, 5), engine)
    run = lambda seed, t: engine.Engine(tcfg, tlm, max_seq=32, seed=seed,
                                        device="cpu").generate(
                                            reqs, temperature=t)
    a, b = run(3, 1.0), run(3, 1.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(run(3, 0.0), run(4, 0.0)):
        np.testing.assert_array_equal(x, y)


def test_unported_engine_options_raise(pair):
    """Every engine option is ported (the mesh since ROADMAP Queue 1 item
    16; tests/test_torch_lm_sharding_mesh.py runs it): a mesh on another
    device than the engine's raises, nothing falls back."""
    cfg, tcfg, params, tlm = pair
    with pytest.raises(ValueError, match="the mesh is on cuda"):
        engine.Engine(tcfg, tlm, mesh=types.SimpleNamespace(
            device_type="cuda"), device="cpu")
    assert engine.cache_shardings([], tcfg, {"data": 1, "model": 1}) == []


def test_launch_serve_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi_6b",
         "--device", "cpu", "--use_kernels", "--requests", "3",
         "--max_new", "4", "--max_batch", "2"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        "request 0", "request 1", "request 2"]
    assert len(eval(lines[0].split(": ", 1)[1])) == 16 + 4
    assert lines[-1].startswith("engine: 8 decode steps")
