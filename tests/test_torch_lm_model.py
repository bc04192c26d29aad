"""The port's LM layers and model against the JAX package, on the CPU, in
the f32 smoke configs of yi_6b (attention) and mamba2_370m (SSD), with the
JAX weights carried across through a JAX-saved checkpoint
(`checkpoint.ckpt.load_reference_lm_checkpoint`).  Inputs are drawn with
numpy; everything is compared at rtol 1e-4, atol 1e-5 (f32)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro.models import model as jmodel
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.models import layers, mamba2
from repro_torch.models import model as tmodel

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{arch: (jax cfg, port cfg, jax params, port LM)} for both smoke
    configs."""
    out = {}
    for arch in ("yi_6b", "mamba2_370m"):
        cfg = jbase.get_smoke_config(arch)
        params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
        path = jckpt.save(os.path.join(tmp_path_factory.mktemp(arch),
                                       "p.npz"), params)
        tcfg = tbase.get_smoke_config(arch)
        out[arch] = (cfg, tcfg, params, ckpt.load_reference_lm_checkpoint(
            path, tcfg, device="cpu"))
    return out


@pytest.fixture(params=["yi_6b", "mamba2_370m"])
def lm(request, models):
    return models[request.param]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


def test_weights_carried_across(lm):
    cfg, tcfg, params, tlm = lm
    flat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    assert np.array_equal(tlm.embed.tok.numpy(), flat["['embed']['tok']"])
    for key, arr in flat.items():
        if key.startswith("['blocks']"):
            name = key.split("'")[3:-1:2]
            for i in range(cfg.n_layers):
                w = tlm.blocks[i]
                for part in name:
                    w = getattr(w, part)
                assert np.array_equal(w.numpy(), arr[i]), key
    arrays = dict(flat)
    arrays.pop("['final_norm']")
    with pytest.raises(KeyError, match="missing"):
        ckpt.lm_params_from_arrays(tcfg, arrays, device="cpu")
    arrays["['final_norm']"] = np.zeros(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="shape"):
        ckpt.lm_params_from_arrays(tcfg, arrays, device="cpu")
    arrays["['final_norm']"] = flat["['final_norm']"]
    arrays["['extra']"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        ckpt.lm_params_from_arrays(tcfg, arrays, device="cpu")
    # a stacked config's checkpoint read as a list of layers
    with pytest.raises(ValueError, match="layout"):
        ckpt.lm_params_from_arrays(tcfg.replace(scan_layers=False), flat,
                                   device="cpu")


def test_param_factories():
    """The JAX package's per-block init functions, as module factories:
    the JAX shapes, zero norms, N(0, 1/fan_in) weights."""
    cfg = tbase.get_smoke_config("yi_6b")
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device="cpu")
    attn = layers.attn_params(cfg, torch.float32, **kw)
    assert tuple(attn.wk.shape) == (cfg.d_model, cfg.n_kv_heads * cfg.hd)
    assert abs(float(attn.wq.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    mlp = layers.mlp_params(cfg, torch.bfloat16, **kw)
    assert mlp.wo.dtype == torch.bfloat16
    assert tuple(mlp.wo.shape) == (cfg.d_ff, cfg.d_model)
    emb = layers.embed_params(cfg, torch.float32, **kw)
    assert abs(float(emb.tok.std()) - 0.02) < 0.002
    layer = tmodel._layer_params(cfg, "attn", torch.float32, **kw)
    assert not layer.norm1.any() and not layer.norm2.any()
    mcfg = tbase.get_smoke_config("mamba2_370m")
    ssm = mamba2.ssm_params(mcfg, torch.float32, **kw)
    np.testing.assert_allclose(
        ssm.A_log.numpy(), np.asarray(jmamba2.ssm_params(
            jax.random.PRNGKey(0), mcfg, jnp.float32)["A_log"]), rtol=1e-6)
    assert not ssm.conv_b.any() and bool((ssm.D == 1).all())


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    _close(layers.rms_norm(torch.tensor(x), torch.tensor(s), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("arch", ["yi_6b", "chatglm3_6b", "qwen2_vl_2b"])
def test_apply_rope(arch):
    """full (yi), half (chatglm) and mrope (qwen2-vl) on random
    positions."""
    cfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, cfg.n_heads, cfg.hd)).astype(np.float32)
    shape = (3, 2, 7) if cfg.rope_style == "mrope" else (2, 7)
    pos = rng.integers(0, 64, shape).astype(np.int32)
    _close(layers.apply_rope(torch.tensor(x), torch.tensor(pos), tcfg),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg))


def _attn(models):
    cfg, tcfg, params, tlm = models["yi_6b"]
    return cfg, tcfg, _layer0(params)["attn"], tlm.blocks[0].attn


@pytest.mark.parametrize("window", [0, 8])
def test_attention_block(models, window):
    cfg, tcfg, jp, tp = _attn(models)
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    pos = jlayers.default_positions(cfg, 2, 24)
    want = jlayers.attention_block(jnp.asarray(x), jp, cfg, pos,
                                   window=window)
    got = layers.attention_block(torch.tensor(x), tp, tcfg,
                                 layers.default_positions(tcfg, 2, 24),
                                 window=window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("window,windowed_kv", [(0, False), (8, False),
                                                (8, True)])
def test_chunked_sdpa(window, windowed_kv):
    """The memory-bounded attention of prompts past
    CHUNKED_ATTN_THRESHOLD, at a small q_chunk."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 32, 2, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(window=window, q_chunk=8, windowed_kv=windowed_kv)
    _close(layers.chunked_sdpa(*map(torch.tensor, (q, k, v)), 0.25, **kw),
           jlayers.chunked_sdpa(*map(jnp.asarray, (q, k, v)), 0.25, **kw))


@pytest.mark.parametrize("window", [0, 8])
def test_attention_decode(models, window):
    cfg, tcfg, jp, tp = _attn(models)
    rng = np.random.default_rng(3)
    Sc = window or 20
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.normal(size=(2, Sc, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32) for _ in range(2))
    pos = 13
    want = jlayers.attention_decode(jnp.asarray(x), jp, cfg, jnp.asarray(ck),
                                    jnp.asarray(cv), jnp.int32(pos),
                                    window=window)
    got = layers.attention_decode(torch.tensor(x), tp, tcfg,
                                  torch.tensor(ck), torch.tensor(cv), pos,
                                  window=window)
    for g, w in zip(got, want):
        _close(g, w)


def _ssm(models):
    cfg, tcfg, params, tlm = models["mamba2_370m"]
    return cfg, tcfg, _layer0(params)["ssm"], tlm.blocks[0].ssm


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_block(models, use_kernel):
    cfg, tcfg, jp, tp = _ssm(models)
    x = np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    want_out, (want_buf, want_h) = jmamba2.ssm_block(
        jnp.asarray(x), jp, cfg, return_state=True, use_kernel=use_kernel)
    got_out, (got_buf, got_h) = mamba2.ssm_block(
        torch.tensor(x), tp, tcfg, return_state=True, use_kernel=use_kernel)
    for g, w in ((got_out, want_out), (got_buf, want_buf), (got_h, want_h)):
        _close(g, w)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba2.ssm_block(torch.tensor(x[:, :24]), tp, tcfg,
                         use_kernel=use_kernel)


def test_ssm_decode_step(models):
    cfg, tcfg, jp, tp = _ssm(models)
    d_in, H, N = mamba2._dims(tcfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    buf = rng.normal(size=(2, cfg.conv_width - 1, d_in + 2 * N)).astype(
        np.float32)
    h = rng.normal(size=(2, H, cfg.ssm_head_dim, N)).astype(np.float32)
    want = jmamba2.ssm_decode_step(jnp.asarray(x), jp, cfg,
                                   (jnp.asarray(buf), jnp.asarray(h)))
    got = mamba2.ssm_decode_step(torch.tensor(x), tp, tcfg,
                                 (torch.tensor(buf), torch.tensor(h)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward(lm, use_kernels):
    cfg, tcfg, params, tlm = lm
    toks = _tokens(cfg, 2, 32)
    want = jmodel.forward(cfg, params, jnp.asarray(toks), collect_cache=True,
                          use_kernels=use_kernels)
    got = tmodel.forward(tcfg, tlm, torch.as_tensor(toks, dtype=torch.long),
                         collect_cache=True, use_kernels=use_kernels)
    _close(got["logits"], want["logits"])
    # the JAX cache stacks the layers on a leading axis; the port's is a
    # list with one entry per layer
    for i, entry in enumerate(got["cache"]):
        for g, w in zip(entry, want["cache"]):
            _close(g, w[i])


def test_init_cache_and_decode_step(lm):
    """Decode four tokens from an empty f32 cache."""
    cfg, tcfg, params, tlm = lm
    jc = jmodel.init_cache(cfg, 2, 8, jnp.float32)
    tc = tmodel.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    assert len(tc) == cfg.n_layers
    for entry in tc:
        for t, j in zip(entry, jc):
            assert tuple(t.shape) == j.shape[1:] and not t.any()
    toks = _tokens(cfg, 2, 4, seed=6)
    for pos in range(4):
        tok = toks[:, pos:pos + 1]
        want, jc = jmodel.decode_step(cfg, params, jnp.asarray(tok), jc,
                                      jnp.int32(pos))
        got, tc = tmodel.decode_step(
            tcfg, tlm, torch.as_tensor(tok, dtype=torch.long), tc, pos)
        _close(got, want)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_count(arch):
    for active in (False, True):
        assert tmodel.param_count(tbase.get_config(arch), active) == \
            jmodel.param_count(jbase.get_config(arch), active)
    assert tbase.get_config(arch).n_params() == \
        jbase.get_config(arch).n_params()


def test_unported_configs_raise():
    """The rec, MoE and frontend configs build since their families were
    ported (tests/test_torch_lm_families.py holds them against JAX), and
    the LM sharding (ROADMAP Queue 1 item 16), which raised, gives specs:
    on a one-rank layout every dim is replicated."""
    from repro_torch.serving import engine
    from repro_torch.training import train_step
    for arch in ("recurrentgemma_2b", "granite_moe_3b_a800m", "qwen2_vl_2b",
                 "musicgen_large"):
        cfg = tbase.get_smoke_config(arch)
        lm = tmodel.init_params(cfg, device="cpu")
        # tests/test_models.py's bar for the analytic count (biases and
        # scales are not in the formula)
        actual = sum(p.numel() for p in lm.parameters())
        assert abs(actual - tmodel.param_count(cfg)) / actual < 0.01
        one = {"data": 1, "model": 1}
        state = train_step.init_state(cfg, device="cpu", params=lm)
        specs = train_step.state_shardings(state, cfg, one,
                                           dp_mode="allreduce")
        cache = tmodel.init_cache(cfg, 2, 8, device="meta")
        for spec in list(specs.params.values()) + [
                sp for entry in engine.cache_shardings(cache, cfg, one)
                for sp in entry]:
            assert set(spec) <= {None}, (arch, spec)
