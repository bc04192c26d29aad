"""The port's last LM families against the JAX package, on the CPU, in the
f32 smoke configs with the JAX weights carried across
(`checkpoint.ckpt.lm_params_from_arrays`): forward logits and the MoE
router loss for all ten ARCH_IDS (the vlm/audio ones with stub frontend
embeddings), the RG-LRU block, its scan and decode step, the MoE block
with and without capacity drops, decode against forward, and greedy
`Engine.generate` equal to the JAX engine's for the rec, MoE and
frontend families.  Inputs are drawn with numpy; logits at rtol 1e-4,
atol 1e-5 (f32, tests/test_torch_lm_model.py's bars)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.serving import admission as jadmission
from repro.serving import engine as jengine
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tbase
from repro_torch.models import model as tmodel
from repro_torch.models import moe, rglru
from repro_torch.serving import engine

TOL = dict(rtol=1e-4, atol=1e-5)
FAMILIES = ("recurrentgemma_2b", "granite_moe_3b_a800m", "qwen2_vl_2b",
            "musicgen_large")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


def _arrays(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(arch, **replace):
    cfg = jbase.get_smoke_config(arch).replace(**replace)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = tbase.get_smoke_config(arch).replace(**replace)
    return cfg, tcfg, params, ckpt.lm_params_from_arrays(
        tcfg, _arrays(params), device="cpu")


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch) for arch in jbase.ARCH_IDS}


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _frontend(cfg, B, seed=1):
    if cfg.frontend == "none":
        return None
    return np.random.default_rng(seed).normal(
        size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_forward_all_archs(models, arch):
    """Logits, the router loss and the prefill cache of every arch."""
    cfg, tcfg, params, tlm = models[arch]
    toks, fe = _tokens(cfg, 2, 32), _frontend(cfg, 2)
    want = jax.jit(jmodel.forward, static_argnums=0,
                   static_argnames="collect_cache")(
        cfg, params, jnp.asarray(toks),
        None if fe is None else jnp.asarray(fe), collect_cache=True)
    with torch.no_grad():
        got = tmodel.forward(tcfg, tlm, torch.as_tensor(toks).long(),
                             None if fe is None else torch.tensor(fe),
                             collect_cache=True)
    _close(got["logits"], want["logits"])
    _close(got["aux_loss"], want["aux_loss"])
    assert (float(got["aux_loss"]) > 0) == cfg.is_moe
    # the JAX cache stacks a homogeneous stack's layers; a list otherwise
    for i, entry in enumerate(got["cache"]):
        want_entry = (want["cache"][i] if isinstance(want["cache"], list)
                      else jax.tree.map(lambda a: a[i], want["cache"]))
        for g, w in zip(entry, jax.tree.leaves(want_entry)):
            _close(g, w)


def test_weights_carried_across_new_leaves(models):
    """The RG-LRU, MoE and frontend leaves load under the JAX names."""
    for arch, leaf in (("recurrentgemma_2b", "blocks.0.rec.lam"),
                       ("granite_moe_3b_a800m", "blocks.1.moe.router"),
                       ("qwen2_vl_2b", "embed.frontend_proj")):
        cfg, tcfg, params, tlm = models[arch]
        got = dict(tlm.named_parameters())[leaf]
        want = ckpt._lm_named(tcfg, _arrays(params))[leaf]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dict(models["granite_moe_3b_a800m"][3].named_parameters())[
        "blocks.0.moe.router"].dtype == torch.float32


def _rec(models):
    cfg, tcfg, params, tlm = models["recurrentgemma_2b"]
    return cfg, tcfg, params["blocks"][0]["rec"], tlm.blocks[0].rec


def test_rglru_scan_and_block(models):
    cfg, tcfg, jp, tp = _rec(models)
    rng = np.random.default_rng(2)
    w = rglru._lru_width(tcfg)
    xi = rng.normal(size=(2, 37, w)).astype(np.float32)
    h0 = rng.normal(size=(2, w)).astype(np.float32)
    for got, want in zip(rglru.rglru_scan(torch.tensor(xi), tp,
                                          torch.tensor(h0)),
                         jax.jit(jrglru.rglru_scan)(jnp.asarray(xi), jp,
                                                    jnp.asarray(h0))):
        _close(got, want)
    block = jax.jit(jrglru.rec_block, static_argnums=2,
                    static_argnames="return_state")
    for S in (2, 40):               # shorter and longer than the conv
        x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        want_out, (want_buf, want_h) = block(jnp.asarray(x), jp, cfg,
                                             return_state=True)
        got_out, (got_buf, got_h) = rglru.rec_block(
            torch.tensor(x), tp, tcfg, return_state=True)
        for g, w_ in ((got_out, want_out), (got_buf, want_buf),
                      (got_h, want_h)):
            _close(g, w_)


def test_rglru_decode_step(models):
    cfg, tcfg, jp, tp = _rec(models)
    rng = np.random.default_rng(3)
    w = rglru._lru_width(tcfg)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    buf = rng.normal(size=(2, cfg.conv_width - 1, w)).astype(np.float32)
    h = rng.normal(size=(2, w)).astype(np.float32)
    want = jrglru.rec_decode_step(jnp.asarray(x), jp, cfg,
                                  (jnp.asarray(buf), jnp.asarray(h)))
    got = rglru.rec_decode_step(torch.tensor(x), tp, tcfg,
                                (torch.tensor(buf), torch.tensor(h)))
    for g, w_ in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w_)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_block_capacity(capacity_factor):
    """tests/test_models.py::test_moe_capacity_drops_are_bounded's case
    (capacity 2.0: aux ~ 1 when balanced) and a capacity that drops (0.5):
    the same outputs, so the same tokens dropped."""
    cfg = jbase.get_smoke_config("granite_moe_3b_a800m").replace(
        capacity_factor=capacity_factor)
    tcfg = tbase.get_smoke_config("granite_moe_3b_a800m").replace(
        capacity_factor=capacity_factor)
    jp = jmoe.moe_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = moe.MoE(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("router", "wi", "wg", "wo"):
            getattr(tp, name).copy_(torch.tensor(np.asarray(jp[name])))
    x = np.random.default_rng(4).normal(size=(4, 64, cfg.d_model)).astype(
        np.float32)
    want_out, want_aux = jmoe.moe_block(jnp.asarray(x), jp, cfg)
    got_out, got_aux = moe.moe_block(torch.tensor(x), tp, tcfg)
    assert tuple(got_out.shape) == x.shape
    _close(got_out, want_out)
    _close(got_aux, want_aux)
    if capacity_factor >= 1.0:
        assert float(got_aux) == pytest.approx(1.0, rel=0.5)
    # the drops: tokens whose every slot was dropped come out as zeros
    dropped = int((got_out.reshape(4 * 64, -1).abs().sum(-1) == 0).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Step-by-step decode against the teacher-forced forward (the port's
    and the JAX decode's logits), tests/test_models.py's setting: no
    frontend, and a capacity that never drops for MoE."""
    cfg = jbase.get_smoke_config(arch)
    replace = {}
    if cfg.frontend != "none":
        replace.update(frontend="none", frontend_len=0)
    if cfg.is_moe:
        replace["capacity_factor"] = float(cfg.n_experts)
    cfg, tcfg, params, tlm = _pair(arch, **replace)
    Sd = 16
    toks = _tokens(cfg, 2, Sd, seed=5)
    with torch.no_grad():
        want = tmodel.forward(tcfg, tlm, torch.as_tensor(toks).long())[
            "logits"]
        jc = jmodel.init_cache(cfg, 2, Sd, jnp.float32)
        tc = tmodel.init_cache(tcfg, 2, Sd, torch.float32, device="cpu")
        step = jax.jit(jmodel.decode_step, static_argnums=0)
        for t in range(Sd):
            tok = toks[:, t:t + 1]
            jl, jc = step(cfg, params, jnp.asarray(tok), jc, jnp.int32(t))
            tl, tc = tmodel.decode_step(tcfg, tlm,
                                        torch.as_tensor(tok).long(), tc, t)
            _close(tl, jl)
            _close(tl[:, 0], want[:, t], rtol=1e-4, atol=1e-4)


def _requests(cfg, lengths, max_new, mod):
    rng = np.random.default_rng(len(lengths))
    return [mod.Request(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        m) for n, m in zip(lengths, max_new)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_matches_jax(models, arch):
    """Greedy tokens with the kernels on (the JAX engine runs its Pallas
    kernels in interpret mode), in two waves: the frontend configs
    prefill zero stub embeddings over their first positions and pad
    prompts to frontend_len + 1."""
    cfg, tcfg, params, tlm = models[arch]
    lengths, max_new = (16, 5, 16), [6, 4, 5]
    want_engine = jengine.Engine(cfg, jadmission.data_axis_mesh(), params,
                                 max_seq=32, use_kernels=True, max_batch=2)
    want = want_engine.generate(_requests(cfg, lengths, max_new, jengine))
    got_engine = engine.Engine(tcfg, tlm, max_seq=32, use_kernels=True,
                               max_batch=2, device="cpu")
    got = got_engine.generate(_requests(tcfg, lengths, max_new, engine))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_engine.stats().slices == want_engine.stats().slices
    fe = engine.frontend_stub(tcfg, 3, "cpu")
    assert (fe is None) == (cfg.frontend == "none")
    if fe is not None:
        assert tuple(fe.shape) == (3, cfg.frontend_len, cfg.d_model)
        assert not fe.any()
