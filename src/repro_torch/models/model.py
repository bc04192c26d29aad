"""Model assembly (port of `repro.models.model`).  Three block kinds,
resolved per layer from `cfg.layer_kinds()`:
  attn — pre-norm attention (full-causal or sliding-window) + MLP or MoE
  rec  — Griffin RG-LRU recurrent block + MLP
  ssm  — Mamba-2 SSD block (single-norm residual, no MLP; d_ff == 0)

The JAX package stacks the weights of a homogeneous stack on a leading
n_layers axis and scans over it; the port holds the layers in an
`nn.ModuleList` and loops over them in Python (so every stack is a list,
and `checkpoint.ckpt.lm_params_from_arrays` splits stacked arrays).  The
caches are likewise a list with one entry per layer.  With `cfg.remat`
and gradients on, each layer runs under `torch.utils.checkpoint` (the
reference's `jax.checkpoint`): its activations are recomputed in the
backward pass instead of kept.

Under an ambient mesh (`dist.sharding.use_mesh`; the parameters DTensors
by `dist.sharding.param_shardings`, the tokens a DTensor with their rows
over the data axes) the model runs as DTensor ops, with the reference's
constraint sites: the embeddings, every layer's input and the logits are
re-pinned to the batch layout (`constrain_batch_dim`: rows over the dp
axes, replicated over "model").

Public entry points:
  LM(cfg, device=None, generator=None) / init_params(cfg, generator, device)
  forward(cfg, params, tokens, frontend_embeds=None, collect_cache=False,
          use_kernels=False)
  init_cache(cfg, batch, cache_len, dtype, device=None)
  decode_step(cfg, params, token, cache, pos)
  param_count(cfg, active_only=False)
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.dist import sharding
from repro_torch.models import layers, mamba2, moe, rglru


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
class AttnLayer(nn.Module):
    """norm1 -> attention -> residual -> norm2 -> MLP (or MoE) ->
    residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = layers.param((cfg.d_model,), dtype, device)
        self.attn = layers.Attention(cfg, dtype, device)
        self.norm2 = layers.param((cfg.d_model,), dtype, device)
        if cfg.is_moe:
            self.moe = moe.MoE(cfg, dtype, device)
        else:
            self.mlp = layers.MLP(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.norm1.zero_()
        self.attn.reset_parameters(generator)
        self.norm2.zero_()
        (self.moe if hasattr(self, "moe") else self.mlp).reset_parameters(
            generator)


class RecLayer(nn.Module):
    """norm1 -> RG-LRU block -> residual -> norm2 -> MLP -> residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = layers.param((cfg.d_model,), dtype, device)
        self.rec = rglru.RGLRU(cfg, dtype, device)
        self.norm2 = layers.param((cfg.d_model,), dtype, device)
        self.mlp = layers.MLP(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.norm1.zero_()
        self.rec.reset_parameters(generator)
        self.norm2.zero_()
        self.mlp.reset_parameters(generator)


class SSMLayer(nn.Module):
    """norm -> Mamba-2 block -> residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm = layers.param((cfg.d_model,), dtype, device)
        self.ssm = mamba2.Mamba2Block(cfg, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.norm.zero_()
        self.ssm.reset_parameters(generator)


_LAYERS = {"attn": AttnLayer, "rec": RecLayer, "ssm": SSMLayer}


def _layer_params(cfg: ModelConfig, kind: str, dtype, *, generator, device):
    p = _LAYERS[kind](cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _homogeneous(cfg: ModelConfig) -> bool:
    """Whether the JAX package stacks this config's layers on a leading
    axis (its checkpoints then carry that axis)."""
    kinds = cfg.layer_kinds()
    return cfg.scan_layers and all(k == kinds[0] for k in kinds)


class LM(nn.Module):
    """The language model: `embed`, `blocks` (one module per layer) and
    `final_norm`, on `device` (None means the CUDA device; see
    `repro_torch.device.resolve`).  The weights are drawn from `generator`
    (default: seed 0 on the device) unless `init=False`, which leaves them
    allocated for a checkpoint load."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None,
                 init: bool = True):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        dtype = layers.dtype_of(cfg.param_dtype)
        self.embed = layers.Embed(cfg, dtype, dev)
        self.final_norm = layers.param((cfg.d_model,), dtype, dev)
        self.blocks = nn.ModuleList(_LAYERS[kind](cfg, dtype, dev)
                                    for kind in cfg.layer_kinds())
        if init:
            self.reset_parameters(generator if generator is not None
                                  else torch.Generator(dev).manual_seed(0))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.embed.reset_parameters(generator)
        self.final_norm.zero_()
        for blk in self.blocks:
            blk.reset_parameters(generator)

    def forward(self, tokens, frontend_embeds=None, *,
                collect_cache: bool = False, use_kernels: bool = False):
        return forward(self.cfg, self, tokens, frontend_embeds,
                       collect_cache=collect_cache, use_kernels=use_kernels)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                *, device=None) -> LM:
    """An `LM` with random weights at `cfg`'s shapes, drawn directly on the
    device in the config's dtype (None means the CUDA device)."""
    return LM(cfg, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Per-layer forward (prefill)
# ---------------------------------------------------------------------------
def _layer_fwd(x, p, cfg: ModelConfig, kind: str, positions, *,
               collect_cache: bool, use_kernels: bool):
    """Returns (x, aux_loss, cache_entry)."""
    x = sharding.constrain_batch_dim(x)
    if kind == "attn":
        h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
        a, k, v = p.attn(h, positions, window=cfg.window,
                         use_kernels=use_kernels)
        x = x + a
        h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
        if cfg.is_moe:
            f, aux = moe.moe_block(h2, p.moe, cfg)
        else:
            f, aux = p.mlp(h2), 0.0
        x = x + f
        cache = _attn_cache_entry(cfg, k, v) if collect_cache else None
        return x, aux, cache
    if kind == "rec":
        h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
        if collect_cache:
            r, state = p.rec(h, return_state=True)
        else:
            r, state = p.rec(h), None
        x = x + r
        h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
        return x + p.mlp(h2), 0.0, state
    if kind == "ssm":
        h = layers.rms_norm(x, p.norm, cfg.norm_eps)
        if collect_cache:
            s, state = p.ssm(h, return_state=True, use_kernel=use_kernels)
        else:
            s, state = p.ssm(h, use_kernel=use_kernels), None
        return x + s, 0.0, state
    raise ValueError(kind)


def _attn_cache_entry(cfg: ModelConfig, k, v):
    """Trim prefill K/V to the ring-buffer window for sliding-window
    archs."""
    if cfg.window > 0 and k.shape[1] > cfg.window:
        k, v = k[:, -cfg.window:], v[:, -cfg.window:]
    return (k, v)


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------
def _remat(cfg: ModelConfig, params: LM) -> bool:
    """Whether the layers run under activation checkpointing: the config
    asks for it and a backward pass will follow."""
    return cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())


def forward(cfg: ModelConfig, params: LM, tokens, frontend_embeds=None, *,
            collect_cache: bool = False, use_kernels: bool = False):
    """tokens (B, S) -> dict(logits (B,S,V) f32, aux_loss, cache?).  The
    cache is a list with one entry per layer; aux_loss sums the MoE
    layers' router losses (0.0 without MoE)."""
    B, S = tokens.shape
    x = layers.embed(tokens, params.embed, cfg, frontend_embeds)
    x = sharding.constrain_batch_dim(x.to(layers.dtype_of(cfg.compute_dtype)))
    positions = layers.default_positions(cfg, B, S, device=tokens.device)
    remat = _remat(cfg, params)
    mesh = sharding.current_mesh()
    kw = {} if mesh is None else {"context_fn": lambda: (
        contextlib.nullcontext(), sharding.use_mesh(mesh))}
    auxs, cache = [], []
    for p, kind in zip(params.blocks, cfg.layer_kinds()):
        fwd = lambda x, p=p, kind=kind: _layer_fwd(
            x, p, cfg, kind, positions, collect_cache=collect_cache,
            use_kernels=use_kernels)
        # the recomputation runs in the backward pass (on the card, in
        # the autograd engine's own thread): under the forward's mesh
        x, aux, c = (checkpoint(fwd, x, use_reentrant=False, **kw) if remat
                     else fwd(x))
        auxs.append(aux)
        cache.append(c)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = sharding.constrain_batch_dim(layers.unembed(x, params.embed, cfg))
    out = {"logits": logits, "aux_loss": sum(auxs, 0.0)}
    if collect_cache:
        out["cache"] = cache
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window > 0 else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, *, device=None) -> list:
    """Empty decode cache, one entry per layer: (k, v) (B, Sc, Hkv, hd) for
    attn, (conv_buf (B, W-1, w), h (B, w) f32) for rec, (conv_buf (B, W-1,
    d_in+2N), h (B, H, P, N) f32) for ssm."""
    dev = resolve(device)
    sc = _cache_len(cfg, seq_len)

    def entry(kind):
        if kind == "attn":
            shp = (batch, sc, cfg.n_kv_heads, cfg.hd)
            return (torch.zeros(shp, dtype=dtype, device=dev),
                    torch.zeros(shp, dtype=dtype, device=dev))
        if kind == "rec":
            w = rglru._lru_width(cfg)
            return (torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=dev),
                    torch.zeros((batch, w), dtype=torch.float32, device=dev))
        d_in, H, N = mamba2._dims(cfg)
        return (torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * N),
                            dtype=dtype, device=dev),
                torch.zeros((batch, H, cfg.ssm_head_dim, N),
                            dtype=torch.float32, device=dev))

    return [entry(k) for k in cfg.layer_kinds()]


def _layer_decode(x, p, cfg: ModelConfig, kind: str, cache_entry, pos):
    if kind == "attn":
        h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
        ck, cv = cache_entry
        a, ck, cv = layers.attention_decode(h, p.attn, cfg, ck, cv, pos,
                                            window=cfg.window)
        x = x + a
        h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
        f = moe.moe_block(h2, p.moe, cfg)[0] if cfg.is_moe else p.mlp(h2)
        return x + f, (ck, cv)
    if kind == "rec":
        h = layers.rms_norm(x, p.norm1, cfg.norm_eps)
        r, state = rglru.rec_decode_step(h, p.rec, cfg, cache_entry)
        x = x + r
        h2 = layers.rms_norm(x, p.norm2, cfg.norm_eps)
        return x + p.mlp(h2), state
    if kind == "ssm":
        h = layers.rms_norm(x, p.norm, cfg.norm_eps)
        s, state = mamba2.ssm_decode_step(h, p.ssm, cfg, cache_entry)
        return x + s, state
    raise ValueError(kind)


def decode_step(cfg: ModelConfig, params: LM, token, cache: list, pos: int):
    """token (B, 1) ids, pos an int -> (logits (B,1,V), new cache).  The
    attention entries of `cache` are updated in place
    (`layers.attention_decode`)."""
    # the batch layout at once, as `forward` pins it (under a mesh a
    # vocab-sharded table leaves the lookup a masked partial sum)
    x = sharding.constrain_batch_dim(layers.embed(token, params.embed, cfg).to(
        layers.dtype_of(cfg.compute_dtype)))
    new_cache = []
    for p, kind, c in zip(params.blocks, cfg.layer_kinds(), cache):
        x, c = _layer_decode(x, p, cfg, kind, c, pos)
        new_cache.append(c)
    x = layers.rms_norm(x, params.final_norm, cfg.norm_eps)
    return layers.unembed(x, params.embed, cfg), new_cache


# ---------------------------------------------------------------------------
# Analytic parameter counts (for 6ND roofline model-FLOPs)
# ---------------------------------------------------------------------------
def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, hd = cfg.d_model, cfg.hd
    total = cfg.vocab_size * d
    if not cfg.tie_embeddings:
        total += d * cfg.vocab_size
    if cfg.frontend != "none":
        total += d * d
    for kind in cfg.layer_kinds():
        if kind == "attn":
            total += d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            total += cfg.n_heads * hd * d + 2 * d
            if cfg.is_moe:
                e = cfg.experts_per_token if active_only else cfg.n_experts
                total += d * cfg.n_experts + e * 3 * d * cfg.d_ff
            else:
                total += 3 * d * cfg.d_ff
        elif kind == "rec":
            w = rglru._lru_width(cfg)
            total += 2 * d * w + 2 * w * w + cfg.conv_width * w + w * d
            total += 3 * d * cfg.d_ff + 2 * d
        elif kind == "ssm":
            d_in, H, N = mamba2._dims(cfg)
            total += d * (2 * d_in + 2 * N + H)
            total += cfg.conv_width * (d_in + 2 * N)
            total += d_in * d + d_in + d + 3 * H
    return total + d
