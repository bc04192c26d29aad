"""Shared neural layers (port of `repro.models.layers`).

The blocks are `nn.Module`s that hold their weights (`Attention`, `MLP`,
`Embed`); the arithmetic is plain functions on tensors under the JAX
package's names (`rms_norm`, `apply_rope`, `attention_block`, ...), which
take the module as their parameter set.  Weights keep the JAX layout
`(in, out)` and are used as `x @ W`.  Matmul-bearing ops run in the
weights' dtype; accumulation-sensitive math (softmax, norms, rotary) runs
in float32, as in the JAX package.  Where the JAX package mixes dtypes
(an f32 cache with bf16 activations), the port casts explicitly to the
type JAX promotes to.

Parameters are created with `requires_grad=False`, so serving builds no
autograd graph; training turns gradients on for its model
(`training.train_step.init_state`).

Under an ambient device mesh (`dist.sharding.use_mesh`) the weights and
activations are DTensors: the projections, norms and pointwise math run
as DTensor ops, and the per-head attention runs in a per-shard region
(`attention_local`): each rank attends over its own rows and, when the
kv heads divide the "model" axis, its own heads (else every head).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The tensors cast to the dtype JAX would promote them to (for ops,
    like einsum and cat, that torch does not promote itself)."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def conv_tail(x, W: int):
    """The last (W-1) pre-conv inputs of x (B, S, C), zero-padded when
    the sequence is shorter: a causal conv's state for decode
    continuation (the Mamba-2 and RG-LRU blocks)."""
    S = x.shape[1]
    if S < W - 1:
        x = F.pad(x, (0, 0, W - 1 - S, 0))
    return x[:, -(W - 1):, :]


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised weight (filled by `reset_parameters` or a
    checkpoint load)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                in_axis: int = 0) -> torch.Tensor:
    """Fill `w` with N(0, 1) / sqrt(fan_in), drawn in f32 (JAX's
    `dense_init`; torch's generator gives other numbers than jax.random)."""
    scale = 1.0 / math.sqrt(w.shape[in_axis])
    w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
            * scale)
    return w


@torch.no_grad()
def normal_init_(w: torch.Tensor, generator: torch.Generator,
                 std: float) -> torch.Tensor:
    w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * std)
    return w


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in f32, cast back."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings — full / half (chatglm "RoPE 2d") / M-RoPE
# ---------------------------------------------------------------------------
def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, dim/2)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """x (..., S, H, dim) rotated GPT-NeoX style (split halves)."""
    d2 = x.shape[-1] // 2
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    cos = cos[..., None, :]   # broadcast over heads: (..., S, 1, d2)
    sin = sin[..., None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x (B, S, H, hd); positions (B, S) or (3, B, S) for mrope."""
    hd = x.shape[-1]
    if cfg.rope_style == "half":
        # chatglm: rotary over the first half of head dims, rest untouched
        d_rot = hd // 2
        cos, sin = _rope_angles(positions, d_rot, cfg.rope_theta)
        return torch.cat([_rotate(x[..., :d_rot], cos, sin),
                          x[..., d_rot:]], -1)
    if cfg.rope_style == "mrope":
        # qwen2-vl: the hd/2 frequency slots are split into (t, h, w)
        # sections, each driven by its own position-id stream
        sections = cfg.mrope_sections or (hd // 4, hd // 8, hd // 8)
        if sum(sections) != hd // 2:
            raise ValueError(f"mrope sections {sections} must sum to "
                             f"hd/2 = {hd // 2}")
        splits = [0]
        for s in sections:
            splits.append(splits[-1] + int(s))
        parts = [_rope_angles(positions[i], hd, cfg.rope_theta)
                 for i in range(3)]
        sel_cos = torch.cat([parts[i][0][..., splits[i]:splits[i + 1]]
                             for i in range(3)], -1)
        sel_sin = torch.cat([parts[i][1][..., splits[i]:splits[i + 1]]
                             for i in range(3)], -1)
        return _rotate(x, sel_cos, sel_sin)
    cos, sin = _rope_angles(positions, hd, cfg.rope_theta)
    return _rotate(x, cos, sin)


def default_positions(cfg: ModelConfig, batch: int, seq: int,
                      offset: int = 0, *, device=None) -> torch.Tensor:
    pos = torch.arange(seq, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.rope_style == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


# ---------------------------------------------------------------------------
# Attention (GQA; full-causal, sliding-window, and cached-decode variants)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """wq (d, Hq hd), wk/wv (d, Hkv hd), wo (Hq hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hd
        self.wq = param((cfg.d_model, cfg.n_heads * hd), dtype, device)
        self.wk = param((cfg.d_model, cfg.n_kv_heads * hd), dtype, device)
        self.wv = param((cfg.d_model, cfg.n_kv_heads * hd), dtype, device)
        self.wo = param((cfg.n_heads * hd, cfg.d_model), dtype, device)

    def reset_parameters(self, generator: torch.Generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)

    def forward(self, x, positions, *, window: int = 0,
                use_kernels: bool = False):
        """(out (B,S,d), k, v): `attention_block`, or the flash kernel's
        `kernel_adapters.flash_attention_block` with `use_kernels`."""
        if use_kernels:
            from repro_torch.models import kernel_adapters
            return kernel_adapters.flash_attention_block(
                x, self, self.cfg, positions, window=window)
        return attention_block(x, self, self.cfg, positions, window=window)


def attn_params(cfg: ModelConfig, dtype, *, generator, device) -> Attention:
    p = Attention(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _heads(t, n: int, hd: int):
    """(B, S, n hd) -> (B, S, n, hd).  Under a mesh whose "model" axis
    does not divide the n heads, a projection left model-sharded is
    replicated there first: DTensor cannot split a head over ranks."""
    mesh = sharding.current_mesh()
    if mesh is not None and n % sharding.axis_size(mesh, "model"):
        t = sharding.unshard_model(t)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _qkv(x, p, cfg: ModelConfig, positions):
    hd = cfg.hd
    q = _heads(x @ p.wq, cfg.n_heads, hd)
    k = _heads(x @ p.wk, cfg.n_kv_heads, hd)
    v = _heads(x @ p.wv, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def sdpa(q, k, v, mask, scale, *, reduce=None):
    """q (B,Sq,Hkv,G,hd), k/v (B,Skv,Hkv,hd), mask (...,Sq,Skv) add-mask.
    f32 logits from f32 operands (JAX's preferred_element_type; TF32
    stays off), softmax in f32, weights cast back to q's dtype.
    `reduce` sums the logits over the ranks that hold the other parts of
    a head_dim-sharded contraction (in place)."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    if reduce is not None:
        reduce(logits)
    logits = logits * scale + mask
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def causal_mask(seq: int, window: int = 0, dtype=torch.float32, *,
                device=None):
    i = torch.arange(seq, device=device)[:, None]
    j = torch.arange(seq, device=device)[None, :]
    ok = j <= i
    if window > 0:
        ok &= j > i - window
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(ok, zero, NEG_INF).to(dtype)[None, None, None]


CHUNKED_ATTN_THRESHOLD = 2048
ATTN_Q_CHUNK = 1024


def chunked_sdpa(q, k, v, scale, *, window: int = 0,
                 q_chunk: int = ATTN_Q_CHUNK, windowed_kv: bool = False):
    """Memory-bounded attention: a loop over query chunks with full K/V
    (peak logits O(q_chunk * S) instead of O(S^2)).

    windowed_kv (sliding-window archs only): each chunk attends to a slice
    of window + q_chunk keys ending at its last row.
    """
    B, S, Hkv, G, hd = q.shape
    q_chunk = min(q_chunk, S)
    nq = S // q_chunk
    if nq * q_chunk != S:
        raise ValueError(f"S={S} must be a multiple of q_chunk={q_chunk}")
    use_slice = windowed_kv and window > 0 and window + q_chunk < S
    kv_len = window + q_chunk if use_slice else S
    outs = []
    for ci in range(nq):
        qb = q[:, ci * q_chunk:(ci + 1) * q_chunk]
        i = ci * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        if use_slice:
            start = min(max(ci * q_chunk + q_chunk - kv_len, 0), S - kv_len)
            kb = k[:, start:start + kv_len]
            vb = v[:, start:start + kv_len]
            j = start + torch.arange(kv_len, device=q.device)[None, :]
        else:
            kb, vb = k, v
            j = torch.arange(S, device=q.device)[None, :]
        ok = j <= i
        if window > 0:
            ok &= j > i - window
        zero = torch.zeros((), device=q.device)
        mask = torch.where(ok, zero, NEG_INF)[None, None, None]
        outs.append(sdpa(qb, kb, vb, mask, scale))
    return torch.cat(outs, dim=1)


def attention_core(q, k, v, cfg: ModelConfig, *, window: int = 0):
    """Causal (or sliding-window) attention of q (B, S, Hq, hd) over k/v
    (B, S, Hkv, hd) -> (B, S, Hq, hd), on whatever heads and rows the
    tensors hold (in a per-shard region, a rank's own)."""
    B, S, Hq, hd = q.shape
    g = Hq // k.shape[2]
    if cfg.attn_flat_heads:
        # every query head its own kv head (the JAX mesh layout knob)
        kq = torch.repeat_interleave(k, g, dim=2)
        vq = torch.repeat_interleave(v, g, dim=2)
        qg = q.reshape(B, S, Hq, 1, hd)
    else:
        kq, vq = k, v
        qg = q.reshape(B, S, k.shape[2], g, hd)
    scale = 1.0 / math.sqrt(cfg.hd)
    if S > CHUNKED_ATTN_THRESHOLD:
        out = chunked_sdpa(qg, kq, vq, scale, window=window,
                           q_chunk=cfg.attn_q_chunk,
                           windowed_kv=cfg.windowed_kv)
    else:
        mask = causal_mask(S, window, torch.float32, device=q.device)
        out = sdpa(qg, kq, vq, mask, scale)
    return out.reshape(B, S, Hq, hd)


def attention_local(fn, q, k, v):
    """`fn(q, k, v)` (an attention over whole heads) on each rank's rows
    and, when the kv heads divide the "model" axis, its own heads; else
    q, k and v are first replicated over "model" (what XLA does for the
    reference's un-partitionable kernel call).  Without an ambient mesh,
    `fn` on the tensors themselves."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return fn(q, k, v)
    split = k.shape[2] % sharding.axis_size(mesh, "model") == 0
    pl = sharding.placements_for(mesh, batch=q.shape[0],
                                 model_dim=2 if split else None)
    return sharding.region(fn, mesh, (pl, pl, pl), pl)(q, k, v)


def attention_block(x, p, cfg: ModelConfig, positions, *, window: int = 0):
    """Training/prefill attention.  Returns (out (B,S,d), k, v for
    caching)."""
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg, positions)
    out = attention_local(
        lambda q, k, v: attention_core(q, k, v, cfg, window=window),
        q, k, v)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo
    return out, k, v


def _decode_core(q, k, v, cache_k, cache_v, *, pos: int, slot: int,
                 scale: float, reduce=None):
    """Write the new key and value at `slot` of the cache (in place) and
    attend q (B, 1, Hq, hd) over the slots written so far; all shapes are
    the tensors' own (a rank's rows, heads or head_dim slice)."""
    B, _, Hq, hd = q.shape
    Sc, Hkv = cache_k.shape[1], cache_k.shape[2]
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, 1, Hkv, Hq // Hkv, hd)
    valid = torch.arange(Sc, device=q.device) <= pos
    zero = torch.zeros((), device=q.device)
    mask = torch.where(valid, zero, NEG_INF)[None, None, None, None, :]
    out = sdpa(qg, cache_k.to(q.dtype), cache_v.to(q.dtype), mask, scale,
               reduce=reduce)
    return out.reshape(B, 1, Hq, hd), cache_k, cache_v


def attention_decode(x, p, cfg: ModelConfig, cache_k, cache_v, pos: int, *,
                     window: int = 0):
    """Single-token decode.  cache_k/v (B, Sc, Hkv, hd); pos an int.

    Full-attention archs use Sc = seq_len; sliding-window archs use a ring
    buffer Sc = window (keys RoPE'd at absolute positions before writing).
    The new key and value are written into cache_k/cache_v IN PLACE (the
    JAX function returns updated copies; in place saves a copy of the
    whole cache per layer and step).  Returns (out (B,1,d), cache_k,
    cache_v).

    Under a mesh the cache keeps its layout (`serving.engine.
    cache_shardings`: rows over the dp axes, head_dim or the kv heads
    over "model"), and each rank writes and attends over its own block:
    with head_dim sharded, the QK^T partial sums are added over "model"
    before the softmax (the reference pins q's head_dim to "model" when
    the kv heads do not divide it, so the contraction partial-sums small
    logits instead of gathering the cache).
    """
    B = x.shape[0]
    Sc = cache_k.shape[1]
    positions = default_positions(cfg, B, 1, pos, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions)
    slot = pos % Sc if window > 0 else pos
    slot = min(max(slot, 0), Sc - 1)      # dynamic_update_slice clamps
    core = functools.partial(_decode_core, pos=pos, slot=slot,
                             scale=1.0 / math.sqrt(cfg.hd))
    mesh = sharding.current_mesh()
    if mesh is None:
        out, cache_k, cache_v = core(q, k, v, cache_k, cache_v)
    else:
        m = sharding.axis_size(mesh, "model")
        if m > 1 and cfg.n_kv_heads % m != 0:
            q = sharding.constrain_last_dim_model(q)
        out, cache_k, cache_v = _decode_local(mesh, core, q, k, v, cache_k,
                                              cache_v)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p.wo
    return out, cache_k, cache_v


def _decode_local(mesh, core, q, k, v, cache_k, cache_v):
    """`core` (`_decode_core`) on each rank's block of the cache, in the
    cache's own layout: its model-sharded dim is head_dim (3), the kv
    heads (2) or none (then the cache is replicated over "model" for the
    step)."""
    B = q.shape[0]
    md = sharding.model_dim_of(cache_k)
    if md not in (2, 3):
        md = None
    pl = sharding.placements_for(mesh, batch=B, model_dim=md)
    if md == 3 and sharding.axis_size(mesh, "model") > 1:
        group = mesh.get_group("model")
        core = functools.partial(
            core, reduce=lambda t: dist.all_reduce(t, group=group))
    out, ck, cv = sharding.region(core, mesh, (pl,) * 5, (pl, pl, pl))(
        q, k, v, cache_k, cache_v)
    if md == 3:                 # whole heads again before the projection
        out = sharding.relayout(out, mesh,
                                sharding.placements_for(mesh, batch=B))
    return out, ck, cv


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """wi, wg (d, d_ff), wo (d_ff, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        self.wi = param((cfg.d_model, d_ff), dtype, device)
        self.wg = param((cfg.d_model, d_ff), dtype, device)
        self.wo = param((d_ff, cfg.d_model), dtype, device)

    def reset_parameters(self, generator: torch.Generator):
        for w in (self.wi, self.wg, self.wo):
            dense_init_(w, generator)

    def forward(self, x):
        return mlp_block(x, self)


def mlp_params(cfg: ModelConfig, dtype, *, generator, device,
               d_ff: Optional[int] = None) -> MLP:
    p = MLP(cfg, dtype, device, d_ff)
    p.reset_parameters(generator)
    return p


def mlp_block(x, p):
    h = F.silu(x @ p.wg) * (x @ p.wi)
    return h @ p.wo


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def _vocab_rows(cfg: ModelConfig) -> int:
    return max(cfg.vocab_pad, cfg.vocab_size)


class Embed(nn.Module):
    """tok (V, d); unembed (d, V) unless the embeddings are tied;
    frontend_proj (d, d), the projector from the (stubbed) modality
    encoder's output space, when the config has a frontend."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        V = _vocab_rows(cfg)
        self.tok = param((V, cfg.d_model), dtype, device)
        self.unembed = (None if cfg.tie_embeddings
                        else param((cfg.d_model, V), dtype, device))
        self.frontend_proj = (None if cfg.frontend == "none" else
                              param((cfg.d_model, cfg.d_model), dtype,
                                    device))

    def reset_parameters(self, generator: torch.Generator):
        normal_init_(self.tok, generator, 0.02)
        for w in (self.unembed, self.frontend_proj):
            if w is not None:
                dense_init_(w, generator)


def embed_params(cfg: ModelConfig, dtype, *, generator, device) -> Embed:
    p = Embed(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def embed(tokens, p, cfg: ModelConfig, frontend_embeds=None):
    """tokens (B, S) integer ids -> (B, S, d).  For vlm/audio archs, the
    first `frontend_len` positions take the projected stub embeddings
    `frontend_embeds` (B, frontend_len, d) instead of token embeddings."""
    x = F.embedding(tokens, p.tok)
    if frontend_embeds is not None and cfg.frontend_len > 0:
        fe = frontend_embeds.to(x.dtype) @ p.frontend_proj
        x = torch.cat([fe, x[:, cfg.frontend_len:]], dim=1)
    return x


def unembed(x, p, cfg: ModelConfig):
    w = p.tok.T if cfg.tie_embeddings else p.unembed
    logits = (x @ w).float()
    if _vocab_rows(cfg) > cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=x.device) >= \
            cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits
