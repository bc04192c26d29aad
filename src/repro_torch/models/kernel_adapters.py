"""Adapters wiring the CUDA kernels into the model block interface (port of
`repro.models.kernel_adapters`).

Under an ambient mesh each kernel runs on DTensor inputs through a
per-shard region (`dist.sharding.region`, `local_map`): every rank
launches the kernel on its own rows and, when the heads divide the
"model" axis, its own heads; otherwise the inputs are first replicated
over "model" (what XLA does for the reference's un-partitionable custom
call).  Both forms are exact: the kernels never mix heads or rows."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers


def flash_attention_block(x, p, cfg: ModelConfig, positions, *,
                          window: int = 0):
    """Drop-in for layers.attention_block using the flash kernel."""
    B, S, _ = x.shape
    q, k, v = layers._qkv(x, p, cfg, positions)
    out = layers.attention_local(
        lambda q, k, v: ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            window=window), q, k, v)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo
    return out, k, v


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """The SSD kernel (`ops.ssd_scan`): x (B,S,H,P), dt (B,S,H), A (H,),
    Bm/Cm (B,S,N) -> (y (B,S,H,P), final state (B,H,P,N) f32)."""
    fn = lambda x, dt, A, Bm, Cm: ops.ssd_scan(
        x.contiguous(), dt.contiguous(), A, Bm.contiguous(), Cm.contiguous(),
        chunk=chunk)
    mesh = sharding.current_mesh()
    if mesh is None:
        return fn(x, dt, A, Bm, Cm)
    return heads_region(mesh, fn, x, dt, A, Bm, Cm)


def heads_region(mesh, fn, x, dt, A, Bm, Cm):
    """`fn` of the SSD scan's arguments on each rank's rows and, when the
    heads divide "model", its own heads (Bm/Cm, shared by every head,
    whole on each rank)."""
    B, H = x.shape[0], x.shape[2]
    split = H % sharding.axis_size(mesh, "model") == 0
    pl = lambda bd, md: sharding.placements_for(
        mesh, batch=B if bd is not None else None, batch_dim=bd or 0,
        model_dim=md if split else None)
    return sharding.region(
        fn, mesh,
        (pl(0, 2), pl(0, 2), pl(None, 0), pl(0, None), pl(0, None)),
        (pl(0, 2), pl(0, 1)))(x, dt, A, Bm, Cm)
