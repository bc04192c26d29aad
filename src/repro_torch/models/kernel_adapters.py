"""Adapters wiring the CUDA kernels into the model block interface (port of
`repro.models.kernel_adapters`)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def flash_attention_block(x, p, cfg: ModelConfig, positions, *,
                          window: int = 0):
    """Drop-in for layers.attention_block using the flash kernel."""
    B, S, _ = x.shape
    q, k, v = layers._qkv(x, p, cfg, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo
    return out, k, v
