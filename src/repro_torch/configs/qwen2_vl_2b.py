"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

M-RoPE: the hd/2 = 64 rotary frequency slots are split into (t, h, w)
sections (16, 24, 24), each driven by its own position-id stream.  The
vision tower (ViT + merger) is a stub per the task carve-out: input_specs
supplies `frontend_len` precomputed patch embeddings (dynamic-resolution
token counts are represented by the fixed stub length in the dry-run).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", arch_type="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936, head_dim=128,
    rope_style="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision_stub", frontend_len=256, tie_embeddings=True,
    citation="arXiv:2409.12191",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        head_dim=32, mrope_sections=(8, 4, 4), vocab_size=512,
        frontend_len=8,
        param_dtype="float32", compute_dtype="float32")
