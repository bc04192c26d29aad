"""Moonlight-16B-A3B (moonshot) [hf:moonshotai/Moonlight-16B-A3B].

Task header tags it [dense] but specifies MoE 64 experts top-6 with
per-expert d_ff 1408 — implemented as MoE (matches the model card; see
DESIGN.md §7).  48 layers, d_model 2048, kv=16.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", arch_type="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=163840, head_dim=128,
    n_experts=64, experts_per_token=6,
    citation="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64,
        head_dim=32, vocab_size=512, n_experts=4, experts_per_token=2,
        param_dtype="float32", compute_dtype="float32")
