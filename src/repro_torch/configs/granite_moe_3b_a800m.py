"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-1b-a400m-base family].

32 layers, d_model 1536, GQA kv=8 (head_dim 64), MoE with 40 experts top-8,
per-expert d_ff = 512 (task-header spec; the bracket note "32 experts" is
superseded — see DESIGN.md §7).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", arch_type="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155, head_dim=64,
    n_experts=40, experts_per_token=8,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64,
        head_dim=32, vocab_size=512, n_experts=4, experts_per_token=2,
        param_dtype="float32", compute_dtype="float32")
