"""Grok-1 314B [hf:xai-org/grok-1] — MoE 8 experts top-2.

64 layers, d_model 6144, 48 heads GQA kv=8, per-expert d_ff 32768.  The
largest assigned config — exercises fsdp weight sharding and expert-ff
model-parallel sharding in the dry-run.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", arch_type="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab_size=131072, head_dim=128,
    n_experts=8, experts_per_token=2,
    citation="hf:xai-org/grok-1",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128,
        head_dim=32, vocab_size=512, n_experts=4, experts_per_token=2,
        param_dtype="float32", compute_dtype="float32")
