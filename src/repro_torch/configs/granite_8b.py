"""Granite-8B (code) — llama-architecture dense, GQA kv=8 [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", arch_type="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=49152, head_dim=128,
    citation="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        head_dim=32, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
