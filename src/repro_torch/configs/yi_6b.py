"""Yi-6B — llama-architecture dense decoder with GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5e6,
    citation="arXiv:2403.04652",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        head_dim=32, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
