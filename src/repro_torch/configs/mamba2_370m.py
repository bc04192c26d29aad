"""Mamba-2 370M — SSD (state-space duality) [arXiv:2405.21060].

Attention-free; d_ff=0 (no MLP — the Mamba block is the whole layer).
d_inner = 2*1024 = 2048, head_dim 64 -> 32 SSD heads, state N=128.
`long_500k` runs natively (recurrent state, O(1) per decoded token).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm", n_layers=48, d_model=1024,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    block_pattern=("ssm",), tie_embeddings=True,
    citation="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
        ssm_head_dim=32, ssm_chunk=16,
        param_dtype="float32", compute_dtype="float32")
