"""ChatGLM3-6B [arXiv:2406.12793] — dense, GQA kv=2, 2-d RoPE.

GLM applies rotary embeddings to only the first half of each head's dims
("RoPE 2d"); implemented as rope_style="half".
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", arch_type="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=65024, head_dim=128,
    rope_style="half",
    citation="arXiv:2406.12793",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        head_dim=32, vocab_size=512,
        param_dtype="float32", compute_dtype="float32")
