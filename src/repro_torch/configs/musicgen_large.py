"""MusicGen-Large language-model backbone [arXiv:2306.05284].

Decoder-only transformer over EnCodec audio tokens (vocab 2048).  The audio
frontend (EnCodec codec / text conditioner) is a stub per the task carve-out:
input_specs supplies `frontend_len` precomputed conditioning embeddings.
kv = 32 == n_heads (no GQA grouping — MHA, as in the released model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048, head_dim=64,
    frontend="audio_stub", frontend_len=256,
    citation="arXiv:2306.05284",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        head_dim=32, vocab_size=512, frontend_len=8,
        param_dtype="float32", compute_dtype="float32")
