"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 [arXiv:2402.19427].

26 layers, pattern (rec, rec, attn); local sliding-window attention
(window 2048) with MQA (kv=1, head_dim 256).  lru_width = d_model = 2560.
`long_500k` runs natively (bounded window + recurrent state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), lru_width=2560, window=2048,
    windowed_kv=True,   # O(S*window) local attention (PerfLog: -71% Tc)
    scan_layers=False, tie_embeddings=True,
    citation="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, d_ff=256,
        head_dim=32, vocab_size=512, lru_width=128, window=16,
        param_dtype="float32", compute_dtype="float32")
