"""Config system: architecture + run configuration (a copy of
`repro.configs.base`; the port imports nothing of the JAX package).

Every assigned architecture gets a module `src/repro_torch/configs/<id>.py`
exporting `CONFIG: ModelConfig` (the exact published shape) and
`smoke_config()` (a reduced same-family variant for CPU tests).  The registry
resolves `--arch <id>` names for the launcher, dry-run and benchmarks.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # defaults to d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    # layer pattern, tiled to n_layers: "attn" | "rec" | "ssm"
    block_pattern: Tuple[str, ...] = ("attn",)
    lru_width: Optional[int] = None
    # --- attention flavour ---
    window: int = 0                     # >0: sliding-window ("local") attention
    rope_theta: float = 10000.0
    rope_style: str = "full"            # full | half (chatglm 2d) | mrope (qwen2-vl)
    mrope_sections: Tuple[int, ...] = ()
    # --- modality frontend (stub per task carve-out) ---
    frontend: str = "none"              # none | vision_stub | audio_stub
    frontend_len: int = 0               # positions consumed by stub embeddings
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    citation: str = ""
    # --- numerics / partitioning knobs (run-level, overridable) ---
    # flat-head attention: broadcast KV to all query heads so the (fused)
    # head axis shards cleanly over "model" even when n_kv_heads doesn't
    # divide it (kills GSPMD resharding thrash; §Perf hillclimb knob)
    attn_flat_heads: bool = False
    # bound each query chunk's keys to [chunk_end - window, chunk_end) via
    # dynamic_slice instead of masking the full row (§Perf hillclimb knob)
    windowed_kv: bool = False
    # MoE: route/scatter per data shard (shard_map, per-shard capacity —
    # the Switch-Transformer "per-core" semantics) instead of one global
    # dispatch buffer whose scatter crosses every shard (§Perf knob).
    # Requires expert weights replicated over "data" (no fsdp on them).
    moe_local_dispatch: bool = False
    # pad embedding/unembedding tables to this size so the vocab axis
    # shards over "model" (0 = no padding).  Padded logit columns are
    # masked to -1e30 (§Perf knob; granite-moe's 49155 is indivisible).
    vocab_pad: int = 0
    # query-chunk length of the blocked attention (peak logits memory
    # scales linearly with it; §Perf memory knob)
    attn_q_chunk: int = 1024
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    fsdp: bool = True                   # shard fsdp dim of weights over "data"
    remat: bool = True                  # activation-checkpoint each layer
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolved per-layer block kinds of length n_layers."""
        pat = self.block_pattern
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in roofline)."""
        from repro_torch.models.model import param_count
        return param_count(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import param_count
        return param_count(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "musicgen_large",
    "mamba2_370m",
    "recurrentgemma_2b",
    "yi_6b",
    "granite_moe_3b_a800m",
    "granite_8b",
    "moonshot_v1_16b_a3b",
    "qwen2_vl_2b",
    "grok_1_314b",
    "chatglm3_6b",
)


def canonical(arch: str) -> str:
    return arch.replace("-", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.smoke_config()


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
