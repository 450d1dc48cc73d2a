"""ModelConfig + the assigned input-shape grid (a copy of the JAX
package's `configs/base.py`; dtypes are named by string, as there).

Shapes (same for every LM arch):
  train_4k    — seq 4096,  global_batch 256  (train_step)
  prefill_32k — seq 32768, global_batch 32   (serve prefill)
  decode_32k  — seq 32768 KV, global_batch 128, 1 new token (serve decode)
  long_500k   — seq 524288 KV, global_batch 1 (decode; sub-quadratic archs only)
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec-audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    mla_rope_dim: int = 64
    # --- SSM / hybrid ---
    ssm_state: int = 0
    block_pattern: tuple = ()     # e.g. ("slstm","mlstm",...) cycle; () = uniform
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0       # 0 = full attention
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0          # precomputed frame/patch embeddings length
    # --- numerics / distribution ---
    norm_eps: float = 1e-5
    param_dtype: str = "float32"  # giants use bfloat16 + compressed Adam
    compute_dtype: str = "bfloat16"
    opt_compress: bool = False
    remat: bool = True
    microbatch_seqs: int = 4      # per-replica sequences per grad-accum step
    # --- capability flags ---
    sub_quadratic: bool = False   # supports long_500k decode
    has_decoder: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "whisper-medium", "chameleon-34b", "xlstm-125m", "deepseek-v2-236b",
    "grok-1-314b", "codeqwen1.5-7b", "internlm2-1.8b", "internlm2-20b",
    "qwen2-0.5b", "hymba-1.5b",
]


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.SMOKE_CONFIG


def registry() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


def shape_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention: 500K-token decode unsupported (DESIGN.md §4)"
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only architecture has no decode step"
    return True, ""
