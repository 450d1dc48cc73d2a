"""grok-1-314b [hf:xai-org/grok-1]: MoE decoder.

64L, d_model 6144, 48H (GQA kv=8), 8 experts top-2 with expert d_ff
32768, vocab 131072. 8 experts on a 16-way TP axis: experts replicate
and d_ff shards (TP-in-expert), see models/moe.py."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, n_shared_experts=0, experts_per_token=2, moe_d_ff=32768,
    param_dtype="bfloat16", opt_compress=True, microbatch_seqs=1,
)

SMOKE_CONFIG = ModelConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, n_shared_experts=0, experts_per_token=2, moe_d_ff=128,
    remat=False,
)
