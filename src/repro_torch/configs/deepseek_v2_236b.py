"""deepseek-v2-236b [arXiv:2405.04434]: MoE + MLA.

60L, d_model 5120, 128 heads, MLA kv_lora_rank=512 (+64 rope dims),
160 routed experts top-6 + 2 shared, expert d_ff 1536, vocab 102400.
Experts shard expert-parallel (160 % 16 == 0); the MLA cache stores only
c_kv[512]+k_r[64] per token — the paper-faithful KV-memory win.
Deviation: every layer is MoE (the real model's first layer is dense)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    n_experts=160, n_shared_experts=2, experts_per_token=6, moe_d_ff=1536,
    use_mla=True, kv_lora_rank=512, mla_rope_dim=64,
    param_dtype="bfloat16", opt_compress=True, microbatch_seqs=1,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
    n_experts=8, n_shared_experts=1, experts_per_token=2, moe_d_ff=96,
    use_mla=True, kv_lora_rank=32, mla_rope_dim=16, remat=False,
)
