"""qwen2-0.5b [arXiv:2407.10671]: dense decoder, GQA kv=2, QKV bias.

24L, d_model 896, 14H (GQA kv=2), d_ff 4864, vocab 151936."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, qkv_bias=True, microbatch_seqs=4,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    qkv_bias=True, remat=False,
)
