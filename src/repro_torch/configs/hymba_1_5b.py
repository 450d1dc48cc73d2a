"""hymba-1.5b [arXiv:2411.13676]: hybrid — parallel attention + Mamba heads.

32L, d_model 1600, 25H (GQA kv=5), d_ff 5504, vocab 32001, ssm_state 16.
Attention uses a 1024-token sliding window (ring-buffer cache), the Mamba
path carries O(1) SSD state => long_500k supported."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, ssm_state=16, sliding_window=1024,
    sub_quadratic=True, microbatch_seqs=4,
)

SMOKE_CONFIG = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    ssm_state=8, sliding_window=8, sub_quadratic=True, remat=False,
)
