"""xlstm-125m [arXiv:2405.04517]: sLSTM + mLSTM blocks.

12L, d_model 768, 4 heads, vocab 50304, d_ff=0 (mixer-only blocks).
Block pattern: one sLSTM per 4 (scalar memory, truly recurrent scan),
rest mLSTM (matrix memory, chunkwise-parallel GLA — see models/ssm.py).
Recurrent O(1)-state decode => long_500k supported."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
    block_pattern=("slstm", "mlstm", "mlstm", "mlstm"),
    sub_quadratic=True, microbatch_seqs=4,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-125m-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=512,
    head_dim=32, block_pattern=("slstm", "mlstm", "mlstm", "mlstm"),
    sub_quadratic=True, remat=False,
)
