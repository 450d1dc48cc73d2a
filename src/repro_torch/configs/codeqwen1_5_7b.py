"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: dense decoder (qwen1.5 arch).

32L, d_model 4096, 32H (kv=32 -> MHA), d_ff 13440, vocab 92416."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, microbatch_seqs=2,
)

SMOKE_CONFIG = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    remat=False,
)
