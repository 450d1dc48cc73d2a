"""chameleon-34b [arXiv:2405.09818]: early-fusion VLM decoder.

48L, d_model 8192, 64H (GQA kv=8), d_ff 22016, vocab 65536 — VQ image
tokens are ordinary vocabulary ids, so the modality frontend is a stub and
the backbone is a dense decoder-only transformer."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
    param_dtype="bfloat16", opt_compress=True, microbatch_seqs=1,
)

SMOKE_CONFIG = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512,
    remat=False,
)
