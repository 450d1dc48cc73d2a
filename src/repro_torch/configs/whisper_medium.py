"""whisper-medium [arXiv:2212.04356]: enc-dec audio transformer backbone.

24 decoder + 24 encoder layers, d_model 1024, 16 heads (kv=16), d_ff 4096,
vocab 51865. The conv audio frontend is a STUB: `input_specs()` supplies
precomputed frame embeddings [B, 1500, 1024] (see shape card / DESIGN.md).
Decoder self-attn uses RoPE (deviation from learned sinusoidal; noted)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec-audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_layers=24, encoder_seq=1500,
    microbatch_seqs=4,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-medium-smoke", family="encdec-audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    encoder_layers=2, encoder_seq=16, remat=False,
)
