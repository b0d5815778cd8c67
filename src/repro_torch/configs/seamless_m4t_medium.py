"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Interpretation: 12 encoder layers (speech) + 12 decoder layers (text), per
the HF medium checkpoint layout.  The audio frontend is a stub: input_specs
provide precomputed frame embeddings (B, S/2, d_model); target text is the
other S/2 positions, so a shape cell's seq_len covers enc+dec positions.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    encoder_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke", family="encdec", num_layers=2,
    encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128, frontend="audio",
)
