"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

The ViT frontend is a stub per the assignment: input_specs supply 256
precomputed patch embeddings (B, 256, d_model); the remaining seq_len-256
positions are text tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", num_layers=40, d_model=5120,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=131072,
    head_dim=128, rope_theta=1_000_000_000.0,
    frontend="vision", frontend_len=256,
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    frontend="vision", frontend_len=8,
)
