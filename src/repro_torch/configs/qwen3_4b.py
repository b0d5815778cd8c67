"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""

from repro_torch.configs.base import ModelConfig, SamplerSpec

# qwen3 thinking-mode generation config: top-k 20 + top-p 0.95 + min-p 0
# (the model card explicitly documents min_p, so it rides in the spec)
_SAMPLER = SamplerSpec(method="auto", top_k=20, top_p=0.95, min_p=0.0)

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
    num_heads=32, num_kv_heads=8, d_ff=9728, vocab_size=151936,
    head_dim=128, qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    sampler=_SAMPLER,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    sampler=_SAMPLER,
)
