"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA 128k vocab [arXiv:2407.21783; unverified].

Decode defaults: temperature 0.6 / top-p 0.9 is the generation config the
llama3 model card ships; the sampler spec records the top-p default so a
decode plan tunes for the truncated workload (temperature stays a serve
argument)."""

from repro_torch.configs.base import ModelConfig, SamplerSpec

_SAMPLER = SamplerSpec(method="auto", top_p=0.9)

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    head_dim=128, rope_theta=500_000.0, sampler=_SAMPLER,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    rope_theta=500_000.0, sampler=_SAMPLER,
)
