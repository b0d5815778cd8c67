"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155,
    head_dim=64, tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, expert_d_ff=512,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe", num_layers=2,
    d_model=64, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
    head_dim=16, tie_embeddings=True,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=32,
                  capacity_factor=2.0),
)
