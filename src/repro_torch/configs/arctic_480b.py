"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: every layer has attention + a parallel dense residual MLP
+ a 128-expert top-2 MoE (both FFN paths d_ff=4864).  The biggest assigned
arch (~479B params).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  capacity_factor=1.25, dense_residual_d_ff=4864),
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=64,
                  capacity_factor=2.0, dense_residual_d_ff=64),
)
