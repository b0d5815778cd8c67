"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].

expand=2 -> d_inner=2048, head_dim 64 -> 32 heads, conv width 4, SSD chunk
128.  Attention-free: runs the long_500k cell with O(1) decode state.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280, attention="none",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, num_heads=32, conv_width=4,
                  chunk=128, expand=2, n_groups=1),
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=128, attention="none",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, head_dim=16, num_heads=8, conv_width=4,
                  chunk=16, n_groups=1),
)
