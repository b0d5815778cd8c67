"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].

Hybrid layer = shared input norm -> (attention heads || mamba heads),
learned per-branch scales; 128 meta tokens prepended; sliding-window 1024
everywhere except 3 full-attention layers (first/middle/last) — which is
what makes the long_500k cell feasible for this arch.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, d_ff=5504, vocab_size=32001,
    head_dim=64, meta_tokens=128, local_window=1024,
    ssm=SSMConfig(state_dim=16, head_dim=64, num_heads=25, conv_width=4,
                  chunk=128, n_groups=1),
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
    meta_tokens=8, local_window=16,
    ssm=SSMConfig(state_dim=8, head_dim=16, num_heads=4, conv_width=4,
                  chunk=16, n_groups=1),
)
