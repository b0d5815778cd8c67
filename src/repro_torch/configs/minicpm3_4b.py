"""minicpm3-4b [dense]: 62L d_model=2560 40H (GQA kv=40) d_ff=6400
vocab=73448 — MLA [hf:openbmb/MiniCPM3-4B; hf].

MLA geometry per the HF config: q_lora 768, kv_lora 256, qk_nope 64,
qk_rope 32, v_head 64.  Decode uses the absorbed form against the latent
cache (c_kv + k_pe), prefill the naive expanded form.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
    num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73448,
    attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)

SMOKE = ModelConfig(
    name="minicpm3-4b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128, attention="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                  qk_rope_head_dim=8, v_head_dim=8),
)
