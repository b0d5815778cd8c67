"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118; hf].

Even layers use a 4096 sliding window, odd layers are global; attention
logits softcap 50, final logits softcap 30; post-norms; tied + scaled
embeddings; GeGLU.  head_dim=256 (qkv wider than d_model, per the paper).
long_500k is skipped: the global layers are full attention (DESIGN.md §4).

``SAMPLER`` is its generation config (top-k 64, top-p 0.95); the 256k
vocabulary is where the truncated draw's no-sort path pays.
"""

from repro_torch.configs.base import ModelConfig, SamplerSpec

SAMPLER = SamplerSpec(method="auto", top_k=64, top_p=0.95)
VOCAB_SIZE = 256000

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense", num_layers=42, d_model=3584,
    num_heads=16, num_kv_heads=8, d_ff=14336, vocab_size=VOCAB_SIZE,
    head_dim=256, sliding_window=4096, layer_pattern="local_global",
    attn_softcap=50.0, final_softcap=30.0, post_norms=True,
    tie_embeddings=True, embedding_scale=True, act="gelu",
    sampler=SAMPLER,
)

SMOKE = ModelConfig(
    name="gemma2-9b-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128, head_dim=32,
    sliding_window=16, layer_pattern="local_global", attn_softcap=50.0,
    final_softcap=30.0, post_norms=True, tie_embeddings=True,
    embedding_scale=True, act="gelu", sampler=SAMPLER,
)
