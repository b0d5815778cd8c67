"""build_model(cfg): one Model interface over every model family, the
counterpart of ``repro.models.model``.

``batch`` dicts:
  decoder-only            {"tokens": (B, S)}
  vlm / audio (dec-only)  {"tokens": (B, S_text), "frontend_embeds": (B, S_f, D)}
  encdec                  {"src_embeds": (B, Se, D), "tgt_tokens": (B, St)}
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf


class Model(NamedTuple):
    cfg: ModelConfig
    specs: Dict
    apply: Callable          # (params, batch, remat=...) -> (logits, aux)
    prefill: Callable        # (params, batch) -> (last_logits, caches)
    decode: Callable         # (params, caches, tokens, cache_pos) -> (logits, caches)
    cache_specs: Callable    # (batch_size, max_len) -> spec tree


def build_model(cfg: ModelConfig) -> Model:
    if cfg.encoder_layers > 0:

        def apply(params, batch, remat="full"):
            return ed.encdec_apply(cfg, params, batch["src_embeds"], batch["tgt_tokens"], remat)

        def prefill(params, batch):
            return ed.encdec_prefill(cfg, params, batch["src_embeds"], batch["tgt_tokens"])

        def decode(params, caches, tokens, cache_pos):
            return ed.encdec_decode(cfg, params, caches, tokens, cache_pos)

        def cache_specs(batch_size, max_len):
            # decode cache: self KV up to max_len // 2 target + cross of the rest
            tgt = max_len // 2
            return ed.encdec_cache_specs(cfg, batch_size, tgt, max_len - tgt)

        return Model(cfg, ed.encdec_specs(cfg), apply, prefill, decode, cache_specs)

    def apply(params, batch, remat="full"):
        return tf.lm_apply(cfg, params, batch["tokens"], batch.get("frontend_embeds"), remat)

    def prefill(params, batch):
        return tf.lm_prefill(cfg, params, batch["tokens"], batch.get("frontend_embeds"))

    def decode(params, caches, tokens, cache_pos):
        return tf.lm_decode(cfg, params, caches, tokens, cache_pos)

    def cache_specs(batch_size, max_len):
        total = max_len + cfg.meta_tokens + cfg.frontend_len
        return tf.stack_cache_specs(cfg, batch_size, total)

    return Model(cfg, tf.lm_specs(cfg), apply, prefill, decode, cache_specs)
