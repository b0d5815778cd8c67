"""Encoder-decoder backbone (seamless-m4t), the counterpart of
``repro.models.encdec``: a bidirectional encoder over frontend embeddings
(the audio stub) and a causal decoder with cross-attention.

Caches: the decoder's self-attention KV (grows during decode, written in
place) and per-layer cross KV computed once from the encoder memory
(read during decode).  The stacks are Python loops over the layers, each
under ``torch.utils.checkpoint`` for ``remat="full"`` when gradients are
recorded (``layers.remat_layer``; "dots" too, which the reference's
enc-dec stacks run without remat: the values are the same), where the
reference scans under ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (einsum, embed, embedding_spec, mlp, mlp_spec,
                                       remat_layer, rmsnorm, rmsnorm_spec, unembed,
                                       unembed_spec)
from repro_torch.models.params import ParamSpec, stack_specs_tree, tree_map


def _enc_layer_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": rmsnorm_spec(cfg.d_model),
        "attn": attn.gqa_spec(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln_self": rmsnorm_spec(cfg.d_model),
        "self_attn": attn.gqa_spec(cfg),
        "ln_cross": rmsnorm_spec(cfg.d_model),
        "cross_attn": attn.cross_attention_spec(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg.d_model, cfg.d_ff),
    }


def encdec_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "frontend_proj": ParamSpec((d, d), ("embed", "embed_out")),
        "encoder": stack_specs_tree(_enc_layer_spec(cfg), cfg.encoder_layers),
        "enc_norm": rmsnorm_spec(d),
        "embed": embedding_spec(cfg.padded_vocab, d),
        "decoder": stack_specs_tree(_dec_layer_spec(cfg), cfg.num_layers),
        "final_norm": rmsnorm_spec(d),
        "unembed": unembed_spec(cfg.padded_vocab, d),
    }


def _masked_unembed(cfg: ModelConfig, params, h):
    return unembed(params["unembed"], h, vocab_size=cfg.vocab_size)


def _enc_layer(cfg, lp, x, positions):
    h = rmsnorm(lp["ln_attn"], x, cfg.norm_eps)
    y, _ = attn.gqa_attend(lp["attn"], h, positions, cfg, causal=False)
    x = x + y
    h = rmsnorm(lp["ln_mlp"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h, cfg.act)


def encode(cfg: ModelConfig, params: Dict, src_embeds: torch.Tensor, remat: str = "full"):
    """src_embeds (B, Se, D) from the stub audio frontend -> memory (B, Se, D)."""
    x = einsum("bsd,de->bse", src_embeds, params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=x.device)
    layer = remat_layer(_enc_layer, remat)
    for l in range(cfg.encoder_layers):
        x = layer(cfg, tree_map(lambda a: a[l], params["encoder"]), x, positions)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_layer(cfg, lp, x, positions, memory, lcache, cache_pos):
    h = rmsnorm(lp["ln_self"], x, cfg.norm_eps)
    if lcache is None:
        y, kv = attn.gqa_attend(lp["self_attn"], h, positions, cfg, causal=True)
        self_cache = {"k": kv[0], "v": kv[1]}
        cross_kv = attn.cross_memory(lp["cross_attn"], memory, cfg)
    else:
        y, self_cache = attn.gqa_attend(
            lp["self_attn"], h, positions, cfg, causal=False,
            cache={"k": lcache["self_k"], "v": lcache["self_v"]}, cache_pos=cache_pos)
        cross_kv = (lcache["cross_k"], lcache["cross_v"])
    x = x + y
    h = rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
    x = x + attn.cross_attend(lp["cross_attn"], h, cross_kv, cfg)
    h = rmsnorm(lp["ln_mlp"], x, cfg.norm_eps)
    x = x + mlp(lp["mlp"], h, cfg.act)
    return x, {"self_k": self_cache["k"], "self_v": self_cache["v"],
               "cross_k": cross_kv[0], "cross_v": cross_kv[1]}


def _decoder_stack(cfg, params, x, positions, memory, caches=None, cache_pos=None,
                   collect_cache=False, remat="full"):
    """Returns (x, caches): the given caches (written in place), or with
    ``collect_cache`` each layer's caches stacked into (L, ...) leaves,
    else None."""
    collected = []
    layer = _dec_layer if caches is not None or collect_cache else \
        remat_layer(_dec_layer, remat)
    for l in range(cfg.num_layers):
        lp = tree_map(lambda a: a[l], params["decoder"])
        lcache = None if caches is None else tree_map(lambda a: a[l], caches)
        x, cache_out = layer(cfg, lp, x, positions, memory, lcache, cache_pos)
        if collect_cache:
            collected.append(cache_out)
    if caches is not None:
        return x, caches
    if collect_cache:
        return x, tree_map(lambda *ls: torch.stack(ls), *collected)
    return x, None


def encdec_apply(cfg: ModelConfig, params: Dict, src_embeds, tgt_tokens, remat="full"):
    """Training forward: (B,Se,D) x (B,St) -> logits (B,St,V), aux=0."""
    memory = encode(cfg, params, src_embeds, remat=remat)
    x = embed(params["embed"], tgt_tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _decoder_stack(cfg, params, x, positions, memory, remat=remat)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _masked_unembed(cfg, params, h), 0.0


def encdec_prefill(cfg: ModelConfig, params: Dict, src_embeds, tgt_tokens, remat="none"):
    """Returns (last-position logits, stacked decode caches)."""
    memory = encode(cfg, params, src_embeds, remat=remat)
    x = embed(params["embed"], tgt_tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _decoder_stack(cfg, params, x, positions, memory, collect_cache=True,
                               remat=remat)
    h = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return _masked_unembed(cfg, params, h)[:, 0, :], caches


def encdec_decode(cfg: ModelConfig, params: Dict, caches, tokens, cache_pos):
    """One decode step against the self KV cache (written in place) and the
    precomputed cross KV.  ``cache_pos``: an int or 0-d tensor, or (B,)
    per-row positions (each row's RoPE angle its own)."""
    x = embed(params["embed"], tokens)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        cache_pos = cache_pos.to(x.device)
        positions = cache_pos[:, None]
    else:
        positions = torch.full((1,), int(cache_pos), device=x.device)
    x, caches = _decoder_stack(cfg, params, x, positions, None, caches=caches,
                               cache_pos=cache_pos, remat="none")
    h = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return _masked_unembed(cfg, params, h)[:, 0, :], caches


def encdec_cache_specs(cfg: ModelConfig, batch: int, tgt_len: int, src_len: int) -> Dict:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    axes = ("batch", "kv_seq", "kv_heads", "head")
    layer = {
        "self_k": ParamSpec((batch, tgt_len, kv, hd), axes, init="zeros"),
        "self_v": ParamSpec((batch, tgt_len, kv, hd), axes, init="zeros"),
        "cross_k": ParamSpec((batch, src_len, kv, hd), axes, init="zeros"),
        "cross_v": ParamSpec((batch, src_len, kv, hd), axes, init="zeros"),
    }
    return stack_specs_tree(layer, cfg.num_layers)
