"""Decoder-only LM stack, the counterpart of ``repro.models.transformer``:
four layer families (dense / moe / ssm / hybrid, with GQA or MLA
attention) in three modes (full, prefill, decode).

Params and caches are stacked ``(L, ...)`` trees, as in the reference (its
checkpoint layout); :func:`stack_apply` is a Python loop over the layers
that reads layer ``l`` of each stacked leaf (a view, no copy), where the
reference scans.  Per-layer attention windows are data
(:func:`layer_windows`), so gemma2's local/global alternation and hymba's
three full-attention layers are per-layer integers.  ``remat="full"`` (or
``"dots"``) runs each layer under ``torch.utils.checkpoint`` when
gradients are being recorded, where the reference puts ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import constrain_activation
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    einsum,
    embed,
    embedding_spec,
    mlp,
    mlp_spec,
    remat_layer,
    rmsnorm,
    rmsnorm_spec,
    unembed,
    unembed_spec,
)
from repro_torch.models.params import ParamSpec, stack_specs_tree, tree_map

_ATTN_FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio")


# ---------------------------------------------------------------------------
# per-layer spec
# ---------------------------------------------------------------------------


def layer_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    spec: Dict = {}
    if cfg.family in _ATTN_FAMILIES:
        spec["ln_attn"] = rmsnorm_spec(d)
        spec["attn"] = attn.mla_spec(cfg) if cfg.attention == "mla" else attn.gqa_spec(cfg)
        if cfg.post_norms:
            spec["ln_post_attn"] = rmsnorm_spec(d)
    if cfg.family in ("dense", "vlm", "audio", "hybrid"):
        spec["ln_mlp"] = rmsnorm_spec(d)
        spec["mlp"] = mlp_spec(d, cfg.d_ff)
        if cfg.post_norms:
            spec["ln_post_mlp"] = rmsnorm_spec(d)
    if cfg.family == "moe":
        spec["ln_mlp"] = rmsnorm_spec(d)
        spec["moe"] = moe_mod.moe_spec(cfg)
        if cfg.moe.dense_residual_d_ff > 0:
            spec["dense_mlp"] = mlp_spec(d, cfg.moe.dense_residual_d_ff)
    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "ssm":
            spec["ln_ssm"] = rmsnorm_spec(d)
        spec["ssm"] = ssm_mod.ssm_spec(cfg)
        if cfg.family == "hybrid":
            # learned per-branch output scales (hymba's beta_attn/beta_ssm)
            spec["branch_scale"] = ParamSpec((2,), (None,), init="ones")
    return spec


def layer_cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    spec: Dict = {}
    if cfg.family in _ATTN_FAMILIES:
        if cfg.attention == "mla":
            spec["attn"] = attn.mla_cache_spec(cfg, batch, max_len)
        else:
            spec["attn"] = attn.gqa_cache_spec(cfg, batch, max_len)
    if cfg.family in ("ssm", "hybrid"):
        spec["ssm"] = ssm_mod.ssm_cache_spec(cfg, batch)
    return spec


# ---------------------------------------------------------------------------
# per-layer forward
# ---------------------------------------------------------------------------


def _attn_branch(p, h, positions, window, cfg, cache, cache_pos):
    if cfg.attention == "mla":
        if cache is None:
            return attn.mla_attend_full(p, h, positions, cfg)
        return attn.mla_attend_decode(p, h, cache, cache_pos, cfg)
    if cache is None:
        y, kv = attn.gqa_attend(p, h, positions, cfg, causal=True, window=window)
        return y, {"k": kv[0], "v": kv[1]}
    return attn.gqa_attend(p, h, positions, cfg, causal=False, window=window,
                           cache=cache, cache_pos=cache_pos)


def _ssm_branch(p, h, cfg, cache):
    if cache is None:
        return ssm_mod.ssm_block(p, h, cfg)
    return ssm_mod.ssm_decode_step(p, h, cache, cfg)


def layer_apply(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    cache: Optional[Dict] = None,
    cache_pos=None,
):
    """One block.  Returns (x, cache_out, aux_loss)."""
    aux = 0.0
    cache_out: Dict = {}
    attn_cache = None if cache is None else cache.get("attn")
    ssm_cache = None if cache is None else cache.get("ssm")

    if cfg.family in ("dense", "moe", "vlm", "audio"):
        h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        y, cache_out["attn"] = _attn_branch(p["attn"], h, positions, window, cfg,
                                            attn_cache, cache_pos)
        if cfg.post_norms:
            y = rmsnorm(p["ln_post_attn"], y, cfg.norm_eps)
        x = x + y
        h = rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
        if cfg.family == "moe":
            y, aux = moe_mod.moe_block(p["moe"], h, cfg, cfg.moe_dispatch)
            if cfg.moe.dense_residual_d_ff > 0:
                y = y + mlp(p["dense_mlp"], h, cfg.act)
        else:
            y = mlp(p["mlp"], h, cfg.act)
        if cfg.post_norms:
            y = rmsnorm(p["ln_post_mlp"], y, cfg.norm_eps)
        x = x + y

    elif cfg.family == "ssm":
        h = rmsnorm(p["ln_ssm"], x, cfg.norm_eps)
        y, cache_out["ssm"] = _ssm_branch(p["ssm"], h, cfg, ssm_cache)
        x = x + y

    elif cfg.family == "hybrid":
        h = rmsnorm(p["ln_attn"], x, cfg.norm_eps)
        ya, cache_out["attn"] = _attn_branch(p["attn"], h, positions, window, cfg,
                                             attn_cache, cache_pos)
        ys, cache_out["ssm"] = _ssm_branch(p["ssm"], h, cfg, ssm_cache)
        bs = p["branch_scale"].to(torch.float32)
        x = x + (bs[0] * ya.to(torch.float32) + bs[1] * ys.to(torch.float32)).to(x.dtype)
        h = rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h, cfg.act)
    else:
        raise ValueError(cfg.family)

    return x, cache_out, aux


# ---------------------------------------------------------------------------
# layer windows (static pattern -> data vector)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    L = cfg.num_layers
    w = np.zeros((L,), np.int32)
    if cfg.layer_pattern == "local_global" and cfg.sliding_window > 0:
        w[0::2] = cfg.sliding_window  # even layers local (gemma2)
    elif cfg.family == "hybrid" and cfg.local_window > 0:
        w[:] = cfg.local_window
        for full in (0, L // 2, L - 1):  # hymba's 3 full-attention layers
            w[full] = 0
    return w


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def stack_specs(cfg: ModelConfig) -> Dict:
    return stack_specs_tree(layer_spec(cfg), cfg.num_layers)


def stack_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    return stack_specs_tree(layer_cache_spec(cfg, batch, max_len), cfg.num_layers)


def stack_apply(
    cfg: ModelConfig,
    params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    caches: Optional[Dict] = None,
    cache_pos=None,
    collect_cache: bool = False,
    remat: str = "none",
):
    """The layer stack.  Returns (x, caches_out, aux_total): with
    ``caches`` the stacked caches, written in place; with
    ``collect_cache`` each layer's cache leaves stacked into (L, ...)
    leaves; else None.  ``remat`` "full" or "dots" recomputes each layer
    in the backward pass (``torch.utils.checkpoint``) of a full pass that
    records gradients; "dots" saves nothing more than "full"."""
    windows = layer_windows(cfg)
    collected, aux = [], 0.0
    layer = layer_apply if caches is not None or collect_cache else \
        remat_layer(layer_apply, remat)
    for l in range(cfg.num_layers):
        lp = tree_map(lambda a: a[l], params)
        lcache = None if caches is None else tree_map(lambda a: a[l], caches)
        if x.shape[1] > 1:  # not decode: the activation hook on the carry
            x = constrain_activation(x, ("batch", "act_seq", None))
        x, cache_out, aux_l = layer(cfg, lp, x, positions, int(windows[l]),
                                    cache=lcache, cache_pos=cache_pos)
        aux = aux + aux_l
        if collect_cache:
            collected.append(cache_out)
    if caches is not None:
        return x, caches, aux
    if collect_cache:
        return x, tree_map(lambda *ls: torch.stack(ls), *collected), aux
    return x, None, aux


# ---------------------------------------------------------------------------
# LM heads: specs + three entry points
# ---------------------------------------------------------------------------


def lm_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    spec = {
        "embed": embedding_spec(cfg.padded_vocab, d),
        "layers": stack_specs(cfg),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = unembed_spec(cfg.padded_vocab, d)
    if cfg.meta_tokens > 0:
        spec["meta"] = ParamSpec((cfg.meta_tokens, d), (None, "embed"), scale=0.02)
    if cfg.frontend_len > 0:
        # stub frontend projection: precomputed embeddings -> d_model
        spec["frontend_proj"] = ParamSpec((d, d), ("embed", "embed_out"))
    return spec


def _input_embeddings(cfg, params, tokens, frontend_embeds=None):
    """tokens (B, S_text); frontend_embeds (B, S_front, D) or None.
    Returns (B, S_total, D) with meta tokens / frontend prepended."""
    x = embed(params["embed"], tokens, scale=cfg.embedding_scale)
    parts = []
    if cfg.meta_tokens > 0:
        B = tokens.shape[0]
        parts.append(params["meta"].to(x.dtype)[None].expand(B, cfg.meta_tokens, x.shape[-1]))
    if frontend_embeds is not None:
        parts.append(einsum("bsd,de->bse", frontend_embeds.to(x.dtype),
                            params["frontend_proj"]))
    parts.append(x)
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def _logits(cfg, params, x):
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    return unembed(params.get("unembed"), h, tied_table=tied, softcap=cfg.final_softcap,
                   vocab_size=cfg.vocab_size)


def lm_apply(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
             frontend_embeds: Optional[torch.Tensor] = None, remat: str = "none"):
    """Full forward: (logits for every *text* position (B, S_text, V), aux)."""
    x = _input_embeddings(cfg, params, tokens, frontend_embeds)
    x, _, aux = stack_apply(cfg, params["layers"], x,
                            torch.arange(x.shape[1], device=x.device), remat=remat)
    prefix = cfg.meta_tokens + (frontend_embeds.shape[1] if frontend_embeds is not None else 0)
    if prefix > 0:
        x = x[:, prefix:]
    return _logits(cfg, params, x), aux


def lm_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor] = None, remat: str = "none"):
    """Prefill: returns (last-position logits (B, V), stacked caches)."""
    x = _input_embeddings(cfg, params, tokens, frontend_embeds)
    x, caches, _ = stack_apply(cfg, params["layers"], x,
                               torch.arange(x.shape[1], device=x.device), collect_cache=True)
    return _logits(cfg, params, x[:, -1:, :])[:, 0, :], caches


def lm_decode(cfg: ModelConfig, params: Dict, caches: Dict, tokens: torch.Tensor,
              cache_pos):
    """One decode step.  Returns (logits (B, V), caches).

    ``cache_pos`` is the write position shared by the batch (an int or a
    0-d tensor), or a (B,) tensor of per-row positions — the
    continuous-batching form, where every slot of one fixed-shape decode
    batch sits at its own sequence length (``repro_torch.serve.batching``).
    The step is written into ``caches`` in place."""
    x = embed(params["embed"], tokens, scale=cfg.embedding_scale)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        cache_pos = cache_pos.to(x.device)
        positions = cache_pos[:, None]       # (B, S=1) per-row RoPE positions
    else:
        positions = torch.full((1,), int(cache_pos), device=x.device)
    x, caches_out, _ = stack_apply(cfg, params["layers"], x, positions, caches=caches,
                                   cache_pos=cache_pos)
    return _logits(cfg, params, x[:, -1:, :])[:, 0, :], caches_out
