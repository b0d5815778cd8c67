"""Attention: GQA with qk-norm, softcap and sliding windows, the
counterpart of the GQA part of ``repro.models.attention``.

Masking is position-based, so the same math serves train (full causal),
prefill (causal, cache write) and decode (one query against a long cache,
with one shared or a per-row position).  Scores and softmax are float32,
the softcap comes before the mask, and masked scores are ``NEG_INF``, as
in the reference; ``scaled_dot_product_attention`` has no softcap, so the
attention here is plain tensor operations.

A decode step writes its keys and values into the caches it is given, in
place (one row per sequence, not the whole cache), and returns them.

MLA and cross-attention come with the remaining model families (ROADMAP
queue 1, slice 12b).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, einsum, head_rmsnorm, head_rmsnorm_spec
from repro_torch.models.params import ParamSpec

NEG_INF = -2.0e38

CHUNKED_THRESHOLD = 4096  # q lengths above this use the chunked path
Q_CHUNK = 256


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def attention_mask(
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool = True,
    window: int = 0,      # 0 = full attention
    k_valid: Optional[torch.Tensor] = None,  # (Sk,) bool
) -> torch.Tensor:
    """(Sq, Sk) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=k_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if int(window) > 0:
        m &= k_pos[None, :] > q_pos[:, None] - int(window)
    if k_valid is not None:
        m &= k_valid[None, :]
    return m


def _repeat_kv(k, H):
    """(B,S,KV,hd) -> (B,S,H,hd): each kv head repeated for its group of
    H / KV query heads (``jnp.repeat`` along the heads axis)."""
    KV = k.shape[2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=2)


def _scores(q, k, softcap: float):
    """fp32 scaled (and softcapped) scores, (B, H, Sq, Sk)."""
    # 1 / sqrt(float32(hd)) as a host float (exact in float32): no copy
    # to the device per call
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    scores = einsum("bqhe,bshe->bhqs", q, k).to(torch.float32) * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    return scores


def _attend(scores, mask, v):
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(v.dtype)
    return einsum("bhqs,bshv->bqhv", probs, v)


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q (B,Sq,H,hd)  k (B,Sk,KV,hd)  v (B,Sk,KV,hv) -> (B,Sq,H,hv).

    A (Sq, Sk) mask broadcasts over the batch; a (B, Sq, Sk) mask is per
    row (continuous batching: each slot attends its own prefix)."""
    H = q.shape[2]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scores = _scores(q, k, softcap)
    return _attend(scores, mask[None, None] if mask.dim() == 2 else mask[:, None], v)


def _cache_update(cache_arr, new, pos):
    """Write one decode step into the cache, in place; returns the cache.

    ``pos`` is the write position shared by the batch (an int or a 0-d
    tensor), or a (B,) tensor of per-row positions (continuous batching:
    each slot writes at its own sequence length).  The reference writes
    the per-row case as a one-hot ``where`` over the whole cache; an
    indexed write of one row per sequence gives the same cache."""
    new = new.to(cache_arr.dtype)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        B = cache_arr.shape[0]
        cache_arr[torch.arange(B, device=cache_arr.device), pos.long()] = new[:, 0]
        return cache_arr
    S, n = cache_arr.shape[1], new.shape[1]
    start = min(max(int(pos), 0), S - n)   # dynamic_update_slice clamps the start
    cache_arr[:, start:start + n] = new
    return cache_arr


def _sdpa_chunked(
    q, k, v, q_pos, k_pos, *, causal, window, k_valid=None, softcap=0.0,
    q_chunk: int = Q_CHUNK,
):
    """Flash-style q-chunked attention: a loop over query chunks, so the
    (Sq, Sk) score matrix never materializes.  Softmax per chunk is exact
    (full K per chunk)."""
    B, Sq, H, hd = q.shape
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    outs = []
    for s0 in range(0, Sq, q_chunk):
        qi, pi = q[:, s0:s0 + q_chunk], q_pos[s0:s0 + q_chunk]
        m = attention_mask(pi, k_pos, causal=causal, window=window, k_valid=k_valid)
        outs.append(_attend(_scores(qi, k, softcap), m[None, None], v))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    spec = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head")),
        "wo": ParamSpec((h, hd, d), ("heads", "head", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = head_rmsnorm_spec(hd)
        spec["k_norm"] = head_rmsnorm_spec(hd)
    return spec


def gqa_project_qkv(params, x, positions, cfg: ModelConfig):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,KV,hd), with RoPE + qk-norm."""
    q = einsum("bsd,dnh->bsnh", x, params["wq"])
    k = einsum("bsd,dnh->bsnh", x, params["wk"])
    v = einsum("bsd,dnh->bsnh", x, params["wv"])
    if cfg.qk_norm:
        q = head_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    causal: bool = True,
    window: int = 0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, object]:
    """Self-attention over a full block (train/prefill) or one decode step.

    Full block: returns ``(y, (k, v))``.  Decode: ``cache`` holds (k, v)
    of length S_max, ``cache_pos`` is the write position (an int, a 0-d
    tensor, or (B,) per row); returns ``(y, cache)`` with the step written
    into the cache in place."""
    B, S, _ = x.shape
    q, k, v = gqa_project_qkv(params, x, positions, cfg)
    if cache is None:
        if S > CHUNKED_THRESHOLD:
            out = _sdpa_chunked(
                q, k, v, positions, positions, causal=causal, window=window,
                softcap=cfg.attn_softcap,
            )
        else:
            mask = attention_mask(positions, positions, causal=causal, window=window)
            out = _sdpa(q, k, v, mask, cfg.attn_softcap)
        y = einsum("bsnh,nhd->bsd", out, params["wo"])
        return y, (k, v)
    ck = _cache_update(cache["k"], k, cache_pos)
    cv = _cache_update(cache["v"], v, cache_pos)
    k_pos = torch.arange(ck.shape[1], device=ck.device)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        # per-row positions: row b attends its OWN prefix k <= pos_b (and
        # its own window), so one fixed-shape decode batch can hold
        # sequences of different lengths
        qp = cache_pos.to(k_pos.device).long()[:, None]              # (B, Sq=1)
        mask = k_pos[None, None, :] <= qp[:, :, None]                # (B, Sq, Sk)
        if int(window) > 0:
            mask &= k_pos[None, None, :] > qp[:, :, None] - int(window)
    else:
        p = int(cache_pos)
        # window relative to the *query* position (cache_pos), not k order
        mask = attention_mask(torch.full(tuple(positions.shape[-1:]), p, device=k_pos.device),
                              k_pos, causal=False, window=window, k_valid=k_pos <= p)
    out = _sdpa(q, ck, cv, mask, cfg.attn_softcap)
    y = einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, {"k": ck, "v": cv}


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": ParamSpec((batch, max_len, kv, hd), ("batch", "kv_seq", "kv_heads", "head"), init="zeros"),
        "v": ParamSpec((batch, max_len, kv, hd), ("batch", "kv_seq", "kv_heads", "head"), init="zeros"),
    }
