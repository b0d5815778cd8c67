"""Attention variants: GQA (qk-norm / softcap / sliding window), MLA
(compressed latents, with the absorbed decode path) and cross-attention,
the counterpart of ``repro.models.attention``.

Masking is position-based, so the same math serves train (full causal),
prefill (causal, cache write) and decode (one query against a long cache,
with one shared or a per-row position).  Scores and softmax are float32,
the softcap comes before the mask, and masked scores are ``NEG_INF``, as
in the reference; ``scaled_dot_product_attention`` has no softcap, so the
attention here is plain tensor operations.

A decode step writes its keys and values (MLA: its latents) into the
caches it is given, in place (one row per sequence, not the whole cache),
and returns them.

On a mesh (DTensor operands) the attention core runs per shard
(:func:`_per_shard`): queries, keys and values are placed with their rows
on the data axes and their heads on the model axis, as the rules place a
``("batch", None, "heads", None)`` tensor, and each rank attends its own
rows and heads (every key of them) with the same math.  DTensor's own
rules would flatten the sharded batch and heads into one dimension, which
the card's PyTorch refuses (ROADMAP.md, deliberate differences).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.dist import sharding as _shd
from repro_torch.dist.sharding import activation_mesh, constrain_activation, for_cache
from repro_torch.models.layers import (apply_rope, einsum, head_rmsnorm,
                                       head_rmsnorm_spec, rmsnorm)
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


def _per_shard(fn, q, k, v, mask=None):
    """``fn(q, k, v, mask)`` on this rank's rows and heads of DTensor
    operands (B, S, H, d) (``dist.sharding.per_shard``): a per-row (B, Sq,
    Sk) mask goes with its rows, a (Sq, Sk) mask is every rank's.  Each
    rank attends its rows and heads over every key."""
    qkv = ("batch", None, "heads", None)
    mask_axes = ("batch", None, None) if mask is not None and mask.dim() == 3 else (None, None)
    return _shd.per_shard(fn, (q, k, v, mask), (qkv, qkv, qkv, mask_axes),
                          [((q.shape[0], q.shape[1], q.shape[2], v.shape[3]), qkv)])


def _is_dtensor(*ts) -> bool:
    return any(hasattr(t, "full_tensor") for t in ts)


def _sdpa(q, k, v, mask, softcap: float = 0.0, kv_sharded: bool = False):
    """q (B,Sq,H,hd)  k (B,Sk,KV,hd)  v (B,Sk,KV,hv) -> (B,Sq,H,hv).

    A (Sq, Sk) mask broadcasts over the batch; a (B, Sq, Sk) mask is per
    row (continuous batching: each slot attends its own prefix).
    ``kv_sharded``: pin the score matrix's key axis to the cache's seq
    sharding (the activation hook; the identity without a mesh).
    DTensor operands attend per shard (:func:`_per_shard`)."""
    H = q.shape[2]
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if _is_dtensor(q, k, v):
        return _per_shard(lambda ql, kl, vl, m: _sdpa(ql, kl, vl, m, softcap), q, k, v, mask)
    scores = _scores(q, k, softcap)
    if kv_sharded:
        scores = constrain_activation(scores, ("batch", None, None, "act_kv"))
    return _attend(scores, mask[None, None] if mask.dim() == 2 else mask[:, None], v)


def _cache_update(cache_arr, new, pos):
    """Write one decode step into the cache, in place; returns the cache.

    ``pos`` is the write position shared by the batch (an int or a 0-d
    tensor), or a (B,) tensor of per-row positions (continuous batching:
    each slot writes at its own sequence length).  The reference writes
    the per-row case as a one-hot ``where`` over the whole cache; an
    indexed write of one row per sequence gives the same cache.  A
    DTensor cache whose sequence is sharded is written per shard
    (:func:`_write_per_shard`).  With an activation mesh armed, the written cache is pinned to its
    ("batch", "act_kv") layout, as the reference pins it."""
    new = for_cache(cache_arr, new).to(cache_arr.dtype)
    if _is_dtensor(cache_arr) and any(p.is_shard(1) for p in cache_arr.placements):
        _write_per_shard(cache_arr, new, pos)
    elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
        B = cache_arr.shape[0]
        cache_arr[torch.arange(B, device=cache_arr.device), pos.long()] = new[:, 0]
    else:
        S, n = cache_arr.shape[1], new.shape[1]
        start = min(max(int(pos), 0), S - n)   # dynamic_update_slice clamps the start
        cache_arr[:, start:start + n] = new
    if activation_mesh() is not None:
        cache_arr = constrain_activation(
            cache_arr, ("batch", "act_kv") + (None,) * (cache_arr.dim() - 2))
    return cache_arr


def _write_per_shard(cache_arr, new, pos) -> None:
    """Write the step into this rank's block of a DTensor cache whose
    sequence (dim 1) is sharded, in place: DTensor writes a slice of a
    sharded dim into a gathered copy, which leaves the cache as it was.
    ``pos`` is the write position shared by the batch."""
    from torch.distributed.tensor import Replicate

    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        raise ValueError("per-row positions into a sequence-sharded DTensor cache are "
                         "not supported; place the cache with its sequence whole")
    mesh, placements = cache_arr.device_mesh, cache_arr.placements
    whole_seq = _shd.NamedSharding(mesh, None, tuple(
        Replicate() if p.is_shard(1) else p for p in placements))
    if _is_dtensor(new):
        new = new.redistribute(mesh, whole_seq.placements).to_local()
    else:
        new = _shd.local_shard(new, whole_seq)
    coords = mesh.get_coordinate()
    S, n = cache_arr.shape[1], new.shape[1]
    off, size = 0, S
    for m, p in enumerate(placements):   # mesh dims in order, the first major
        if p.is_shard(1):
            size //= mesh.size(m)
            off += coords[m] * size
    start = min(max(int(pos), 0), S - n)   # dynamic_update_slice clamps the start
    lo, hi = max(start, off), min(start + n, off + size)
    if lo < hi:
        cache_arr.to_local()[:, lo - off:hi - off] = new[:, lo - start:hi - start]


def _sdpa_chunked(
    q, k, v, q_pos, k_pos, *, causal, window, k_valid=None, softcap=0.0,
    q_chunk: int = Q_CHUNK,
):
    """Flash-style q-chunked attention: a loop over query chunks, so the
    (Sq, Sk) score matrix never materializes.  Softmax per chunk is exact
    (full K per chunk).  DTensor operands attend per shard."""
    B, Sq, H, hd = q.shape
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if _is_dtensor(q, k, v):
        return _per_shard(lambda ql, kl, vl, _m: _sdpa_chunked(
            ql, kl, vl, q_pos, k_pos, causal=causal, window=window, k_valid=k_valid,
            softcap=softcap, q_chunk=q_chunk), q, k, v)
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
    out = _sdpa(q, ck, cv, mask, cfg.attn_softcap, kv_sharded=True)
    y = einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, {"k": ck, "v": cv}


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": ParamSpec((batch, max_len, kv, hd), ("batch", "kv_seq", "kv_heads", "head"), init="zeros"),
        "v": ParamSpec((batch, max_len, kv, hd), ("batch", "kv_seq", "kv_heads", "head"), init="zeros"),
    }


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head")),
        "wo": ParamSpec((h, hd, d), ("heads", "head", "embed")),
    }


def cross_attend(params, x, memory_kv, cfg: ModelConfig, memory_valid=None):
    """x (B,Sq,D) attends to precomputed memory (k, v) (B,Sk,KV,hd)."""
    B, S, _ = x.shape
    q = einsum("bsd,dnh->bsnh", x, params["wq"])
    k, v = memory_kv
    Sk = k.shape[1]
    if S > CHUNKED_THRESHOLD:
        out = _sdpa_chunked(
            q, k, v, torch.arange(S, device=x.device), torch.arange(Sk, device=x.device),
            causal=False, window=0, k_valid=memory_valid, softcap=cfg.attn_softcap,
        )
    else:
        mask = torch.ones((S, Sk), dtype=torch.bool, device=x.device)
        if memory_valid is not None:
            mask = mask & memory_valid[None, :]
        out = _sdpa(q, k, v, mask, cfg.attn_softcap)
    return einsum("bsnh,nhd->bsd", out, params["wo"])


def cross_memory(params, memory, cfg: ModelConfig):
    """Precompute cross-attention (k, v) from encoder output (B,Sk,D)."""
    k = einsum("bsd,dnh->bsnh", memory, params["wk"])
    v = einsum("bsd,dnh->bsnh", memory, params["wv"])
    return k, v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim
    return {
        "wdq": ParamSpec((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": {"scale": ParamSpec((m.q_lora_rank,), ("q_lora",), init="ones")},
        "wuq": ParamSpec(
            (m.q_lora_rank, h, qk + m.qk_rope_head_dim), ("q_lora", "heads", "head")
        ),
        "wdkv": ParamSpec(
            (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "kv_lora")
        ),
        "kv_norm": {"scale": ParamSpec((m.kv_lora_rank,), ("kv_lora",), init="ones")},
        "wuk": ParamSpec((m.kv_lora_rank, h, qk), ("kv_lora", "heads", "head")),
        "wuv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), ("kv_lora", "heads", "head")),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", "head", "embed")),
    }


def _mla_latents(params, x, positions, cfg: ModelConfig):
    """x -> (c_kv (B,S,r), k_pe (B,S,rope)) with norm + RoPE applied."""
    m: MLAConfig = cfg.mla
    dkv = einsum("bsd,dr->bsr", x, params["wdkv"])
    c_kv, k_pe = dkv[..., : m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    k_pe = apply_rope(k_pe, positions, cfg.rope_theta)
    return c_kv, k_pe


def _mla_queries(params, x, positions, cfg: ModelConfig):
    m: MLAConfig = cfg.mla
    cq = rmsnorm(params["q_norm"], einsum("bsd,dr->bsr", x, params["wdq"]), cfg.norm_eps)
    q = einsum("bsr,rnh->bsnh", cq, params["wuq"])
    q_nope = q[..., : m.qk_nope_head_dim]
    q_pe = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def mla_attend_full(params, x, positions, cfg: ModelConfig):
    """Prefill/train: expand latents to per-head k/v (the 'naive' mode).
    Returns ``(y, {"c_kv", "k_pe"})``, the latents being the decode cache."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    c_kv, k_pe = _mla_latents(params, x, positions, cfg)
    q_nope, q_pe = _mla_queries(params, x, positions, cfg)
    k_nope = einsum("bsr,rnh->bsnh", c_kv, params["wuk"])
    v = einsum("bsr,rnh->bsnh", c_kv, params["wuv"])
    q = torch.cat([q_nope, q_pe], -1)
    k_pe_h = k_pe[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_head_dim)
    k = torch.cat([k_nope, k_pe_h], -1)
    if S > CHUNKED_THRESHOLD:
        out = _sdpa_chunked(q, k, v, positions, positions, causal=True, window=0,
                            softcap=cfg.attn_softcap)
    else:
        mask = attention_mask(positions, positions, causal=True)
        out = _sdpa(q, k, v, mask, cfg.attn_softcap)
    y = einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, {"c_kv": c_kv, "k_pe": k_pe}


def mla_attend_decode(params, x, cache, cache_pos, cfg: ModelConfig):
    """Absorbed decode: score directly against the latent cache.

    q_c = q_nope @ W_uk per head; scores = q_c . c_kv + q_pe . k_pe;
    ctx = probs . c_kv; y = (ctx @ W_uv) @ wo.  ``cache_pos`` is the write
    position shared by the batch, or (B,) per row; the step's latents are
    written into ``cache`` in place (one row per sequence)."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape  # S == 1
    per_row = isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1
    if per_row:
        cache_pos = cache_pos.to(x.device).long()
        positions = cache_pos[:, None]
    else:
        positions = torch.full((S,), int(cache_pos), device=x.device)
    c_new, kpe_new = _mla_latents(params, x, positions, cfg)
    c_kv = _cache_update(cache["c_kv"], c_new, cache_pos)
    k_pe = _cache_update(cache["k_pe"], kpe_new, cache_pos)
    q_nope, q_pe = _mla_queries(params, x, positions, cfg)
    q_c = einsum("bsnh,rnh->bsnr", q_nope, params["wuk"])
    scale = float(np.float32(1.0) / np.sqrt(np.float32(m.qk_nope_head_dim + m.qk_rope_head_dim)))
    scores = (einsum("bsnr,btr->bnst", q_c, c_kv)
              + einsum("bsnh,bth->bnst", q_pe, k_pe)).to(torch.float32) * scale
    k_pos = torch.arange(c_kv.shape[1], device=c_kv.device)
    if per_row:
        valid = (k_pos[None, :] <= cache_pos[:, None])[:, None, None, :]   # (B,1,1,T)
    else:
        valid = (k_pos <= int(cache_pos))[None, None, None, :]
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1).to(c_kv.dtype)
    ctx = einsum("bnst,btr->bsnr", probs, c_kv)
    out = einsum("bsnr,rnh->bsnh", ctx, params["wuv"])
    y = einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, {"c_kv": c_kv, "k_pe": k_pe}


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    m: MLAConfig = cfg.mla
    return {
        "c_kv": ParamSpec((batch, max_len, m.kv_lora_rank), ("batch", "kv_seq", None),
                          init="zeros"),
        "k_pe": ParamSpec((batch, max_len, m.qk_rope_head_dim), ("batch", "kv_seq", None),
                          init="zeros"),
    }
