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

On a mesh (DTensor operands) attention runs per shard, its operands
placed by this module, with rows on the data axes and, by what the
``model`` degree divides:

* the heads (:func:`_sdpa_mesh`, :func:`_per_shard`), as the rules
  place a ``("batch", None, "heads", None)`` tensor: each rank attends
  its own rows and heads over every key;
* else, in train and prefill, the query positions (the ``act_seq`` rule):
  each rank takes its rows' block of positions of the layer's input, as
  the residual stream is placed, and runs the whole branch on local
  tensors (:class:`_OwnPositions`): the queries' projection (qk-norm and
  RoPE on the block's positions; MLA's ``wdq``, ``q_norm``, ``wuq``),
  the keys' and values' on its own positions (MLA's latents and their
  expansion), gathered over ``model`` for the core (their gradients
  reduce-scattered back), the core of its block over every key, and
  ``wo``; the output comes back with its positions over ``model``.  The
  weights are gathered whole (no head is split), so each projection and
  both its gradients cost 1/``model`` of the positions' work.
  Cross-attention takes its memory's keys and values whole along their
  sequence;
* else, in decode, the cache's keys as the cache is placed
  (:func:`_sdpa_mesh`, :func:`_key_blocks`, flash-decoding): each rank attends all heads over
  its own block of keys, and the blocks combine by log-sum-exp, two
  all-reduces of (B, H)- and (B, H, hv)-sized tensors a layer
  (:func:`_lse_combine`; MLA's absorbed decode likewise,
  :func:`_mla_ctx_blocks`).  The values match the unsharded path within
  float32 rounding, not bit for bit (ROADMAP.md, deliberate differences).

Where neither the heads nor the positions divide, every ``model`` rank
attends every head of its rows, whole (``MESH_PATHS["whole"]``).
DTensor's own rules would flatten the sharded batch and heads into one
dimension, which the card's PyTorch refuses (ROADMAP.md, deliberate
differences).  ``MESH_PATHS`` counts the calls that took each path.
"""

from __future__ import annotations

from collections import Counter
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

# calls on a mesh by the path they took (module docstring): "heads",
# "queries", "keys", "whole"
MESH_PATHS: Counter = Counter()


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


def _free_model_dim(mesh, H: int) -> Optional[int]:
    """The ``model`` mesh dim when it is larger than 1 and the ``heads``
    rule leaves it unused (``H`` does not divide it), else None."""
    md = _shd.model_dim(mesh)
    if md is None:
        return None
    heads = _shd.named_sharding((1, 1, H, 1), (None, None, "heads", None), mesh)
    return None if heads.placements[md].is_shard() else md


def _sdpa_mesh(core, q, k, v, mask=None, q_pos=None, softcap: float = 0.0,
               kv_sharded: bool = False):
    """``core(q, k, v, mask, q_pos)`` (the plain attention) on DTensor
    operands, each rank on its own block: over the heads where ``model``
    divides them, else in decode (``kv_sharded``) over the cache's keys
    (module docstring)."""
    mesh = _shd.mesh_of(q, k, v)
    H = q.shape[2]
    md = _free_model_dim(mesh, H)
    if md is not None and kv_sharded:
        MESH_PATHS["keys"] += 1
        return _key_blocks(q, k, v, mask, softcap, mesh)
    if md is not None:
        # The heads do not divide the model degree.  A full block whose
        # positions divide it never comes here: its callers run it on each
        # rank's own positions (_OwnPositions).  So every model rank gathers
        # the keys and values of its rows and attends every head of them
        MESH_PATHS["whole"] += 1
    else:
        MESH_PATHS["heads"] += 1
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    return _per_shard(lambda ql, kl, vl, m: core(ql, kl, vl, m, q_pos), q, k, v, mask)


class _OwnPositions:
    """The ``queries`` path with its projections on local tensors: each
    rank takes its rows' block of positions of ``x`` (B, S, D), as the
    residual stream is placed between layers (``activation_layout``), and
    the weights named ``names`` whole (every mesh dim gathered: ``model``
    splits no head, so only ``embed`` and MLA's latent ranks are split).
    A weight's gradient is this rank's partial sum over its rows and
    positions, reduced over ``model`` and the mesh dims that split the
    rows into the weight's own placements in the backward pass.
    :meth:`gather` gives keys and values every position of the rank's
    rows, their gradients reduce-scattered back; :meth:`wrap` makes a
    local result a DTensor with its positions over ``model``."""

    def __init__(self, params, x, mesh, md: int, names):
        from torch.distributed.tensor import Partial, Replicate

        MESH_PATHS["queries"] += 1
        self.mesh, self.lead = mesh, tuple(x.shape[:2])
        self.rows, self.own = _shd.activation_layout(x.shape, mesh)
        self.rows_grad = [Partial() if d == md else p for d, p in enumerate(self.rows)]
        summed = [Partial() if d == md or p.is_shard() else Replicate()
                  for d, p in enumerate(self.rows)]
        whole = [Replicate()] * mesh.ndim

        def local(w):
            if isinstance(w, dict):
                return {k: local(v) for k, v in w.items()}
            return _shd.local_block(w, mesh, whole, summed)

        self.params = {k: local(params[k]) for k in names}
        self.x = _shd.local_block(x, mesh, self.own)
        self.s0, self.n = _shd.shard_offset(x.shape[1], 1, mesh, self.own)

    def positions(self, pos):
        """The block's own positions of ``pos`` (..., S)."""
        return _shd.whole(pos)[..., self.s0:self.s0 + self.n]

    def gather(self, t):
        """A local tensor of the block's positions (B_l, S_l, ...) with
        every position of the rank's rows; its gradient reduce-scattered
        back."""
        full = _shd.from_local_block(t, self.mesh, self.own, self.lead + tuple(t.shape[2:]))
        return self.rows_of(full)

    def rows_of(self, t):
        """The rank's rows of ``t`` (B, Sk, ...), every position; its
        gradient a partial sum over ``model``."""
        return _shd.local_block(t, self.mesh, self.rows, self.rows_grad)

    def wrap(self, t):
        """A local result of the block's positions as a DTensor placed as
        the residual stream."""
        return _shd.from_local_block(t, self.mesh, self.own, self.lead + tuple(t.shape[2:]))


def _own_positions(params, x, H: int, names) -> Optional[_OwnPositions]:
    """An :class:`_OwnPositions` where a full block takes the ``queries``
    path (a mesh whose ``model`` dim the heads leave free and the
    positions divide), else None."""
    mesh = _shd.mesh_of(x, *(params[k] for k in names if not isinstance(params[k], dict)))
    if mesh is None or x.dim() != 3:
        return None
    md = _free_model_dim(mesh, H)
    if md is None or not _shd.activation_layout(x.shape, mesh)[1][md].is_shard(1):
        return None
    return _OwnPositions(params, x, mesh, md, names)


def _block_core(q, k, v, q_pos, k_pos, S: int, *, causal: bool, window: int = 0,
                k_valid=None, softcap: float = 0.0):
    """Attention of a full block of queries (positions ``q_pos``) over keys
    at ``k_pos``: q-chunked where the block's whole sequence ``S`` exceeds
    ``CHUNKED_THRESHOLD``."""
    if S > CHUNKED_THRESHOLD:
        return _sdpa_chunked(q, k, v, q_pos, k_pos, causal=causal, window=window,
                             k_valid=k_valid, softcap=softcap)
    mask = attention_mask(q_pos, k_pos, causal=causal, window=window, k_valid=k_valid)
    return _sdpa(q, k, v, mask, softcap)


def _key_blocks(q, k, v, mask, softcap: float, mesh):
    """Decode where ``model`` does not divide the heads (flash-decoding):
    each rank attends its rows, all heads, over its own block of the
    cache's keys (the cache's local shard, as ``_write_per_shard``
    addresses it), and the blocks combine by log-sum-exp
    (:func:`_lse_combine`).  ``mask`` is (Sq, Sk) or per row (B, Sq, Sk)."""
    kv_pl, row_pl = _kv_blocks(mesh, k)
    ql = _shd.local_block(q, mesh, row_pl)
    kl, vl = (_shd.local_block(t, mesh, kv_pl) for t in (k, v))
    valid = _mask_block(mask, mesh, kv_pl)
    H = q.shape[2]
    kl, vl = _repeat_kv(kl, H), _repeat_kv(vl, H)
    scores = torch.where(valid, _scores(ql, kl, softcap), NEG_INF)
    out = _lse_combine(*_block_softmax(scores, valid), vl, "bhqs,bshv->bqhv", mesh, kv_pl)
    return _shd.from_local_block(out, mesh, row_pl, (q.shape[0], q.shape[1], H, v.shape[3]))


def _kv_blocks(mesh, k):
    """The placements of a decode cache's blocks as the cache is placed,
    its rows and sequence only (a cache every rank holds whole: its rows
    by the rules), and of the queries' rows that go with them."""
    from torch.distributed.tensor import Replicate, Shard

    if hasattr(k, "full_tensor"):
        kv_pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in k.placements]
    else:
        kv_pl = list(_shd.named_sharding(tuple(k.shape), ("batch",) + (None,) * (k.dim() - 1),
                                         mesh).placements)
    return kv_pl, [Shard(0) if p.is_shard(0) else Replicate() for p in kv_pl]


def _mask_block(mask, mesh, kv_pl):
    """This rank's block of a decode mask, (Sq, Sk) or per row (B, Sq, Sk),
    broadcast to the scores' (B, H, Sq, Sk): the block's keys (and rows)."""
    from torch.distributed.tensor import Replicate, Shard

    if mask.dim() == 2:
        pl = [Shard(1) if p.is_shard(1) else Replicate() for p in kv_pl]
    else:
        pl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(1) else Replicate()
              for p in kv_pl]
    m = _shd.local_block(mask, mesh, pl)
    return m[None, None] if m.dim() == 2 else m[:, None]


def _block_softmax(scores, valid):
    """A block's masked float32 scores (B, H, Sq, Sk) -> (max m, the
    unnormalized probabilities exp(s - m), their sum l).  A block with no
    valid key adds exactly 0 (its m is ``NEG_INF``)."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    return m, p, p.sum(dim=-1, keepdim=True)


def _lse_combine(m, p, l, v, eq: str, mesh, kv_pl):
    """Combine the blocks of keys by log-sum-exp: ``o = einsum(eq, p, v)``
    (B, Sq, H, d) of this rank's block, then over every mesh dim that
    splits the keys an all-reduce (max) of ``m``, ``l`` and ``o`` rescaled
    by exp(m - max), one all-reduce (sum) of both, and ``o / l`` (a tensor
    by a tensor), in ``v``'s dtype."""
    import torch.distributed._functional_collectives as funcol

    def reduce(t, op, md):
        t = funcol.all_reduce(t, op, (mesh, md))
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t

    dims = [md for md, pl in enumerate(kv_pl) if pl.is_shard(1)]
    o = einsum(eq, p.to(v.dtype), v).to(torch.float32)
    m_all = m
    for md in dims:
        m_all = reduce(m_all, "max", md)
    alpha = torch.exp(m - m_all).permute(0, 2, 1, 3)   # (B, Sq, H, 1); NEG_INF blocks: 0
    lo = torch.cat([o * alpha, l.permute(0, 2, 1, 3) * alpha], dim=-1)
    for md in dims:
        lo = reduce(lo, "sum", md)
    return (lo[..., :-1] / lo[..., -1:]).to(v.dtype)


def _sdpa(q, k, v, mask, softcap: float = 0.0, kv_sharded: bool = False):
    """q (B,Sq,H,hd)  k (B,Sk,KV,hd)  v (B,Sk,KV,hv) -> (B,Sq,H,hv).

    A (Sq, Sk) mask broadcasts over the batch; a (B, Sq, Sk) mask is per
    row (continuous batching: each slot attends its own prefix).
    ``kv_sharded``: a decode step against the cache.  DTensor operands
    attend per shard (:func:`_sdpa_mesh`)."""
    if _is_dtensor(q, k, v):
        return _sdpa_mesh(lambda ql, kl, vl, m, _p: _sdpa(ql, kl, vl, m, softcap),
                          q, k, v, mask, softcap=softcap, kv_sharded=kv_sharded)
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
    (full K per chunk).  DTensor operands attend per shard
    (:func:`_sdpa_mesh`)."""
    B, Sq, H, hd = q.shape
    if _is_dtensor(q, k, v):
        return _sdpa_mesh(lambda ql, kl, vl, _m, pl: _sdpa_chunked(
            ql, kl, vl, pl, k_pos, causal=causal, window=window, k_valid=k_valid,
            softcap=softcap, q_chunk=q_chunk), q, k, v, q_pos=q_pos)
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
    into the cache in place.  A full block on the ``queries`` path runs
    on each rank's own positions (:class:`_OwnPositions`): its keys and
    values are gathered over ``model`` for the core, and the output and
    the returned keys and values keep their positions over ``model``."""
    B, S, _ = x.shape
    if cache is None:
        own = _own_positions(params, x, cfg.num_heads, tuple(params))
        p, xl, q_pos = (own.params, own.x, own.positions(positions)) if own else \
            (params, x, positions)
        q, k, v = gqa_project_qkv(p, xl, q_pos, cfg)
        out = _block_core(q, *((own.gather(k), own.gather(v)) if own else (k, v)), q_pos,
                          positions, S, causal=causal, window=window, softcap=cfg.attn_softcap)
        y = einsum("bsnh,nhd->bsd", out, p["wo"])
        return (own.wrap(y), (own.wrap(k), own.wrap(v))) if own else (y, (k, v))
    q, k, v = gqa_project_qkv(params, x, positions, cfg)
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
    """x (B,Sq,D) attends to precomputed memory (k, v) (B,Sk,KV,hd).  On
    the ``queries`` path the queries and the output are each rank's own
    positions (:class:`_OwnPositions`), over the memory's every key."""
    B, S, _ = x.shape
    k, v = memory_kv
    q_pos = torch.arange(S, device=x.device)
    own = _own_positions(params, x, cfg.num_heads, ("wq", "wo"))
    p, xl = (own.params, own.x) if own else (params, x)
    if own:
        k, v, q_pos = own.rows_of(k), own.rows_of(v), own.positions(q_pos)
    q = einsum("bsd,dnh->bsnh", xl, p["wq"])
    out = _block_core(q, k, v, q_pos, torch.arange(k.shape[1], device=x.device), S,
                      causal=False, k_valid=memory_valid, softcap=cfg.attn_softcap)
    y = einsum("bsnh,nhd->bsd", out, p["wo"])
    return own.wrap(y) if own else y


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
    Returns ``(y, {"c_kv", "k_pe"})``, the latents being the decode cache.
    On the ``queries`` path each rank projects and expands its own
    positions (:class:`_OwnPositions`) and gathers its keys and values
    over ``model``."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    own = _own_positions(params, x, cfg.num_heads, tuple(params))
    p, xl, q_pos = (own.params, own.x, own.positions(positions)) if own else \
        (params, x, positions)
    c_kv, k_pe = _mla_latents(p, xl, q_pos, cfg)
    q_nope, q_pe = _mla_queries(p, xl, q_pos, cfg)
    k_nope = einsum("bsr,rnh->bsnh", c_kv, p["wuk"])
    v = einsum("bsr,rnh->bsnh", c_kv, p["wuv"])
    kp = k_pe
    if own:
        k_nope, v, kp = own.gather(k_nope), own.gather(v), own.gather(k_pe)
    q = torch.cat([q_nope, q_pe], -1)
    k_pe_h = kp[:, :, None, :].expand(*k_nope.shape[:3], m.qk_rope_head_dim)
    k = torch.cat([k_nope, k_pe_h], -1)
    out = _block_core(q, k, v, q_pos, positions, S, causal=True, softcap=cfg.attn_softcap)
    y = einsum("bsnh,nhd->bsd", out, p["wo"])
    if own:
        return own.wrap(y), {"c_kv": own.wrap(c_kv), "k_pe": own.wrap(k_pe)}
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
    k_pos = torch.arange(c_kv.shape[1], device=c_kv.device)
    if per_row:
        mask = k_pos[None, None, :] <= cache_pos[:, None, None]   # (B,1,T)
    else:
        mask = (k_pos <= int(cache_pos))[None, :]                 # (1,T)
    mesh = _shd.mesh_of(q_c, c_kv)
    if mesh is not None and _free_model_dim(mesh, q_c.shape[2]) is not None:
        ctx = _mla_ctx_blocks(q_c, q_pe, c_kv, k_pe, mask, scale, mesh)
    else:
        scores = (einsum("bsnr,btr->bnst", q_c, c_kv)
                  + einsum("bsnh,bth->bnst", q_pe, k_pe)).to(torch.float32) * scale
        valid = mask[None, None] if mask.dim() == 2 else mask[:, None]   # (B|1,1,1,T)
        probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1).to(c_kv.dtype)
        ctx = einsum("bnst,btr->bsnr", probs, c_kv)
    out = einsum("bsnr,rnh->bsnh", ctx, params["wuv"])
    y = einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, {"c_kv": c_kv, "k_pe": k_pe}


def _mla_ctx_blocks(q_c, q_pe, c_kv, k_pe, mask, scale: float, mesh):
    """The absorbed decode's context where ``model`` does not divide the
    heads: each rank scores its rows, all heads, against its own block of
    the latent cache (``c_kv``, ``k_pe``), and ``ctx = probs . c_kv``
    combines over the blocks by log-sum-exp (:func:`_lse_combine`), before
    ``wuv`` and ``wo``."""
    MESH_PATHS["keys"] += 1
    kv_pl, row_pl = _kv_blocks(mesh, c_kv)
    qc, qp = (_shd.local_block(t, mesh, row_pl) for t in (q_c, q_pe))
    cl, kl = (_shd.local_block(t, mesh, kv_pl) for t in (c_kv, k_pe))
    valid = _mask_block(mask, mesh, kv_pl)
    scores = (einsum("bsnr,btr->bnst", qc, cl)
              + einsum("bsnh,bth->bnst", qp, kl)).to(torch.float32) * scale
    scores = torch.where(valid, scores, NEG_INF)
    ctx = _lse_combine(*_block_softmax(scores, valid), cl, "bnst,btr->bsnr", mesh, kv_pl)
    return _shd.from_local_block(ctx, mesh, row_pl, tuple(q_c.shape))


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    m: MLAConfig = cfg.mla
    return {
        "c_kv": ParamSpec((batch, max_len, m.kv_lora_rank), ("batch", "kv_seq", None),
                          init="zeros"),
        "k_pe": ParamSpec((batch, max_len, m.qk_rope_head_dim), ("batch", "kv_seq", None),
                          init="zeros"),
    }
