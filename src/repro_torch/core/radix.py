"""Radix-tree forest sampling (Binder & Keller, arXiv:1901.05423), the
counterpart of ``repro.core.radix``.

A forest of ``M = 2^m`` fixed-depth search trees over the normalized CDF:
the top ``m`` bits of the uniform select a root, whose stored
``[root[t], root[t+1]]`` category range bounds a fixed-trip clamped
bisection.  Every row runs the same steps (no data-dependent trip count).
The build is one cumsum plus a ``searchsorted`` for the root table.
"""

from __future__ import annotations

import math

import torch


def ceil_log2(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(2, int(n))))))


def forest_bits(K: int, cap: int = 12) -> int:
    """M ~ K roots (one expected category per root), capped."""
    return min(ceil_log2(K), cap)


def build_radix_forest(weights, m: int | None = None):
    """(B, K) non-negative weights -> ``(cdf, root)``: ``cdf`` (B, K)
    float32 inclusive normalized prefix sums, ``root`` (B, M+1) int32, the
    first category whose CDF interval can hold a uniform in [t/M, (t+1)/M).
    Zero-total rows take the uniform CDF."""
    w = torch.as_tensor(weights).to(torch.float32)
    if w.dim() != 2:
        raise ValueError(f"expected (B, K) weights, got shape {tuple(w.shape)}")
    B, K = w.shape
    m = forest_bits(K) if m is None else int(m)
    M = 1 << m
    tot = w.sum(dim=-1, keepdim=True)
    ok = tot > 0
    uni = (torch.arange(K, dtype=torch.float32, device=w.device) + 1.0) / K
    cdf = torch.where(ok, torch.cumsum(w, dim=-1) / torch.where(ok, tot, 1.0), uni)
    edges = torch.arange(M + 1, dtype=torch.float32, device=w.device) / M
    root = torch.searchsorted(cdf.contiguous(), edges.expand(B, M + 1).contiguous(),
                              right=True)
    return cdf, root.clamp(0, K - 1).to(torch.int32)


def draw_radix_forest(cdf, root, u) -> torch.Tensor:
    """One draw per row: root dispatch on the top bits of ``u``, then a
    fixed ``ceil(log2(K))``-trip clamped bisection.  (B,) int32."""
    B, K = cdf.shape
    M = root.shape[-1] - 1
    u = torch.as_tensor(u, device=cdf.device).to(torch.float32)
    t = torch.clamp((u * M).to(torch.int32), max=M - 1).long()
    rootl = root.long()
    lo = torch.gather(rootl, 1, t[:, None])[:, 0]
    hi = torch.gather(rootl, 1, t[:, None] + 1)[:, 0]
    for _ in range(ceil_log2(K)):
        mid = (lo + hi) >> 1
        cm = torch.gather(cdf, 1, mid[:, None])[:, 0]
        go = cm <= u
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return torch.clamp(lo, max=K - 1).to(torch.int32)
