"""Oracles for the draw on given weights.

* ``butterfly_sample_ref`` — full prefix sums and a search (paper
  Alg. 1/3), as the reference's ``butterfly_sample/ref.py``: the port's
  ``core.reference.draw_prefix``.
* :func:`boundary_ties` — the given-weights form of
  ``lda_draw.ref.boundary_ties``: explains the mismatches between two
  draws on the same (B, K) weights against a float64 oracle.
* :func:`trunc_boundary_ties` — the same for truncated draws, with
  :func:`trunc_tau64`, the float64 threshold oracle, and
  :func:`cuda_sum_depth`, how deep the sums on the card are.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.reference import draw_prefix as butterfly_sample_ref
from repro_torch.kernels.lda_draw import ref as _lref

__all__ = ["boundary_ties", "butterfly_sample_ref", "cuda_sum_depth", "trunc_boundary_ties",
           "trunc_tau64"]


def boundary_ties(a, b, weights, u) -> Dict[str, int]:
    """Mismatches between draws ``a`` and ``b`` ((B,) or (S, B), ``u`` of
    the same shape; draw s of row i uses row i of ``weights``) and how
    many are float64-checked boundary ties (see
    ``lda_draw.ref.boundary_ties``): the weights are the factor theta
    times an all-ones phi row."""
    w = torch.as_tensor(weights)
    B, K = w.shape
    rows = torch.arange(B)
    ones = torch.ones((1, K), dtype=w.dtype, device=w.device)
    return _lref.boundary_ties(a, b, w, ones, rows, torch.zeros_like(rows), u)


def cuda_sum_depth(K: int) -> int:
    """Most fp32 additions any weight of a row of K passes through in the
    sums that decide a truncated draw on the card: K9's and K11's
    per-thread runs of ceil(K/1024) terms, 5 xor levels and 31 warp
    partials; K9/K11/K12's W-block sums and running scan (W + nb terms);
    PyTorch's CUDA reductions, which keep at least one warp of 32 threads
    on a row (so at most ceil(K/32) terms per accumulator) and then add at
    most 4 accumulators, 9 levels of a 512-thread block and a final pass
    over the partials of several blocks; and its scans (at most nb terms).
    Every one of these is at most ceil(K/32) + 64."""
    return -(-K // 32) + 64


def trunc_tau64(weights, params, depth=None):
    """Float64 oracle of ``transforms.thresholds_from_params``:
    ``(tau, lo, hi)``.  ``tau`` is the exact threshold; ``[lo, hi]`` holds
    every tau that an fp32 implementation may return when each of its sums
    is within ``depth * 2**-24`` of the exact sum relative to the row total
    (``depth`` additions deep; default K, any order).  top-k and min-p are
    exact (a count, a product), so ``lo == hi == tau`` unless top-p is on
    and a candidate threshold v has its masked sum S(v) = sum(w[w >= v]) or
    S(v+) = sum(w[w > v]) within ``lda_draw.ref.tie_tolerance(depth) *
    total`` of p * total: the bisection keeps the largest v with S(v) >=
    p * total, and rounding can flip only those comparisons."""
    w = torch.as_tensor(weights).detach().cpu().to(torch.float64)
    prm = torch.as_tensor(params).detach().cpu().to(torch.float64)
    B, K = w.shape
    depth = K if depth is None else depth
    ws = torch.sort(w, dim=1, descending=True).values
    k, p, mp = prm[:, 0], prm[:, 1], prm[:, 2]
    kth = torch.gather(ws, 1, (torch.ceil(k).long() - 1).clamp(0, K - 1)[:, None])[:, 0]
    tau = torch.where((k > 0) & (torch.ceil(k) <= K), kth, torch.zeros_like(kth))
    # S(v) and S(v+) at every value v of the row that survives top-k
    surv = torch.where(w >= tau[:, None], w, torch.zeros_like(w))
    asc = torch.sort(surv, dim=1).values
    cum = torch.cumsum(asc.flip(1), dim=1)  # cum[:, j]: the j+1 largest
    total = cum[:, -1]
    zero = torch.zeros((B, 1), dtype=cum.dtype)
    cum0 = torch.cat([zero, cum], dim=1)  # cum0[:, n]: the n largest
    n_ge = K - torch.searchsorted(asc, asc, right=False)
    n_gt = K - torch.searchsorted(asc, asc, right=True)
    s_ge = torch.gather(cum0, 1, n_ge)
    s_gt = torch.gather(cum0, 1, n_gt)
    target = (p * total)[:, None]
    tol = (_lref.tie_tolerance(depth) * total)[:, None]
    cand = asc >= tau[:, None]
    exact = cand & (s_ge >= target) & (s_gt < target)
    ok = cand & (s_ge >= target - tol) & (s_gt < target + tol)
    neg = torch.full_like(asc, -1.0)
    big = torch.full_like(asc, float("inf"))
    top_p = p < 1.0
    tp = torch.where(exact, asc, neg).max(dim=1).values
    lo = torch.where(ok, asc, big).min(dim=1).values
    hi = torch.where(ok, asc, neg).max(dim=1).values
    tau_p = torch.where(top_p, torch.maximum(tau, tp), tau)
    # the exact tau is in the range even where no value passes (a zero row)
    lo = torch.where(top_p, torch.minimum(torch.maximum(tau, lo), tau_p), tau)
    hi = torch.where(top_p, torch.maximum(tau_p, hi), tau)
    rowmax = ws[:, 0].to(torch.float32)
    minp = (mp.to(torch.float32) * rowmax).to(torch.float64)
    on = mp > 0
    tau_p, lo, hi = (torch.where(on, torch.maximum(t, minp), t) for t in (tau_p, lo, hi))
    return tau_p, lo, hi


def trunc_boundary_ties(a, b, weights, u, params, depth=None) -> Dict[str, int]:
    """Mismatches between truncated draws ``a`` and ``b`` ((B,) or (S, B),
    ``u`` of the same shape) and how many are float64-checked ties: each
    of the two draws lies within fp32 rounding (``depth``, as in
    :func:`trunc_tau64`) of the float64 draw on the row masked by some
    tau of the row's range ``[lo, hi]``.  Where the range is one tau, this
    is the test of ``boundary_ties`` on the row masked by the exact tau."""
    a, b, u = (torch.as_tensor(np.array(x)) if isinstance(x, np.ndarray) else x
               for x in (a, b, u))
    w = torch.as_tensor(weights)
    B, K = w.shape
    depth = K if depth is None else depth
    a = a.reshape(-1).long().cpu()
    b = b.reshape(-1).long().cpu()
    u = u.reshape(-1).double().cpu()
    mis = torch.nonzero(a != b)[:, 0]
    out = {"mismatches": int(mis.numel()), "ties": 0, "faults": 0}
    if not mis.numel():
        return out
    rows = torch.unique(mis % B)
    wr = w[rows.to(w.device)].detach().cpu().to(torch.float64)
    _, lo, hi = trunc_tau64(wr, torch.as_tensor(params)[rows.to(w.device)], depth)
    pos = {int(r): i for i, r in enumerate(rows)}
    ties = 0
    for m in mis.tolist():
        i = pos[m % B]
        row = wr[i]
        # one mask per distinct tau in [lo, hi]: lo, then each value above it
        vals = torch.unique(row[(row > lo[i]) & (row <= hi[i])])
        cands = torch.cat([lo[i:i + 1], vals])
        ok = torch.zeros(2, dtype=torch.bool)
        for c in cands.split(16):
            masked = torch.where(row[None, :] >= c[:, None], row[None, :], 0.0)
            P = torch.cumsum(masked, dim=1)
            stop = P[:, -1] * u[m]
            d = torch.searchsorted(P, stop[:, None], right=True)[:, 0].clamp(max=K - 1)
            for j, x in enumerate((a[m], b[m])):
                xs = x.expand(len(c))
                ok[j] |= bool(_tie_mask(xs, d, masked, u[m].expand(len(c)), depth).any())
        ties += int(ok.all())
    out["ties"] = ties
    out["faults"] = out["mismatches"] - ties
    return out


def _tie_mask(a, b, w64, u, depth: int) -> torch.Tensor:
    """Per draw: stop within fp32 rounding (sums ``depth`` additions deep)
    of every partial sum between the two indices (the test of
    ``boundary_ties``), on float64 rows."""
    K = w64.shape[1]
    P = torch.cumsum(w64, dim=1)
    total = P[:, -1]
    stop = total * u.double()
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    j = torch.arange(K)[None, :]
    between = (j >= lo[:, None]) & (j < hi[:, None])
    gap = torch.where(between, (P - stop[:, None]).abs(), torch.zeros_like(P))
    return gap.max(dim=1).values <= _lref.tie_tolerance(depth) * total
