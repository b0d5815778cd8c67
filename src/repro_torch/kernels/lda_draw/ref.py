"""Oracles for the factored LDA z-draw.

* :func:`lda_draw_ref` materializes the theta-phi weights, takes full
  prefix sums and searches them (paper Alg. 1/3).
* :func:`boundary_ties` explains the mismatches between two draws on the
  same inputs against a float64 oracle.  Two fp32 implementations that sum
  in different orders may pick different indices only where
  stop = u * total lies within fp32 rounding of a partial-sum boundary; a
  mismatch anywhere else is a fault.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def lda_draw_ref(theta, phi, words, u):
    w = theta.float() * phi[words.long()].float()               # (B, K)
    p = torch.cumsum(w, dim=-1)
    stop = p[:, -1] * u.float()
    idx = torch.searchsorted(p, stop[:, None], right=True)[:, 0]
    return idx.clamp(max=w.shape[-1] - 1).to(torch.int32)


def tie_tolerance(K: int) -> float:
    """Relative width of the fp32 rounding band around a boundary: a sum
    of K non-negative fp32 terms is within (K-1) * 2**-24 * total of the
    exact sum, stop = total * u adds 2**-24 * total more; doubled for the
    two implementations compared."""
    return 2.0 * (K + 1) * 2.0 ** -24


def boundary_ties(a, b, theta, phi, doc_ids, words, u) -> Dict[str, int]:
    """Count the mismatches between draws ``a`` and ``b`` (both (B,) or
    (S, B) with ``u`` of the same shape; draw s of sample i uses row i)
    and how many of them are float64-checked boundary ties: every
    partial sum P[j] with min(a,b) <= j < max(a,b) lies within
    ``tie_tolerance(K) * total`` of stop.  Only mismatched samples are
    expanded to float64 weight rows."""
    a, b, u = (torch.as_tensor(np.array(x)) if isinstance(x, np.ndarray) else x
               for x in (a, b, u))
    a = a.reshape(-1).long().cpu()
    b = b.reshape(-1).long().cpu()
    u = u.reshape(-1).double().cpu()
    mis = torch.nonzero(a != b)[:, 0]
    out = {"mismatches": int(mis.numel()), "ties": 0, "faults": 0}
    if not mis.numel():
        return out
    B = torch.as_tensor(doc_ids).shape[0]
    rows = mis % B
    d = torch.as_tensor(doc_ids).long().cpu()[rows]
    w = torch.as_tensor(words).long().cpu()[rows]
    wt = theta.detach().cpu().double()[d] * phi.detach().cpu().double()[w]
    K = wt.shape[1]
    P = torch.cumsum(wt, dim=1)
    total = P[:, -1]
    stop = total * u[mis]
    lo = torch.minimum(a[mis], b[mis])
    hi = torch.maximum(a[mis], b[mis])
    j = torch.arange(K)[None, :]
    between = (j >= lo[:, None]) & (j < hi[:, None])
    gap = torch.where(between, (P - stop[:, None]).abs(), torch.zeros_like(P))
    tie = gap.max(dim=1).values <= tie_tolerance(K) * total
    out["ties"] = int(tie.sum())
    out["faults"] = out["mismatches"] - out["ties"]
    return out
