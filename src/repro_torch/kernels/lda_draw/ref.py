"""Oracles for the factored LDA z-draw.

* :func:`lda_draw_ref` materializes the theta-phi weights, takes full
  prefix sums and searches them (paper Alg. 1/3).
* :func:`boundary_ties` explains the mismatches between two draws on the
  same inputs against a float64 oracle.  Two fp32 implementations that sum
  in different orders may pick different indices only where
  stop = u * total lies within fp32 rounding of a partial-sum boundary; a
  mismatch anywhere else is a fault.
* :func:`fused_warp_order_torch` and :func:`fused_group_order_torch` — K8's
  two layouts as exact-order models of the card's arithmetic: one warp per
  draw (one column a lane), and a group of W / 4 lanes per draw (four
  columns a lane).  They make the same fp32 adds in the same order, so
  they agree bit for bit.
* :func:`walk_group_order_torch` — K7's group layout (a group of W / 4
  lanes per draw over a prebuilt running row), whose adds are
  ``lda_walk_torch``'s.
* :func:`blocksums_warp_order_torch` and :func:`blocksums_group_order_torch`
  — K6's two layouts (pass A alone): the running block sums as one warp per
  sample and as a group of W / 4 lanes per sample form them, bit-equal.
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


# butterfly_sample.ref imports this module, so the models below import it
# (and butterfly_sample.kernel) where they run.


def _products(theta, phi, doc_ids, words, W: int) -> torch.Tensor:
    """(Bt, nb * W) float32 products theta[doc_ids] * phi[words] as the
    kernels form them (one fp32 multiply each), zero past the row width."""
    th = torch.as_tensor(theta).to(torch.float32)[torch.as_tensor(doc_ids).long()]
    ph = torch.as_tensor(phi).to(torch.float32)[torch.as_tensor(words).long()]
    K = th.shape[1]
    return torch.nn.functional.pad(th * ph, (0, -(-K // W) * W - K))


def fused_warp_order_torch(theta, phi, doc_ids, words, u, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) as K8's warp layout makes them: the
    block sums of ``warp_block_sums`` (per 32-column piece an xor tree over
    one column a lane, a block's pieces in order) and ``warp_running``'s
    scan (``butterfly_sample.ref.masked_blocksums_warp_order_torch`` with
    nothing masked), then ``warp_draw_tile``'s select, Fenwick table of the
    selected block and descent (``butterfly_sample.kernel.walk_torch``)."""
    from repro_torch.kernels.butterfly_sample import kernel as _k
    from repro_torch.kernels.butterfly_sample import ref as _bref

    prod = _products(theta, phi, doc_ids, words, W)
    Bt, Kp = prod.shape
    run = _bref.masked_blocksums_warp_order_torch(
        prod, torch.full((Bt,), -float("inf")), W, Kp // W)
    u = torch.as_tensor(u, dtype=torch.float32)
    return _k.walk_torch(prod, run, u, torch.arange(Bt), W)


def fused_group_order_torch(theta, phi, doc_ids, words, u, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) as K8's group layout makes them, G =
    W / 4 lanes per draw: the block sums of ``group_block_sums`` (lane q
    adds columns 4q..4q+3 as (e0 + e1) + (e2 + e3), an xor tree over each
    32-column piece's lanes, a block's pieces in order:
    ``butterfly_sample.ref.block_sums4_order_torch``), ``group_running``'s
    scan (``warp_running``'s adds: ``warp_running_order_torch``), then
    ``group_walk`` on the products of block jb
    (``butterfly_sample.ref.group_walk_order_torch``)."""
    from repro_torch.kernels.butterfly_sample import ref as _bref

    prod = _products(theta, phi, doc_ids, words, W)
    run = _bref.warp_running_order_torch(_bref.block_sums4_order_torch(prod, W))
    u = torch.as_tensor(u, dtype=torch.float32)
    return _bref.group_walk_order_torch(prod, run, u, torch.arange(prod.shape[0]), W)


def walk_group_order_torch(theta, phi, running, u, rows, doc_ids, words,
                           W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) as K7's group layout makes them, G =
    W / 4 lanes per draw: draw s walks running row ``rows[s]`` with the
    products theta[doc_ids[s]] * phi[words[s]] formed as ``ProductRow4``
    forms them (one fp32 multiply each, zero past the row width) and
    ``group_walk``'s count, Fenwick up-sweep and descent
    (``butterfly_sample.ref.group_walk_order_torch``)."""
    from repro_torch.kernels.butterfly_sample import ref as _bref

    prod = _products(theta, phi, doc_ids, words, W)
    run = torch.as_tensor(running, dtype=torch.float32)[torch.as_tensor(rows).long()]
    u = torch.as_tensor(u, dtype=torch.float32)
    return _bref.group_walk_order_torch(prod, run, u, torch.arange(prod.shape[0]), W)


def blocksums_warp_order_torch(theta, phi, doc_ids, words, W: int) -> torch.Tensor:
    """(Bt, nb) float32 running W-block sums of theta[doc_ids] * phi[words]
    as K6's warp layout forms them: ``warp_block_sums`` (per 32-column piece
    an xor tree over one column a lane, a block's pieces in order) and
    ``warp_running``'s scan
    (``butterfly_sample.ref.masked_blocksums_warp_order_torch`` with nothing
    masked)."""
    from repro_torch.kernels.butterfly_sample import ref as _bref

    prod = _products(theta, phi, doc_ids, words, W)
    Bt, Kp = prod.shape
    return _bref.masked_blocksums_warp_order_torch(
        prod, torch.full((Bt,), -float("inf")), W, Kp // W)


def blocksums_group_order_torch(theta, phi, doc_ids, words, W: int) -> torch.Tensor:
    """(Bt, nb) float32 running W-block sums as K6's group layout forms
    them, G = W / 4 lanes per sample: ``group_block_sums`` (lane q adds
    columns 4q..4q+3 as (e0 + e1) + (e2 + e3), an xor tree over each
    32-column piece's lanes, a block's pieces in order:
    ``butterfly_sample.ref.block_sums4_order_torch``) and
    ``group_running``'s scan (``warp_running``'s adds:
    ``warp_running_order_torch``)."""
    from repro_torch.kernels.butterfly_sample import ref as _bref

    prod = _products(theta, phi, doc_ids, words, W)
    return _bref.warp_running_order_torch(_bref.block_sums4_order_torch(prod, W))
