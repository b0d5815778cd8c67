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
* :func:`radix_topk_tau_torch` — the CPU model of K9's radix select: the
  top-k threshold from four 8-bit digit histograms of the weights' bit
  patterns, as the kernel takes it.
* :func:`masked_blocksums_warp_order_torch` — K11's sums in the card's
  order: an xor tree per 32-column piece, pieces added in order, then
  ``warp_running``'s 32-wide scan chunks with a carry.
* :func:`split_running_order_torch` — the running sums of a row split
  over P thread blocks (K11, K4/K5's split layout; K2's, whose lanes hold
  four columns each) as the blocks form them: each block's run of
  128-column tiles, then the last block's scan in chunks;
  :func:`split_blocks_per_row` gives the card's P.
* :func:`group_walk_order_torch` — K3's walk as a group of W / 4 lanes
  makes it: each lane four weights, the Fenwick levels in the lane and
  across lanes, the descent reading each level's lane.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.reference import draw_prefix as butterfly_sample_ref
from repro_torch.kernels.lda_draw import ref as _lref

__all__ = ["block_sums4_order_torch", "boundary_ties", "butterfly_sample_ref",
           "cuda_sum_depth", "group_walk_order_torch",
           "masked_blocksums_warp_order_torch", "radix_topk_tau_torch",
           "split_blocks_per_row", "split_running_order_torch", "trunc_boundary_ties",
           "trunc_tau64", "warp_running_order_torch"]


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


def radix_topk_tau_torch(w, k) -> torch.Tensor:
    """(B,) float32 top-k threshold of (B, K) weights as K9's radix select
    takes it: a key ``bits(v) & 0x7fffffff`` for each v >= 0 (so -0.0 is
    +0.0; negatives and NaN have none), four passes of 8-bit digit
    histograms from the top over the keys that match the digits found, and
    tau the key of the ceil(k)-th largest.  tau is 0 where ``k <= 0`` or
    fewer than k keys exist (``#{w >= 0} >= k`` fails as a float32
    compare), as the 32-step bisection of ``transforms._topk_tau`` gives.
    Keys are int64, as ``kernels/rng.py`` holds uint32."""
    wf = torch.as_tensor(w).to(torch.float32)
    kf = torch.as_tensor(k, dtype=torch.float32, device=wf.device).expand(wf.shape[0])
    bits = wf.contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    cand = wf >= 0
    total = cand.sum(dim=1)
    valid = (kf > 0) & (total.to(torch.float32) >= kf)
    rem = torch.where(valid, torch.ceil(kf), torch.ones_like(kf)).to(torch.int64)
    prefix = torch.zeros_like(total)
    for shift in (24, 16, 8, 0):
        digit = (bits >> shift) & 0xFF
        hist = torch.zeros((wf.shape[0], 256), dtype=torch.int64,
                           device=wf.device).scatter_add_(
            1, digit, cand.to(torch.int64))
        ge = hist.flip(1).cumsum(1).flip(1)  # keys in bins >= d
        d = ((ge >= rem[:, None]).sum(dim=1) - 1).clamp(min=0)
        rem = rem - (ge - hist).gather(1, d[:, None])[:, 0]
        prefix = prefix | (d << shift)
        cand = cand & (digit == d[:, None])
    tau = prefix.to(torch.int32).view(torch.float32)
    return torch.where(valid, tau, torch.zeros_like(tau))


def _xor_tree(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as a warp's xor shuffles
    leave it in lane 0: neighbours added pairwise, level by level."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def masked_blocksums_warp_order_torch(w, tau, W: int, nb: int) -> torch.Tensor:
    """(B, nb) float32 running W-block sums of ``w * [w >= tau[row]]`` in
    K11's order (``draw_tile.cuh``'s ``warp_block_sums_strided`` and
    ``warp_running``): each W-block is an xor tree over min(W, 32) columns
    per 32-column piece, the pieces added in order; the running sums are a
    Hillis-Steele scan of each chunk of 32 blocks plus the carry of the
    chunks before it.  Equal to the kernel bit for bit."""
    wf = torch.as_tensor(w).to(torch.float32)
    B, K = wf.shape
    tau = torch.as_tensor(tau, dtype=torch.float32, device=wf.device)
    wm = torch.where(wf >= tau[:, None], wf, torch.zeros((), dtype=wf.dtype,
                                                         device=wf.device))
    wm = torch.nn.functional.pad(wm, (0, nb * W - K))
    if W <= 32:
        bs = _xor_tree(wm.view(B, nb, W))
    else:
        pieces = _xor_tree(wm.view(B, nb, W // 32, 32))
        bs = pieces[..., 0]
        for i in range(1, W // 32):
            bs = bs + pieces[..., i]
    return warp_running_order_torch(bs)


def warp_running_order_torch(bs: torch.Tensor) -> torch.Tensor:
    """(B, nb) running sums of (B, nb) block sums in ``warp_running``'s
    order: a Hillis-Steele scan of each chunk of 32 blocks (element j adds
    element j - off of the level before, off = 1 .. 16), plus the carry of
    the chunks before it."""
    B, nb = bs.shape
    n32 = -(-nb // 32) * 32
    v = torch.nn.functional.pad(bs, (0, n32 - nb)).view(B, n32 // 32, 32)
    off = 1
    while off < 32:  # the in-chunk scan: lane i adds lane i - off
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
        off *= 2
    out = torch.empty_like(v)
    carry = torch.zeros((B,), dtype=torch.float32, device=bs.device)
    for c in range(v.shape[1]):
        out[:, c] = v[:, c] + carry[:, None]
        carry = out[:, c, 31]
    return out.view(B, n32)[:, :nb].contiguous()


def block_sums4_order_torch(x: torch.Tensor, W: int) -> torch.Tensor:
    """(..., n * W) columns -> (..., n) W-block sums as lanes that hold four
    columns each form them (``draw_tile.cuh``'s ``block_sum4``: K2's split,
    K8's group layout): lane q adds columns 4q..4q+3 as (e0 + e1) + (e2 +
    e3), an xor tree over the P = min(W / 4, 8) lanes of each 32-column
    piece finishes the piece, and a W-block adds its pieces in order."""
    G = W // 4
    P = min(G, 8)
    e = x.reshape(*x.shape[:-1], -1, G, 4)
    lanes = (e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3])
    pieces = _xor_tree(lanes.reshape(*lanes.shape[:-1], G // P, P))
    bs = pieces[..., 0]
    for i in range(1, G // P):
        bs = bs + pieces[..., i]
    return bs


# The split row's sizing, as draw_tile.cuh's constants of the same role
# set it for K2, K4/K5 and K11; the models and tests read them from here.
TILE = 128  # columns a warp sums at once in a split row (kTile)
SUM_BLOCKS_PER_SM = 8  # blocks per SM the (B, P) grid aims at (kSumBlocksPerSM)
MIN_BLOCKS_PER_RUN = 32  # least W-blocks a block sums (kMinBlocksPerRun)
SCAN_CHUNK = 4096  # most sums the scanning block holds at once (kScanChunk)
H100_SMS = 132  # the H100's SMs: split_tiles_per_block reads the card's count


def _tile_block_sums(wt: torch.Tensor, W: int) -> torch.Tensor:
    """(B, n * TILE) columns -> (B, n * TILE / W) W-block sums as
    ``tile_block_sums`` forms them: per 32-column piece an xor tree over
    min(W, 32) lanes, then a block's pieces added in order."""
    B, k = wt.shape
    pieces = wt.view(B, k // TILE, 4, 32)
    if W <= 32:
        return _xor_tree(pieces.reshape(B, k // TILE, 4, 32 // W, W)).reshape(B, -1)
    p = _xor_tree(pieces)  # (B, tiles, 4): the piece sums
    if W == 64:
        return torch.stack([p[..., 0] + p[..., 1], p[..., 2] + p[..., 3]], -1).reshape(B, -1)
    return ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]


def split_blocks_per_row(B: int, nb: int, W: int, sms: int = H100_SMS,
                         blocks_per_sm: int = SUM_BLOCKS_PER_SM,
                         min_blocks_per_run: int = MIN_BLOCKS_PER_RUN,
                         scan_chunk: int = SCAN_CHUNK) -> int:
    """P, the thread blocks per row of a split (K2, K4/K5, K11), as
    ``draw_tile.cuh``'s ``split_tiles_per_block`` sizes it on a card of
    ``sms`` SMs (``H100_SMS``): enough blocks to fill the card, each
    with at least ``min_blocks_per_run`` W-blocks and at most about
    ``scan_chunk``; then P = ceil(nt / tpb) over nt 128-column tiles."""
    nt = -(-nb * W // TILE)
    P = -(-blocks_per_sm * sms // B)
    P = min(P, nb // min_blocks_per_run)
    P = max(P, -(-nb // scan_chunk), 1)
    tpb = -(-nt // P)
    return -(-nt // tpb)


def split_running_order_torch(w, W: int, nb: int, P: int, scan_chunk: int = SCAN_CHUNK,
                              cols_per_lane: int = 1) -> torch.Tensor:
    """(B, nb) float32 running W-block sums of (B, K) weights as a row
    split over P thread blocks forms them (``draw_tile.cuh``'s
    ``split_row_running``, or with ``cols_per_lane=4`` K2's
    ``split_row_running4``): block p sums the W-blocks of its run of
    ``tpb = ceil(nt / P)`` 128-column tiles, columns at or past K zero,
    with one column a lane (``tile_block_sums``) or four
    (:func:`block_sums4_order_torch`); the last block scans the row
    ``scan_chunk`` sums at a time (a multiple of 32), each chunk a 32-wide
    Hillis-Steele scan per group of 32 with the carry of everything before
    it.  Equal to :func:`masked_blocksums_warp_order_torch` with nothing
    masked for every P and both lane widths, which is what lets the split
    layouts keep one warp's order."""
    if cols_per_lane not in (1, 4):
        raise ValueError(f"cols_per_lane must be 1 or 4, got {cols_per_lane}")
    tile_sums = _tile_block_sums if cols_per_lane == 1 else block_sums4_order_torch
    wf = torch.as_tensor(w).to(torch.float32)
    B, K = wf.shape
    nt = -(-nb * W // TILE)
    tpb = -(-nt // P)
    wp = torch.nn.functional.pad(wf[:, :nb * W], (0, nt * TILE - min(K, nb * W)))
    bs = torch.empty((B, nt * TILE // W), dtype=torch.float32)
    per = TILE // W
    for t0 in range(0, nt, tpb):  # block p = t0 // tpb: its run of tiles
        t1 = min(t0 + tpb, nt)
        bs[:, t0 * per:t1 * per] = tile_sums(wp[:, t0 * TILE:t1 * TILE], W)
    bs = bs[:, :nb]
    out = torch.empty_like(bs)
    carry = torch.zeros((B,), dtype=torch.float32)
    for c in range(0, nb, scan_chunk):  # the last block's chunks
        for g in range(c, min(c + scan_chunk, nb), 32):  # warp_running_from
            v = torch.nn.functional.pad(bs[:, g:g + 32], (0, 32 - bs[:, g:g + 32].shape[1]))
            off = 1
            while off < 32:
                v = torch.cat([v[:, :off], v[:, off:] + v[:, :-off]], dim=1)
                off *= 2
            v = v + carry[:, None]
            n = min(32, nb - g)
            out[:, g:g + n] = v[:, :n]
            carry = v[:, 31]
    return out


def group_walk_order_torch(w, running, u, rows, W: int) -> torch.Tensor:
    """(Bt,) int32 draws as K3's group walk (``draw_tile.cuh``'s
    ``group_walk``) makes them: G = W / 4 lanes per draw.  Lane q counts
    ``running[c] <= stop`` for c = q, q + G, ... and the group adds the
    counts; lane q holds weights 4q..4q+3 of block jb (zero past the row's
    width); the Fenwick up-sweep adds t[hi] += t[hi - bit] at bit = 1, 2
    inside each lane and at bit = 4b as a shuffle up by b lanes; the
    descent reads t[R + bit - 1] from lane (R + bit - 1) >> 2 (element 3
    while bit >= 4, then element 1, then element 0 or 2).  Equal to
    ``kernel.walk_torch`` bit for bit."""
    wt = torch.as_tensor(w)
    wf = wt if wt.dtype == torch.float32 else wt.to(torch.float32)
    ncols = wf.shape[1]
    rows = torch.as_tensor(rows).long()
    run = torch.as_tensor(running, dtype=torch.float32)[rows]
    Bt, nb = run.shape
    G = W // 4
    stop = run[:, -1] * torch.as_tensor(u, dtype=torch.float32)
    npad = -(-nb // G) * G
    lanes = torch.nn.functional.pad(run, (0, npad - nb), value=float("inf"))
    cnt = (lanes.view(Bt, npad // G, G) <= stop[:, None, None]).sum(dim=1).sum(dim=1)
    jb = cnt.clamp(max=nb - 1)
    prev = torch.gather(run, 1, (jb - 1).clamp(min=0)[:, None])[:, 0]
    lo = torch.where(jb > 0, prev, torch.zeros_like(prev))
    cols = jb[:, None] * W + torch.arange(W)[None, :]
    blk = wf[rows[:, None], cols.clamp(max=ncols - 1)]
    e = torch.where(cols < ncols, blk, torch.zeros_like(blk)).view(Bt, G, 4)
    e0, e2 = e[..., 0], e[..., 2]
    e1 = e[..., 1] + e0
    e3 = (e[..., 3] + e[..., 2]) + e1
    q = torch.arange(G)
    b = 1
    while b < G:  # shuffle up by b lanes, added where (q + 1) % 2b == 0
        x = torch.cat([e3[:, :b], e3[:, :-b]], dim=1)
        e3 = torch.where(((q + 1) & (2 * b - 1)) == 0, e3 + x, e3)
        b *= 2
    acc, R = lo, torch.zeros_like(jb)

    def step(y, bit):
        nonlocal acc, R
        mid = acc + y
        go = stop >= mid
        acc = torch.where(go, mid, acc)
        R = torch.where(go, R + bit, R)

    bit = W // 2
    while bit >= 4:
        step(torch.gather(e3, 1, ((R + bit - 1) >> 2)[:, None])[:, 0], bit)
        bit //= 2
    L = (R >> 2)[:, None]
    step(torch.gather(e1, 1, L)[:, 0], 2)
    step(torch.where((R & 2) != 0, torch.gather(e2, 1, L)[:, 0],
                     torch.gather(e0, 1, L)[:, 0]), 1)
    return (jb * W + R).to(torch.int32)

