"""Butterfly-patterned partial sums (Steele & Tristan 2015), plain PyTorch.

Two forms of the paper's idea, as in the reference ``repro.core.butterfly``:

1. paper-faithful — the butterfly table of Algorithm 8 (the replacement
   ``[[a,b],[c,d]] -> [[a,d],[a+b,c+d]]`` swept in log2(W) rounds over
   W x W blocks, ``shuffleXor`` realized as a flip along the thread axis)
   and the add-or-subtract search walk of Algorithms 9/10.  The layout
   matches the paper's Figure 1/2 entry for entry.
2. fenwick — a per-sample up-sweep that stores, at position d with
   ntz(d+1) = l, the segment sum S[d-2^l+1 .. d], searched by an add-only
   descent over the sample's own row.

Glossary (paper -> here): thread r -> a sample's index within a group of
W; topic k -> category index; p[W-1] of a block -> the running
(cross-block) prefix of each sample's block sums.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_W = 32


def _check_w(W: int) -> int:
    if W < 2 or (W & (W - 1)) != 0:
        raise ValueError(f"W must be a power of two >= 2, got {W}")
    return W.bit_length() - 1


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int, value=0.0):
    """Pad ``x`` along ``axis`` up to a multiple of ``mult`` with ``value``."""
    size = x.shape[axis]
    rem = (-size) % mult
    if rem == 0:
        return x, size
    shape = list(x.shape)
    shape[axis] = rem
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis), size


# ---------------------------------------------------------------------------
# Paper-faithful butterfly table (Algorithm 8)
# ---------------------------------------------------------------------------


def butterfly_rounds(blocks: torch.Tensor, W: int) -> torch.Tensor:
    """Apply the log2(W) rounds of replacement computations to W x W blocks.

    ``blocks[..., k, r]`` = product of sample ``k`` for category ``r`` of
    the block (register slot k of thread r).  Row W-1 of the result holds
    each sample's block-local total; rows 0..W-2 hold segment sums per the
    closed form (see :func:`closed_form_table`).
    """
    log2w = _check_w(W)
    assert blocks.shape[-1] == W and blocks.shape[-2] == W
    col = torch.arange(W, device=blocks.device)
    m = blocks.clone()
    for b in range(log2w):
        bit = 1 << b
        rows_d = torch.tensor(
            [d for d in range(W - 1) if (d + 1) % (2 * bit) == bit],
            device=blocks.device,
        )
        a_d = m[..., rows_d, :]
        a_db = m[..., rows_d + bit, :]
        col_has_bit = (col & bit) != 0
        # h = (r & bit) ? a[d] : a[d+bit]   (paper lines 22-24)
        h = torch.where(col_has_bit, a_d, a_db)
        # v = shuffleXor(h, bit): exchange along the thread (column) axis
        v = (
            h.reshape(h.shape[:-1] + (W // (2 * bit), 2, bit))
            .flip(-2)
            .reshape(h.shape)
        )
        # if (r & bit): a[d] <- a[d+bit]     (lines 26-28)
        new_d = torch.where(col_has_bit, a_db, a_d)
        # a[d+bit] <- a[d] + v               (line 29, uses the updated a[d])
        m[..., rows_d, :] = new_d
        m[..., rows_d + bit, :] = new_d + v
    return m


def _blocks(weights: torch.Tensor, W: int) -> torch.Tensor:
    B, K = weights.shape
    # blocks[g, c, k, r] = weights[g*W + k, c*W + r]
    return weights.reshape(B // W, W, K // W, W).transpose(1, 2)


def _with_running(t: torch.Tensor, W: int) -> torch.Tensor:
    """Row W-1 of block c becomes the running prefix through block c."""
    t = t.clone()
    t[:, :, W - 1, :] = torch.cumsum(t[:, :, W - 1, :], dim=1)
    return t


def build_butterfly_table(weights: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """The paper's butterfly table for (B, K) ``weights``, B and K
    multiples of W: (G, nb, W, W) with G = B // W, nb = K // W; row W-1 of
    block c holds the running prefix through block c (Alg. 8 l. 33-34)."""
    B, K = weights.shape
    if B % W or K % W:
        raise ValueError(f"(B={B}, K={K}) must be multiples of W={W}; pad first")
    return _with_running(butterfly_rounds(_blocks(weights, W), W), W)


def closed_form_table(weights: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """Oracle: the butterfly table from the paper's closed form — entry
    (i, j) of a block holds ``u_v^w`` with ``m = i ^ (i+1), k = m >> 1,
    u = (i & ~m) + (j & m), v = j & ~k, w = v + k``."""
    cs = torch.cumsum(_blocks(weights, W), dim=-1)
    i = np.arange(W)[:, None]
    j = np.arange(W)[None, :]
    mm = i ^ (i + 1)
    kk = mm >> 1
    u = torch.as_tensor((i & ~mm) + (j & mm))
    v = j & ~kk
    w = torch.as_tensor(v + kk)
    lo_idx = torch.as_tensor(np.maximum(v - 1, 0))
    seg_hi = cs[:, :, u, w]
    seg_lo = torch.where(
        torch.as_tensor(v > 0), cs[:, :, u, lo_idx], torch.zeros((), dtype=cs.dtype)
    )
    return _with_running(seg_hi - seg_lo, W)


def butterfly_search(table: torch.Tensor, stop: torch.Tensor,
                     W: int = DEFAULT_W) -> torch.Tensor:
    """Algorithm 9/10: per-sample search of the butterfly table.

    ``table``: (G, nb, W, W); ``stop``: (G, W) per-sample stop values.
    Returns (G, W) int32 category indices.
    """
    log2w = _check_w(W)
    G, nb = table.shape[0], table.shape[1]
    dev = table.device
    r = torch.arange(W, device=dev)[None, :]
    p_last = table[:, :, W - 1, :]                     # (G, nb, W) running sums
    jb = (p_last <= stop[:, None, :]).sum(dim=1).clamp(0, nb - 1)
    prev = torch.gather(p_last, 1, (jb - 1).clamp(min=0)[:, None, :])[:, 0]
    lo = torch.where(jb > 0, prev, torch.zeros_like(stop))
    hi = torch.gather(p_last, 1, jb[:, None, :])[:, 0]
    flat = table.reshape(G, nb * W * W)
    R = torch.zeros((G, W), dtype=torch.int64, device=dev)
    for b in range(log2w - 1, -1, -1):
        bit = 1 << b
        m2 = 2 * bit - 1
        i_row = (r & ~m2) | (bit - 1)
        j_col = R | (r & m2)
        y = torch.gather(flat, 1, jb * (W * W) + i_row * W + j_col)
        mid = torch.where((r & bit) != 0, hi - y, lo + y)
        go_low = stop < mid
        hi = torch.where(go_low, mid, hi)
        lo = torch.where(go_low, lo, mid)
        R = torch.where(go_low, R, R | bit)
    return (jb * W + R).to(torch.int32)


# ---------------------------------------------------------------------------
# Per-sample Fenwick (up-sweep) table
# ---------------------------------------------------------------------------


def build_fenwick_table(weights: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """(B, K) table, K a multiple of W: within each W-block, position d
    with ntz(d+1)=l holds S[d-2^l+1 .. d], and position W-1 holds the
    running cross-block prefix."""
    log2w = _check_w(W)
    B, K = weights.shape
    if K % W:
        raise ValueError(f"K={K} must be a multiple of W={W}; pad first")
    nb = K // W
    t = weights.reshape(B, nb, W).clone()
    for b in range(log2w):
        bit = 1 << b
        t2 = t.view(B, nb, W // (2 * bit), 2 * bit)
        t2[..., 2 * bit - 1] += t2[..., bit - 1]
    t[..., W - 1] = torch.cumsum(t[..., W - 1], dim=1)
    return t.reshape(B, K)


def fenwick_search(table: torch.Tensor, stop: torch.Tensor,
                   W: int = DEFAULT_W) -> torch.Tensor:
    """Add-only descent over the per-sample Fenwick table: (B,) int32."""
    log2w = _check_w(W)
    B, K = table.shape
    nb = K // W
    p_last = table.reshape(B, nb, W)[..., W - 1]
    jb = (p_last <= stop[:, None]).sum(dim=1).clamp(0, nb - 1)
    prev = torch.gather(p_last, 1, (jb - 1).clamp(min=0)[:, None])[:, 0]
    acc = torch.where(jb > 0, prev, torch.zeros_like(stop))
    R = torch.zeros((B,), dtype=torch.int64, device=table.device)
    base = jb * W
    for b in range(log2w - 1, -1, -1):
        bit = 1 << b
        y = torch.gather(table, 1, (base + R + (bit - 1))[:, None])[:, 0]
        mid = acc + y
        go_high = stop >= mid
        acc = torch.where(go_high, mid, acc)
        R = torch.where(go_high, R + bit, R)
    return (base + R).to(torch.int32)


# ---------------------------------------------------------------------------
# End-to-end draws
# ---------------------------------------------------------------------------


def _prep(weights, W: int, group_pad: bool):
    """Pad categories (zeros) and, for the paper layout, samples."""
    weights = torch.as_tensor(weights)
    if weights.dtype not in (torch.float32, torch.float64):
        weights = weights.to(torch.float32)
    w_padded, K = pad_to_multiple(weights, axis=1, mult=W, value=0.0)
    if group_pad:
        # dummy samples draw from a singleton; discarded afterwards
        w_padded, B = pad_to_multiple(w_padded, axis=0, mult=W, value=0.0)
        if w_padded.shape[0] != B:
            w_padded[B:, 0] = 1.0
        return w_padded, B, K
    return w_padded, weights.shape[0], K


def draw_butterfly(weights, u: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """One index per row of (B, K) ``weights`` by the paper-faithful path."""
    wp, B, K = _prep(weights, W, group_pad=True)
    return draw_butterfly_from_table(build_butterfly_table(wp, W), u, W=W, B=B, K=K)


def draw_butterfly_from_table(table, u, W: int, B: int, K: int) -> torch.Tensor:
    """Draw from a prebuilt butterfly table; padded sample groups take
    u = 0.5, indices are clipped to K-1."""
    G = table.shape[0]
    totals = table[:, -1, W - 1, :]                    # (G, W)
    up, _ = pad_to_multiple(u.to(table.dtype), axis=0, mult=W, value=0.5)
    stop = totals * up.reshape(G, W)
    idx = butterfly_search(table, stop, W).reshape(-1)[:B]
    return idx.clamp(max=K - 1)


def draw_fenwick_from_table(table, u, W: int, K: int) -> torch.Tensor:
    """Draw from a prebuilt (possibly K-padded) Fenwick table; ``K`` is
    the unpadded category count."""
    B = table.shape[0]
    totals = table.reshape(B, -1, W)[:, -1, W - 1]
    stop = totals * u.to(table.dtype)
    return fenwick_search(table, stop, W).clamp(max=K - 1)


def draw_fenwick(weights, u: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """One index per row by the Fenwick path."""
    wp, B, K = _prep(weights, W, group_pad=False)
    return draw_fenwick_from_table(build_fenwick_table(wp, W), u, W=W, K=K)


def two_level_state(weights, W: int):
    """(blocks (B, nb, W), running (B, nb)) of the two-level draw."""
    wp, _, _ = _prep(weights, W, group_pad=False)
    B = wp.shape[0]
    blocks = wp.reshape(B, wp.shape[1] // W, W)
    return blocks, torch.cumsum(blocks.sum(dim=-1), dim=1)


def draw_two_level_from_state(blocks, running, u, W: int, K: int) -> torch.Tensor:
    """Select a block on the running block sums, then search inside it."""
    nb = running.shape[1]
    stop = running[:, -1] * u.to(blocks.dtype)
    jb = (running <= stop[:, None]).sum(dim=1).clamp(0, nb - 1)
    prev = torch.gather(running, 1, (jb - 1).clamp(min=0)[:, None])[:, 0]
    lo = torch.where(jb > 0, prev, torch.zeros_like(stop))
    sel = blocks[torch.arange(blocks.shape[0], device=blocks.device), jb]   # (B, W)
    prefix = torch.cumsum(sel, dim=-1) + lo[:, None]
    r = (prefix <= stop[:, None]).sum(dim=1)
    idx = jb * W + r.clamp(max=W - 1)
    return idx.clamp(max=K - 1).to(torch.int32)


def draw_two_level(weights, u: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """Fused two-level draw: (B, K/W) block sums, block selection, then
    an in-block cumsum and search over the selected W-block only."""
    K = weights.shape[1]
    blocks, running = two_level_state(weights, W)
    return draw_two_level_from_state(blocks, running, u, W, K)
