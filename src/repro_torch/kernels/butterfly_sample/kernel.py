"""The shared draw-tile steps, as plain PyTorch.

These are the per-tile steps every draw kernel of the reference's
``butterfly_sample`` family runs on a (TB, W) or (TB, Kp) tile:

* :func:`_select_tile` — the block-level search (paper Alg. 9): the
  smallest block whose running sum exceeds ``stop``, and the exclusive
  prefix ``lo`` below it;
* :func:`_fenwick_tile` — the Blelloch up-sweep into Fenwick layout;
* :func:`_descent_tile` — the add-only log2(W) descent (Alg. 10);
* :func:`_draw_tile` — the three chained into the full draw.

They are the plain versions of the CUDA ``__device__`` functions in
``kernels/csrc/draw_tile.cuh``, which the factored LDA kernels use now
and the remaining butterfly kernels will reuse.  The reference's one-hot
lane reductions become direct gathers here; the arithmetic (which values
are added, in which order) is the same, so on equal tiles the results are
equal bit for bit.
"""

from __future__ import annotations

import torch


def _log2(W: int) -> int:
    return W.bit_length() - 1


def _fenwick_tile(t: torch.Tensor, W: int) -> torch.Tensor:
    """Up-sweep over every W-segment of a (TB, W) tile: position d with
    ntz(d+1)=l accumulates S[d-2^l+1..d] (Fenwick layout)."""
    TB = t.shape[0]
    t = t.clone()
    for b in range(_log2(W)):
        bit = 1 << b
        t2 = t.view(TB, W // (2 * bit), 2 * bit)
        t2[:, :, 2 * bit - 1] += t2[:, :, bit - 1]
    return t


def _descent_tile(t: torch.Tensor, stop: torch.Tensor, lo: torch.Tensor,
                  W: int) -> torch.Tensor:
    """Add-only descent: every row of the (TB, W) Fenwick tile walks its
    log2(W) levels; returns (TB,) int32 in-block offsets."""
    TB = t.shape[0]
    acc = lo
    R = torch.zeros((TB,), dtype=torch.int64, device=t.device)
    for b in range(_log2(W) - 1, -1, -1):
        bit = 1 << b
        y = torch.gather(t, 1, (R + (bit - 1))[:, None])[:, 0]
        mid = acc + y
        go_high = stop >= mid
        acc = torch.where(go_high, mid, acc)
        R = torch.where(go_high, R + bit, R)
    return R.to(torch.int32)


def _select_tile(running: torch.Tensor, stop: torch.Tensor, W: int):
    """Smallest block c with stop < running[c] (clipped to nb-1), plus the
    exclusive prefix ``lo`` below it.  ``running``: (TB, nb)."""
    nb = running.shape[1]
    jb = (running <= stop[:, None]).sum(dim=1).clamp(0, nb - 1)
    prev = torch.gather(running, 1, (jb - 1).clamp(min=0)[:, None])[:, 0]
    lo = torch.where(jb > 0, prev, torch.zeros_like(prev))
    return jb.to(torch.int32), lo


def _draw_tile(w: torch.Tensor, u: torch.Tensor, W: int) -> torch.Tensor:
    """The complete draw for one (TB, Kp) tile: block sums -> running sums
    -> block selection -> Fenwick build -> descent.  (TB,) int32."""
    TB, Kp = w.shape
    nb = Kp // W
    blocks = w.view(TB, nb, W)
    running = torch.cumsum(blocks.sum(dim=-1), dim=-1)
    stop = running[:, -1] * u
    jb, lo = _select_tile(running, stop, W)
    sel = blocks[torch.arange(TB, device=w.device), jb.long()]
    t = _fenwick_tile(sel, W)
    R = _descent_tile(t, stop, lo, W)
    return jb * W + R


def _block_search(running_rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Block-level search on running block sums: the smallest block whose
    running sum exceeds stop = total * u, clipped to nb-1.  (B,) int32."""
    nb = running_rows.shape[1]
    stop = running_rows[:, -1] * u.to(torch.float32)
    return (running_rows <= stop[:, None]).sum(dim=1).clamp(0, nb - 1).to(
        torch.int32
    )
