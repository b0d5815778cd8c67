"""Draws on given weights: the shared draw-tile steps as plain PyTorch,
and the wrappers of the Hopper kernels K2, K3 and K4, each with its plain
version beside it.

The per-tile steps every draw kernel of the reference's
``butterfly_sample`` family runs on a (TB, W) or (TB, Kp) tile:

* :func:`_select_tile` — the block-level search (paper Alg. 9): the
  smallest block whose running sum exceeds ``stop``, and the exclusive
  prefix ``lo`` below it;
* :func:`_fenwick_tile` — the Blelloch up-sweep into Fenwick layout;
* :func:`_descent_tile` — the add-only log2(W) descent (Alg. 10);
* :func:`_draw_tile` — the three chained into the full draw.

They are the plain versions of the CUDA ``__device__`` functions in
``kernels/csrc/draw_tile.cuh``, which the factored LDA kernels and the
kernels below use.  The reference's one-hot lane reductions become direct
gathers here; the arithmetic (which values are added, in which order) is
the same, so on equal tiles the results are equal bit for bit.

Six kernels replace the reference's Pallas kernels in
``repro/kernels/butterfly_sample/kernel.py``; the first three are in
``csrc/butterfly_sample.cu``, the truncated draws in
``csrc/butterfly_trunc.cu``:

====================  ===================================  ===========================
wrapper               replaces                             plain version
====================  ===================================  ===========================
``blocksums``         ``_blocksum_kernel`` (K2)            ``blocksums_torch``
``walk``              ``_walk_kernel`` (K3)                ``walk_torch``
``fused_draw``        ``_fused_draw_kernel`` (K4)          ``fused_draw_torch``
``fused_trunc_draw``  ``_fused_trunc_draw_kernel`` (K9)    ``fused_trunc_draw_torch``
``masked_blocksums``  ``_masked_blocksum_kernel`` (K11)    ``masked_blocksums_torch``
``walk_trunc``        ``_walk_trunc_kernel`` (K12)         ``walk_trunc_torch``
====================  ===================================  ===========================

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch failed, and
adds one to its count in :data:`LAUNCHES`.  Rows may be narrower than
Kp = nb * W: columns at or past a row's width count as zero (the padding
of K to a multiple of W), so nobody copies the weights to pad them.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import runtime

# launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"blocksums": 0, "walk": 0, "fused_draw": 0,
                            "fused_trunc_draw": 0, "masked_blocksums": 0,
                            "walk_trunc": 0}

# Fused / two-pass switch.  The fused kernel (K4) keeps one sample's nb
# running sums and one W-block in shared memory, _WARPS_PER_BLOCK samples
# per block; it runs while that fits the 48 KB of dynamic shared memory a
# block gets without opting in (nb + W <= 3072 floats per sample: K up to
# ~390,000 at W=128), and the two-pass route (K2 then K3) beyond.
_WARPS_PER_BLOCK = 4
_FUSED_SMEM_BYTES = 48 << 10

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The fused truncated draw (K9) runs one block of _TRUNC_THREADS threads per
# row and stages the row (as fp32) in dynamic shared memory while
# (2 * _TRUNC_THREADS / 32 + nb + W + K) floats fit the 227 KB a block may
# opt into; a longer row is read from global memory (L2) on every pass.
# Staging is the faster of the two where both run (chip_smoke.py times both
# at K = 32,000 and 56,000; PERF.md).
_TRUNC_THREADS = 1024
_MAX_SMEM_BYTES = 232448


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


def num_blocks(K: int, W: int) -> int:
    return -(-K // W)


def fused_fits(nb: int, W: int) -> bool:
    """True when the fused draw's shared memory (K4) fits one block."""
    return 4 * _WARPS_PER_BLOCK * (nb + W) <= _FUSED_SMEM_BYTES


def trunc_row_staged(ncols: int, nb: int, W: int) -> bool:
    """True when K9 can stage a row of ``ncols`` weights in shared memory."""
    return 4 * (2 * _TRUNC_THREADS // 32 + nb + W + ncols) <= _MAX_SMEM_BYTES


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# ctypes binding and checks
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "blocksums": [_P] * 2 + [_I] * 5 + [_P],
    "walk": [_P] * 5 + [_I] * 5 + [_P],
    "fused_draw": [_P] * 3 + [_I] * 5 + [_P],
}


_TRUNC_SIGS = {
    "fused_trunc_draw": [_P] * 4 + [_I] * 7 + [_P],
    "masked_blocksums": [_P] * 3 + [_I] * 5 + [_P],
    "walk_trunc": [_P] * 6 + [_I] * 5 + [_P],
}


def _launch(name: str, *args) -> None:
    if name in _TRUNC_SIGS:
        lib = _build.bind("butterfly_trunc", _TRUNC_SIGS,
                          ("butterfly_trunc_threads", _TRUNC_THREADS))
    else:
        lib = _build.bind("butterfly_sample", _SIGS,
                          ("butterfly_sample_warps_per_block", _WARPS_PER_BLOCK))
    _build.launch(lib, name, LAUNCHES, *args)


def _check_weights(w: torch.Tensor, nb: int, W: int) -> int:
    runtime.check_w(W)
    if not w.is_cuda:
        raise ValueError(f"weights must be a CUDA tensor, got {w.device}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got {w.dtype}")
    if w.dim() != 2 or not w.is_contiguous():
        raise ValueError("weights must be a contiguous 2-D tensor")
    ncols = w.shape[1]
    if not (nb - 1) * W < ncols <= nb * W:
        raise ValueError(f"row width {ncols} does not give nb={nb} blocks of W={W}")
    return ncols


def _check_vec(name: str, t: torch.Tensor, dtype, n: int, like: torch.Tensor):
    if t.device != like.device or t.dtype != dtype or t.shape != (n,) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous ({n},) {dtype} tensor on {like.device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _check_running(running: torch.Tensor, like: torch.Tensor) -> None:
    if running.device != like.device or running.dtype != torch.float32 \
            or running.dim() != 2 or not running.is_contiguous():
        raise ValueError("running must be a contiguous 2-D float32 CUDA tensor")


def _float_rows(w: torch.Tensor) -> torch.Tensor:
    return w if w.dtype in (torch.float32, torch.float64) else w.float()


# ---------------------------------------------------------------------------
# K2: running block sums of given weights
# ---------------------------------------------------------------------------


def blocksums(w: torch.Tensor, W: int, nb: int) -> torch.Tensor:
    """(B, nb) float32 running W-block sums of (B, K) weights (K2).  The
    kernel writes the running sums itself: no cumsum follows."""
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    out = torch.empty((B, nb), dtype=torch.float32, device=w.device)
    _launch("blocksums", w.data_ptr(), out.data_ptr(), B, ncols, nb, W,
            _DTYPES[w.dtype])
    return out


def blocksums_torch(w: torch.Tensor, W: int, nb: int) -> torch.Tensor:
    """Plain version of :func:`blocksums`."""
    wf = _float_rows(w)
    pad = nb * W - wf.shape[1]
    if pad:  # the zero padding of the last block
        wf = torch.nn.functional.pad(wf, (0, pad))
    return torch.cumsum(wf.view(wf.shape[0], nb, W).sum(dim=-1), dim=1)


# ---------------------------------------------------------------------------
# K3: walk only the selected W-block of each draw's row
# ---------------------------------------------------------------------------


def walk(w, running, u, rows, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) from prebuilt running block sums (K3):
    draw s uses row ``rows[s]`` of ``running`` and reads only block jb of
    row ``rows[s]`` of ``w``.  The kernel finds jb itself.  rows must
    index valid rows (not checked: that would synchronise)."""
    nb = running.shape[1]
    ncols = _check_weights(w, nb, W)
    _check_running(running, w)
    if running.shape[0] != w.shape[0]:
        raise ValueError("running and weights must have one row per sample")
    Bt = u.shape[0]
    _check_vec("u", u, torch.float32, Bt, w)
    _check_vec("rows", rows, torch.int32, Bt, w)
    out = torch.empty((Bt,), dtype=torch.int32, device=w.device)
    _launch("walk", w.data_ptr(), running.data_ptr(), u.data_ptr(),
            rows.data_ptr(), out.data_ptr(), Bt, ncols, nb, W, _DTYPES[w.dtype])
    return out


def walk_torch(w, running, u, rows, W: int) -> torch.Tensor:
    """Plain version of :func:`walk`: gathers one W-block per draw."""
    ncols = w.shape[1]
    rows = rows.long()
    run = running[rows]
    stop = run[:, -1] * u.float()
    jb, lo = _select_tile(run, stop, W)
    cols = jb.long()[:, None] * W + torch.arange(W, device=w.device)[None, :]
    valid = cols < ncols
    blk = _float_rows(w[rows[:, None], cols.clamp(max=ncols - 1)])
    blk = torch.where(valid, blk, torch.zeros((), dtype=blk.dtype, device=w.device))
    R = _descent_tile(_fenwick_tile(blk, W), stop, lo, W)
    return jb * W + R


# ---------------------------------------------------------------------------
# K4: fused draw, one launch per batch
# ---------------------------------------------------------------------------


def fused_draw(w, u, W: int) -> torch.Tensor:
    """(B,) int32 draws in [0, Kp) from (B, K) weights in one launch (K4):
    block sums, running sums, selection, Fenwick table and descent."""
    nb = num_blocks(w.shape[1], W)
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    _check_vec("u", u, torch.float32, B, w)
    if not fused_fits(nb, W):
        raise ValueError(f"fused draw needs too much shared memory at nb={nb}, W={W}")
    out = torch.empty((B,), dtype=torch.int32, device=w.device)
    _launch("fused_draw", w.data_ptr(), u.data_ptr(), out.data_ptr(), B, ncols,
            nb, W, _DTYPES[w.dtype])
    return out


def fused_draw_torch(w, u, W: int) -> torch.Tensor:
    """Plain version of :func:`fused_draw`: pass A then pass B."""
    nb = num_blocks(w.shape[1], W)
    running = blocksums_torch(w, W, nb)
    rows = torch.arange(w.shape[0], device=w.device)
    return walk_torch(w, running, u, rows, W)


# ---------------------------------------------------------------------------
# K9: fused truncated draw (threshold, mask, draw), one launch per batch
# ---------------------------------------------------------------------------


def _check_params(params: torch.Tensor, B: int, like: torch.Tensor) -> None:
    if params.device != like.device or params.dtype != torch.float32 \
            or tuple(params.shape) != (B, 3) or not params.is_contiguous():
        raise ValueError(
            f"params must be a contiguous ({B}, 3) float32 tensor on {like.device}, "
            f"got {tuple(params.shape)} {params.dtype} on {params.device}"
        )


def fused_trunc_draw(w, u, params, W: int, iters: int = 32) -> torch.Tensor:
    """(B,) int32 draws in [0, Kp) from (B, K) weights truncated per row by
    ``params`` (B, 3) ``[top_k, top_p, min_p]`` (K9): the threshold tau by
    bisection, the mask ``w >= tau`` and the draw, in one launch."""
    return _fused_trunc_draw(w, u, params, W, iters, None)


def _fused_trunc_draw(w, u, params, W: int, iters: int, staged) -> torch.Tensor:
    """:func:`fused_trunc_draw` with each row staged in shared memory
    (``staged`` True) or read from L2 (False); None stages where it fits.
    Forcing is for measuring the two row sources against each other."""
    nb = num_blocks(w.shape[1], W)
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    _check_vec("u", u, torch.float32, B, w)
    _check_params(params, B, w)
    fits = trunc_row_staged(ncols, nb, W)
    if staged and not fits:
        raise ValueError(f"a row of {ncols} weights does not fit shared memory")
    out = torch.empty((B,), dtype=torch.int32, device=w.device)
    _launch("fused_trunc_draw", w.data_ptr(), u.data_ptr(), params.data_ptr(),
            out.data_ptr(), B, ncols, nb, W, int(iters),
            int(fits if staged is None else staged), _DTYPES[w.dtype])
    return out


def _mask(wf: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``wf * [wf >= tau[row]]``: the truncated rows."""
    return torch.where(wf >= tau[:, None], wf, torch.zeros((), dtype=wf.dtype,
                                                           device=wf.device))


def fused_trunc_draw_torch(w, u, params, W: int, iters: int = 32) -> torch.Tensor:
    """Plain version of :func:`fused_trunc_draw`: tau from
    ``transforms.thresholds_from_params``, then the draw on the masked
    weights."""
    from repro_torch.sampling import transforms as _tr

    wf = _float_rows(w)
    return fused_draw_torch(_mask(wf, _tr.thresholds_from_params(wf, params, iters=iters)),
                            u, W)


# ---------------------------------------------------------------------------
# K11: running block sums of the masked weights w * [w >= tau]
# ---------------------------------------------------------------------------


def masked_blocksums(w, tau, W: int, nb: int) -> torch.Tensor:
    """(B, nb) float32 running W-block sums of ``w * [w >= tau[row]]``
    (K11); the masked weights are never written."""
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    _check_vec("tau", tau, torch.float32, B, w)
    out = torch.empty((B, nb), dtype=torch.float32, device=w.device)
    _launch("masked_blocksums", w.data_ptr(), tau.data_ptr(), out.data_ptr(), B,
            ncols, nb, W, _DTYPES[w.dtype])
    return out


def masked_blocksums_torch(w, tau, W: int, nb: int) -> torch.Tensor:
    """Plain version of :func:`masked_blocksums`."""
    return blocksums_torch(_mask(_float_rows(w), tau), W, nb)


# ---------------------------------------------------------------------------
# K12: walk the selected W-block of each draw's row, re-masked by its tau
# ---------------------------------------------------------------------------


def walk_trunc(w, running, u, tau, rows, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) from masked running sums (K12): draw s
    uses row ``rows[s]``, reads only block jb of that row and masks it
    with ``tau[rows[s]]``.  rows must index valid rows (not checked)."""
    nb = running.shape[1]
    ncols = _check_weights(w, nb, W)
    _check_running(running, w)
    B = w.shape[0]
    if running.shape[0] != B:
        raise ValueError("running and weights must have one row per sample")
    _check_vec("tau", tau, torch.float32, B, w)
    Bt = u.shape[0]
    _check_vec("u", u, torch.float32, Bt, w)
    _check_vec("rows", rows, torch.int32, Bt, w)
    out = torch.empty((Bt,), dtype=torch.int32, device=w.device)
    _launch("walk_trunc", w.data_ptr(), running.data_ptr(), u.data_ptr(),
            tau.data_ptr(), rows.data_ptr(), out.data_ptr(), Bt, ncols, nb, W,
            _DTYPES[w.dtype])
    return out


def walk_trunc_torch(w, running, u, tau, rows, W: int) -> torch.Tensor:
    """Plain version of :func:`walk_trunc`."""
    ncols = w.shape[1]
    rows = rows.long()
    run = running[rows]
    stop = run[:, -1] * u.float()
    jb, lo = _select_tile(run, stop, W)
    cols = jb.long()[:, None] * W + torch.arange(W, device=w.device)[None, :]
    valid = cols < ncols
    blk = _float_rows(w[rows[:, None], cols.clamp(max=ncols - 1)])
    blk = torch.where(valid & (blk >= tau[rows][:, None]), blk,
                      torch.zeros((), dtype=blk.dtype, device=w.device))
    R = _descent_tile(_fenwick_tile(blk, W), stop, lo, W)
    return jb * W + R
