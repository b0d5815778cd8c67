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

Eight kernels replace the reference's Pallas kernels in
``repro/kernels/butterfly_sample/kernel.py``; the first four are in
``csrc/butterfly_sample.cu``, the truncated draws in
``csrc/butterfly_trunc.cu``:

========================  =======================================  ===============================
wrapper                   replaces                                 plain version
========================  =======================================  ===============================
``blocksums``             ``_blocksum_kernel`` (K2)                ``blocksums_torch``
``walk``                  ``_walk_kernel`` (K3)                    ``walk_torch``
``fused_draw``            ``_fused_draw_kernel`` (K4)              ``fused_draw_torch``
``fused_draw_rng``        ``_fused_draw_rng_kernel`` (K5)          ``fused_draw_rng_torch``
``fused_trunc_draw``      ``_fused_trunc_draw_kernel`` (K9)        ``fused_trunc_draw_torch``
``fused_trunc_draw_rng``  ``_fused_trunc_draw_rng_kernel`` (K10)   ``fused_trunc_draw_rng_torch``
``masked_blocksums``      ``_masked_blocksum_kernel`` (K11)        ``masked_blocksums_torch``
``walk_trunc``            ``_walk_trunc_kernel`` (K12)             ``walk_trunc_torch``
========================  =======================================  ===============================

K5 and K10 are K4 and K9 with their uniforms made in the kernel from a
(2,) seed already folded with ``rng.TAG_U`` and the first row's global
id: row r draws with ``rng.row_uniforms(seed2, row_offset, B)[r]``
(Threefry, ``kernels/csrc/threefry.cuh``), or, for K5 with ``hw=True``,
with ``rng.philox_row_uniforms``.  ``threefry_uniforms`` writes the
Threefry stream alone (plain version ``rng.row_uniforms``) so that the
device cipher can be held against the plain one; no draw path calls it.

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch failed, and
adds one to its count in :data:`LAUNCHES`.  Handed fake tensors (a
dry-run trace) it allocates the same and runs its fake rule in place of
the launch (:mod:`repro_torch.kernels.fake`).  Rows may be narrower than
Kp = nb * W: columns at or past a row's width count as zero (the padding
of K to a multiple of W), so nobody copies the weights to pad them.

K2, K4 and K5 run in one of two layouts (:data:`LAYOUTS`), which give
the same sums and indices: ``"warp"``, one warp per row, for narrow rows
and many of them (the sweep's chunk), and ``"split"``, a row split over
several thread blocks as K11 splits it, for wide rows (a vocabulary); K2's
split reads four columns a lane and two tiles per warp at once.
:func:`fused_layout` (K4/K5) and :func:`blocksums_layout` (K2) pick one
from the shapes before the launch; the
private ``_blocksums``, ``_fused_draw`` and ``_fused_draw_rng`` take
``layout=`` to force one, for holding the two against each other on the
card.  K3 runs one
draw per group of W / 4 lanes and reads each lane's four weights with one
16-byte load where the rows allow it (:func:`walk_vector_loads`), four
loads otherwise.  K12 runs in one of :data:`WALK_TRUNC_LAYOUTS`, which
give the same indices: ``"warp"``, one warp per draw, and ``"group"``,
K3's group walk on the masked weights, which :func:`walk_trunc_layout`
picks; the private ``_walk_trunc`` takes ``layout=``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fake as _fake
from repro_torch.kernels import rng as _rng
from repro_torch.kernels import runtime

# launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"blocksums": 0, "walk": 0, "fused_draw": 0,
                            "fused_draw_rng": 0, "threefry_uniforms": 0,
                            "fused_trunc_draw": 0, "fused_trunc_draw_rng": 0,
                            "masked_blocksums": 0, "walk_trunc": 0}

# Fused / two-pass switch.  The fused kernel (K4) keeps one sample's nb
# running sums and one W-block in shared memory, _WARPS_PER_BLOCK samples
# per block; it runs while that fits the 48 KB of dynamic shared memory a
# block gets without opting in (nb + W <= 3072 floats per sample: K up to
# ~390,000 at W=128), and the two-pass route (K2 then K3) beyond.
_WARPS_PER_BLOCK = 4
_FUSED_SMEM_BYTES = 48 << 10

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K4/K5 layouts.  The split layout reads a row with up to a few hundred
# warps in place of one; it pays a scratch, a per-row arrival counter and
# a scan by the row's last block, which narrow rows do not repay.
# _SPLIT_COLS is the row width (nb * W columns) from which the split
# layout is taken: on the H100 it won from 2,048 columns at B = 64, 1,024
# and 27,392 and lost below (chip_smoke.py phase 2g; PERF.md).
LAYOUTS = ("warp", "split")
_SPLIT_COLS = 2048

# K12's layouts: one warp per draw, or a group of W / 4 lanes per draw
# (K3's group walk on masked weights), which walk_trunc_layout picks.
WALK_TRUNC_LAYOUTS = ("warp", "group")

# The fused truncated draw (K9) runs one block of _TRUNC_THREADS threads per
# row and stages the row (as fp32) in dynamic shared memory while
# (2 * _TRUNC_THREADS / 32 + max(_TRUNC_LIST_CAP, nb + W) + K) floats fit
# the 227 KB a block may opt into (K up to 56,000 at W = 128); a longer row
# is read from global memory (L2) on every pass.  chip_smoke.py times both
# at K = 32,000 and 56,000 (PERF.md).  The scratch of max(_TRUNC_LIST_CAP,
# nb + W) floats holds the radix select's histogram, then top-p's list of
# the top-k survivors (a row with more survivors sums the whole row
# instead, to the same result), then the draw's running sums and W-block.
_TRUNC_THREADS = 1024
_TRUNC_LIST_CAP = 2048
_MAX_SMEM_BYTES = 232448
_THRESHOLDS = ("radix", "bisect")


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


def fused_layout(B: int, nb: int, W: int) -> str:
    """The layout of K4/K5 for B rows of nb W-blocks: ``"split"`` for
    rows of at least ``_SPLIT_COLS`` columns, else ``"warp"``.  The
    crossover was measured at the same width for every B timed, so B
    does not enter the rule."""
    return "split" if nb * W >= _SPLIT_COLS else "warp"


def blocksums_layout(B: int, nb: int, W: int) -> str:
    """The layout of K2 for B rows of nb W-blocks: K4/K5's
    (:func:`fused_layout`), so that the two-pass and fused routes of one
    shape run the same layout.  K2's own split also won from 512 columns
    for up to 1,024 rows (chip_smoke.py phase 2g; PERF.md), but no path
    runs rows of 512 to 2,047 columns; the autotuner is to take that
    crossover up."""
    return fused_layout(B, nb, W)


def _resolve_layout(layout, B: int, nb: int, W: int, rule=None) -> str:
    if layout is None:
        return (rule or fused_layout)(B, nb, W)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS} or None, got {layout!r}")
    return layout


def walk_vector_loads(w: torch.Tensor) -> bool:
    """True when K3 may read four weights per lane with one load: every
    row start 16-byte aligned (8-byte for bf16), i.e. an aligned base and
    a row width that is a multiple of 4."""
    return w.shape[1] % 4 == 0 and w.data_ptr() % (4 * w.element_size()) == 0


def trunc_row_staged(ncols: int, nb: int, W: int) -> bool:
    """True when K9 can stage a row of ``ncols`` weights in shared memory."""
    scratch = max(_TRUNC_LIST_CAP, nb + W)
    return 4 * (2 * _TRUNC_THREADS // 32 + scratch + ncols) <= _MAX_SMEM_BYTES


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# ctypes binding and checks
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGS = {
    "blocksums": [_P] * 3 + [_I] * 6 + [_P],
    "walk": [_P] * 5 + [_I] * 6 + [_P],
    "fused_draw": [_P] * 5 + [_I] * 6 + [_P],
    "fused_draw_rng": [_P] * 4 + [_I] * 5 + [_U] * 3 + [_I] * 2 + [_P],
    "threefry_uniforms": [_P, _I] + [_U] * 3 + [_P],
}


_TRUNC_SIGS = {
    "fused_trunc_draw": [_P] * 4 + [_I] * 8 + [_P],
    "fused_trunc_draw_rng": [_P] * 3 + [_I] * 7 + [_U] * 3 + [_I, _P],
    "masked_blocksums": [_P] * 4 + [_I] * 5 + [_P],
    "walk_trunc": [_P] * 6 + [_I] * 6 + [_P],
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


def _seed_args(seed2, row_offset):
    """(s0, s1, row_offset) as the kernels' uint32 arguments: a folded
    (2,) seed and the first row's global id (an int or a 0-dim tensor),
    reduced modulo 2**32 as the reference's uint32 counters are."""
    s0, s1 = _rng.seed_words(seed2)
    return s0, s1, int(row_offset) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# K2: running block sums of given weights
# ---------------------------------------------------------------------------


def blocksums(w: torch.Tensor, W: int, nb: int) -> torch.Tensor:
    """(B, nb) float32 running W-block sums of (B, K) weights (K2).  The
    kernel writes the running sums itself: no cumsum follows."""
    return _blocksums(w, W, nb)


def _blocksums(w: torch.Tensor, W: int, nb: int, layout=None) -> torch.Tensor:
    """:func:`blocksums` in the layout ``layout`` (``"warp"`` or
    ``"split"``); None picks it with :func:`blocksums_layout`.  Both give
    the same sums bit for bit; forcing is for timing them against each
    other."""
    B = w.shape[0]
    layout = _resolve_layout(layout, B, nb, W, blocksums_layout)
    ncols = _check_weights(w, nb, W)
    split = layout == "split"
    out = torch.empty((B, nb), dtype=torch.float32, device=w.device)
    fake = _fake.is_fake(w)
    arrived = _arrival_counters(B, w.device, fake) if split else None
    if fake:
        _fake.traced("blocksums", B * ncols * w.element_size() + B * nb * 4)
        return out
    _launch("blocksums", w.data_ptr(), out.data_ptr(), _ptr(arrived), B, ncols, nb, W,
            int(split), _DTYPES[w.dtype])
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
    row ``rows[s]`` of ``w``.  The kernel finds jb itself, with W / 4
    lanes per draw.  rows must index valid rows (not checked: that would
    synchronise)."""
    nb = running.shape[1]
    ncols = _check_weights(w, nb, W)
    _check_running(running, w)
    if running.shape[0] != w.shape[0]:
        raise ValueError("running and weights must have one row per sample")
    Bt = u.shape[0]
    _check_vec("u", u, torch.float32, Bt, w)
    _check_vec("rows", rows, torch.int32, Bt, w)
    out = torch.empty((Bt,), dtype=torch.int32, device=w.device)
    if _fake.is_fake(w):  # one running row per row, one W-block per draw
        _fake.traced("walk", running.numel() * 4 + Bt * (W * w.element_size() + 12))
        return out
    _launch("walk", w.data_ptr(), running.data_ptr(), u.data_ptr(),
            rows.data_ptr(), out.data_ptr(), Bt, ncols, nb, W,
            int(walk_vector_loads(w)), _DTYPES[w.dtype])
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
    return _fused_draw(w, u, W)


def _split_buffers(layout: str, B: int, nb: int, device, fake: bool = False):
    """Scratch (B, nb) float32 running sums and the per-row arrival
    counters of the split layout; nothing for the warp layout."""
    if layout == "warp":
        return None, None
    return (torch.empty((B, nb), dtype=torch.float32, device=device),
            _arrival_counters(B, device, fake))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _fused_draw(w, u, W: int, layout=None) -> torch.Tensor:
    """:func:`fused_draw` in the layout ``layout`` (``"warp"`` or
    ``"split"``); None picks it with :func:`fused_layout`.  Both give the
    same indices; forcing is for timing them against each other."""
    B, nb = w.shape[0], num_blocks(w.shape[1], W)
    layout = _resolve_layout(layout, B, nb, W)
    ncols = _check_weights(w, nb, W)
    _check_vec("u", u, torch.float32, B, w)
    if not fused_fits(nb, W):
        raise ValueError(f"fused draw needs too much shared memory at nb={nb}, W={W}")
    fake = _fake.is_fake(w)
    scratch, arrived = _split_buffers(layout, B, nb, w.device, fake)
    out = torch.empty((B,), dtype=torch.int32, device=w.device)
    if fake:
        _fake.traced("fused_draw", B * ncols * w.element_size() + B * 8)
        return out
    _launch("fused_draw", w.data_ptr(), u.data_ptr(), out.data_ptr(), _ptr(scratch),
            _ptr(arrived), B, ncols, nb, W, int(layout == "split"), _DTYPES[w.dtype])
    return out


def fused_draw_torch(w, u, W: int) -> torch.Tensor:
    """Plain version of :func:`fused_draw`: pass A then pass B."""
    nb = num_blocks(w.shape[1], W)
    running = blocksums_torch(w, W, nb)
    rows = torch.arange(w.shape[0], device=w.device)
    return walk_torch(w, running, u, rows, W)


# ---------------------------------------------------------------------------
# K5: the fused draw with its uniforms made in the kernel
# ---------------------------------------------------------------------------


def fused_draw_rng(w, seed2, row_offset, W: int, hw: bool = False) -> torch.Tensor:
    """(B,) int32 draws in [0, Kp) from (B, K) weights in one launch (K5):
    K4 with row r's uniform made in the kernel from the folded seed
    ``seed2`` and global row ``row_offset + r`` (Threefry; Philox with
    ``hw``).  No uniform tensor exists."""
    return _fused_draw_rng(w, seed2, row_offset, W, hw)


def _fused_draw_rng(w, seed2, row_offset, W: int, hw: bool = False, layout=None
                    ) -> torch.Tensor:
    """:func:`fused_draw_rng` in the layout ``layout``, as
    :func:`_fused_draw`."""
    B, nb = w.shape[0], num_blocks(w.shape[1], W)
    layout = _resolve_layout(layout, B, nb, W)
    ncols = _check_weights(w, nb, W)
    if not fused_fits(nb, W):
        raise ValueError(f"fused draw needs too much shared memory at nb={nb}, W={W}")
    fake = _fake.is_fake(w)
    scratch, arrived = _split_buffers(layout, B, nb, w.device, fake)
    out = torch.empty((B,), dtype=torch.int32, device=w.device)
    if fake:
        _fake.traced("fused_draw_rng", B * ncols * w.element_size() + B * 4)
        return out
    _launch("fused_draw_rng", w.data_ptr(), out.data_ptr(), _ptr(scratch), _ptr(arrived),
            B, ncols, nb, W, int(layout == "split"), *_seed_args(seed2, row_offset),
            int(bool(hw)), _DTYPES[w.dtype])
    return out


def _row_uniforms(seed2, row_offset, n: int, device, hw: bool = False) -> torch.Tensor:
    seed2 = _rng._u32(seed2, device)
    if hw:
        return _rng.philox_row_uniforms(seed2, row_offset, n)
    return _rng.row_uniforms(seed2, row_offset, n)


def fused_draw_rng_torch(w, seed2, row_offset, W: int, hw: bool = False) -> torch.Tensor:
    """Plain version of :func:`fused_draw_rng`: the counter uniforms
    (``rng.row_uniforms``, or ``rng.philox_row_uniforms`` with ``hw``),
    then :func:`fused_draw_torch`."""
    return fused_draw_torch(w, _row_uniforms(seed2, row_offset, w.shape[0], w.device, hw),
                            W)


def threefry_uniforms(seed2, row_offset, n: int, device) -> torch.Tensor:
    """(n,) float32 uniforms of global rows [row_offset, row_offset + n)
    made by the device cipher of K5 and K10; plain version
    ``rng.row_uniforms``.  For holding the two ciphers against each
    other: no draw path calls it."""
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if out.device.type != "cuda":
        raise ValueError(f"threefry_uniforms runs on a CUDA device, got {out.device}")
    _launch("threefry_uniforms", out.data_ptr(), n, *_seed_args(seed2, row_offset))
    return out


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
    ``params`` (B, 3) ``[top_k, top_p, min_p]`` (K9): the threshold tau of
    ``transforms.thresholds_from_params`` (top-k by radix select, top-p by
    bisection over the top-k survivors), the mask ``w >= tau`` and the
    draw, in one launch."""
    return _fused_trunc_draw(w, u, params, W, iters, None)


def _list_cap(threshold) -> int:
    if threshold not in (None, *_THRESHOLDS):
        raise ValueError(f"threshold must be one of {_THRESHOLDS}, got {threshold!r}")
    return 0 if threshold == "bisect" else _TRUNC_LIST_CAP


def _fused_trunc_draw(w, u, params, W: int, iters: int, staged, threshold=None
                      ) -> torch.Tensor:
    """:func:`fused_trunc_draw` with each row staged in shared memory
    (``staged`` True) or read from L2 (False); None stages where it fits.
    ``threshold="bisect"`` runs the reference's bisection over the whole
    row for top-k and top-p (66 passes) in place of the radix select and
    the survivor list ("radix", the default; top-k bisects there too when
    ``iters < 32``).  The two give equal draws.  Forcing is for measuring
    the row sources and the threshold bodies against each other."""
    list_cap = _list_cap(threshold)
    nb = num_blocks(w.shape[1], W)
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    _check_vec("u", u, torch.float32, B, w)
    _check_params(params, B, w)
    fits = trunc_row_staged(ncols, nb, W)
    if staged and not fits:
        raise ValueError(f"a row of {ncols} weights does not fit shared memory")
    out = torch.empty((B,), dtype=torch.int32, device=w.device)
    if _fake.is_fake(w):
        _fake.traced("fused_trunc_draw", B * ncols * w.element_size() + B * (4 + 12 + 4))
        return out
    _launch("fused_trunc_draw", w.data_ptr(), u.data_ptr(), params.data_ptr(),
            out.data_ptr(), B, ncols, nb, W, int(iters),
            int(fits if staged is None else staged), list_cap, _DTYPES[w.dtype])
    return out


def fused_trunc_draw_rng(w, seed2, row_offset, params, W: int, iters: int = 32
                         ) -> torch.Tensor:
    """(B,) int32 truncated draws in [0, Kp) (K10): K9 with row r's
    uniform made in the kernel from the folded seed ``seed2`` and global
    row ``row_offset + r``.  Rows are staged in shared memory where they
    fit, as K9's."""
    nb = num_blocks(w.shape[1], W)
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    _check_params(params, B, w)
    out = torch.empty((B,), dtype=torch.int32, device=w.device)
    if _fake.is_fake(w):
        _fake.traced("fused_trunc_draw_rng", B * ncols * w.element_size() + B * (12 + 4))
        return out
    _launch("fused_trunc_draw_rng", w.data_ptr(), params.data_ptr(), out.data_ptr(), B,
            ncols, nb, W, int(iters), int(trunc_row_staged(ncols, nb, W)),
            _TRUNC_LIST_CAP, *_seed_args(seed2, row_offset), _DTYPES[w.dtype])
    return out


def fused_trunc_draw_rng_torch(w, seed2, row_offset, params, W: int, iters: int = 32
                               ) -> torch.Tensor:
    """Plain version of :func:`fused_trunc_draw_rng`: ``rng.row_uniforms``,
    then :func:`fused_trunc_draw_torch`."""
    u = _row_uniforms(seed2, row_offset, w.shape[0], w.device)
    return fused_trunc_draw_torch(w, u, params, W, iters)


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


# The per-row arrival counters of K11 and of K2's and K4/K5's split layouts, one
# zeroed buffer per (device, stream): each kernel leaves them zero again,
# and launches on one stream never overlap, so the kernels can share the
# buffer and no call pays for a memset.
_ARRIVED: Dict[tuple, torch.Tensor] = {}


def _arrival_counters(B: int, device, fake: bool = False) -> torch.Tensor:
    if fake:  # a trace's: the first call's allocation, never kept
        return torch.zeros((max(B, 64),), dtype=torch.int32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _ARRIVED.get(key)
    if t is None or t.numel() < B:
        t = torch.zeros((max(B, 64),), dtype=torch.int32, device=device)
        _ARRIVED[key] = t
    return t


def masked_blocksums(w, tau, W: int, nb: int) -> torch.Tensor:
    """(B, nb) float32 running W-block sums of ``w * [w >= tau[row]]``
    (K11); the masked weights are never written.  Several blocks share a
    row; a per-row counter counts them in, and the last one scans the
    row."""
    ncols = _check_weights(w, nb, W)
    B = w.shape[0]
    _check_vec("tau", tau, torch.float32, B, w)
    out = torch.empty((B, nb), dtype=torch.float32, device=w.device)
    if _fake.is_fake(w):
        _arrival_counters(B, w.device, fake=True)
        _fake.traced("masked_blocksums", B * ncols * w.element_size() + B * 4 + B * nb * 4)
        return out
    _launch("masked_blocksums", w.data_ptr(), tau.data_ptr(), out.data_ptr(),
            _arrival_counters(B, w.device).data_ptr(), B, ncols, nb, W,
            _DTYPES[w.dtype])
    return out


def masked_blocksums_torch(w, tau, W: int, nb: int) -> torch.Tensor:
    """Plain version of :func:`masked_blocksums`."""
    return blocksums_torch(_mask(_float_rows(w), tau), W, nb)


# ---------------------------------------------------------------------------
# K12: walk the selected W-block of each draw's row, re-masked by its tau
# ---------------------------------------------------------------------------


def walk_trunc_layout(nb: int, W: int) -> str:
    """The layout of K12 for draws from running rows of nb W-blocks:
    ``"group"`` at every W in [8, 128] (it needs no shared memory)."""
    runtime.check_w(W)
    return "group"


def walk_trunc(w, running, u, tau, rows, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) from masked running sums (K12): draw s
    uses row ``rows[s]``, reads only block jb of that row and masks it
    with ``tau[rows[s]]``.  rows must index valid rows (not checked)."""
    return _walk_trunc(w, running, u, tau, rows, W)


def _walk_trunc(w, running, u, tau, rows, W: int, layout=None) -> torch.Tensor:
    """:func:`walk_trunc` in the layout ``layout`` (``"warp"`` or
    ``"group"``, :data:`WALK_TRUNC_LAYOUTS`); None picks it with
    :func:`walk_trunc_layout`.  Both give the same indices; forcing is for
    holding and timing them against each other."""
    nb = running.shape[1]
    if layout is None:
        layout = walk_trunc_layout(nb, W)
    elif layout not in WALK_TRUNC_LAYOUTS:
        raise ValueError(f"layout must be one of {WALK_TRUNC_LAYOUTS} or None, "
                         f"got {layout!r}")
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
    if _fake.is_fake(w):
        _fake.traced("walk_trunc", B * nb * 4 + Bt * (W * w.element_size() + 16))
        return out
    _launch("walk_trunc", w.data_ptr(), running.data_ptr(), u.data_ptr(),
            tau.data_ptr(), rows.data_ptr(), out.data_ptr(), Bt, ncols, nb, W,
            int(layout == "group"), _DTYPES[w.dtype])
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
