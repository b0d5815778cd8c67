"""Factored LDA z-draw kernels: wrappers for the Hopper kernels, and the
plain PyTorch version of each beside it.

Three kernels (``csrc/lda_draw.cu``) replace the reference's three Pallas
kernels in ``repro/kernels/lda_draw/kernel.py``:

==================  =====================================  =============
wrapper             replaces                               plain version
==================  =====================================  =============
``lda_fused_draw``  ``_fused_factored_kernel`` (K8)        ``lda_fused_draw_torch``
``lda_blocksums``   ``_factored_blocksum_kernel`` (K6)     ``lda_blocksums_torch``
``lda_walk``        ``_factored_walk_kernel`` (K7)         ``lda_walk_torch``
==================  =====================================  =============

A wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on the
current stream without synchronising, raises if the launch failed, and
adds one to its count in :data:`LAUNCHES`.  The plain versions run on any
device and never form a (samples, K) tensor: every intermediate is
(samples, W), (samples, TK) or (samples, nb), as in the reference's XLA
twin.

Rows may be narrower than Kp = nb * W: columns at or past a row's width
count as zero (the padding of K to a multiple of W), so nobody copies
``phi`` to pad it.

K8 runs in one of two layouts (:data:`LAYOUTS`), which give the same
indices: ``"warp"``, one warp per draw with the product row in shared
memory, and ``"group"``, a group of W / 4 lanes per draw (32 / (W / 4)
draws per warp) with only the nb block sums in shared memory and four
columns a lane (one 16-byte load per factor where every row start is
aligned).  :func:`lda_fused_layout` picks one from the shapes before the
launch; the private ``_lda_fused_draw`` takes ``layout=`` to force one.
K7 has the same two layouts, its group one walking a running row read
from global memory (K8's ``group_walk``); :func:`lda_walk_layout` picks
it, the private ``_lda_walk`` takes ``layout=``.  K6 has them too, its
group one K8's group pass A (block sums and their scan in the group's
shared memory) writing the scanned row out; :func:`lda_blocksums_layout`
picks it where it fits, the private ``_lda_blocksums`` takes ``layout=``.
The running sums are the same bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import runtime
from repro_torch.kernels.butterfly_sample.kernel import (
    _DTYPES,
    _check_vec,
    _descent_tile,
    _fenwick_tile,
    _select_tile,
    num_blocks,
)

# launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {"lda_fused_draw": 0, "lda_blocksums": 0, "lda_walk": 0}

# Fused / two-pass switch.  The fused kernel keeps, per draw, the product
# row and block sums in shared memory in its warp layout (_WARPS_PER_BLOCK
# draws per block) or the nb block sums in its group layout; it runs while
# either fits the 48 KB of dynamic shared memory a block gets without
# opting in, and the two-pass route (K6 then K7) beyond.
_WARPS_PER_BLOCK = 4
_FUSED_SMEM_BYTES = 48 << 10

# K8's, K7's and K6's layouts.  The group layouts of K8 and K6 keep nb
# floats per draw in shared memory, 32 / (W / 4) draws per warp
# (group_fits); K7's keeps none.
LAYOUTS = ("warp", "group")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_fits(nb: int, W: int) -> bool:
    """True when the fused kernel's shared memory fits one block in the
    warp layout."""
    return 4 * _WARPS_PER_BLOCK * (nb * W + nb) <= _FUSED_SMEM_BYTES


def group_fits(nb: int, W: int) -> bool:
    """True when K8's (or K6's) group layout, nb floats per draw, fits one
    block."""
    return 4 * (_WARPS_PER_BLOCK * 32 // (W // 4)) * nb <= _FUSED_SMEM_BYTES


def lda_fused_layout(nb: int, W: int) -> str:
    """The layout of K8 for draws from rows of nb W-blocks: ``"group"``
    where its shared memory fits, else ``"warp"``."""
    return "group" if group_fits(nb, W) else "warp"


def lda_blocksums_layout(nb: int, W: int) -> str:
    """The layout of K6 for rows of nb W-blocks: K8's rule
    (:func:`lda_fused_layout`), ``"group"`` where its shared memory fits,
    else ``"warp"``."""
    return lda_fused_layout(nb, W)


def lda_walk_layout(nb: int, W: int) -> str:
    """The layout of K7 for draws from running rows of nb W-blocks:
    ``"group"`` at every W in [8, 128] (it needs no shared memory)."""
    runtime.check_w(W)
    return "group"


def _resolve_layout(layout, rule: str) -> str:
    """``layout`` checked against :data:`LAYOUTS`; None takes ``rule``."""
    if layout is None:
        return rule
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS} or None, got {layout!r}")
    return layout


# ---------------------------------------------------------------------------
# ctypes binding
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "lda_fused_draw": [_P] * 6 + [_I] * 6 + [_P],
    "lda_blocksums": [_P] * 5 + [_I] * 6 + [_P],
    "lda_walk": [_P] * 8 + [_I] * 6 + [_P],
}


def _launch(name: str, *args) -> None:
    lib = _build.bind("lda_draw", _SIGS, ("lda_warps_per_block", _WARPS_PER_BLOCK))
    _build.launch(lib, name, LAUNCHES, *args)


def _check_factors(theta, phi, nb: int, W: int) -> int:
    runtime.check_w(W)
    for n, t in (("theta", theta), ("phi", phi)):
        if not t.is_cuda:
            raise ValueError(f"{n} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{n} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{n} must be a contiguous 2-D tensor")
    if phi.dtype != theta.dtype or phi.shape[1] != theta.shape[1]:
        raise ValueError("theta and phi must share dtype and row width")
    if phi.device != theta.device:
        raise ValueError("theta and phi must be on one device")
    ncols = theta.shape[1]
    if not (nb - 1) * W < ncols <= nb * W:
        raise ValueError(f"row width {ncols} does not give nb={nb} blocks of W={W}")
    return ncols


# ---------------------------------------------------------------------------
# K8: fused factored draw
# ---------------------------------------------------------------------------


def lda_fused_draw(theta, phi, doc_ids, words, u, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) from theta[doc_ids] * phi[words], one
    launch (K8).  Ids int32, u float32, all contiguous (Bt,) CUDA tensors;
    ids must index valid rows (not checked: that would synchronise)."""
    return _lda_fused_draw(theta, phi, doc_ids, words, u, W)


def _lda_fused_draw(theta, phi, doc_ids, words, u, W: int, layout=None) -> torch.Tensor:
    """:func:`lda_fused_draw` in the layout ``layout`` (``"warp"`` or
    ``"group"``); None picks it with :func:`lda_fused_layout`.  Both give
    the same indices; forcing is for timing them against each other."""
    nb = num_blocks(theta.shape[1], W)
    layout = _resolve_layout(layout, lda_fused_layout(nb, W))
    ncols = _check_factors(theta, phi, nb, W)
    Bt = u.shape[0]
    _check_vec("doc_ids", doc_ids, torch.int32, Bt, theta)
    _check_vec("words", words, torch.int32, Bt, theta)
    _check_vec("u", u, torch.float32, Bt, theta)
    if not (group_fits if layout == "group" else fused_fits)(nb, W):
        raise ValueError(f"fused draw ({layout} layout) needs too much shared memory "
                         f"at nb={nb}, W={W}")
    out = torch.empty((Bt,), dtype=torch.int32, device=theta.device)
    _launch(
        "lda_fused_draw", theta.data_ptr(), phi.data_ptr(), doc_ids.data_ptr(),
        words.data_ptr(), u.data_ptr(), out.data_ptr(), Bt, ncols, nb, W,
        int(layout == "group"), _DTYPES[theta.dtype],
    )
    return out


def lda_fused_draw_torch(theta, phi, doc_ids, words, u, W: int) -> torch.Tensor:
    """Plain version of :func:`lda_fused_draw`: pass A then pass B."""
    nb = num_blocks(theta.shape[1], W)
    running = lda_blocksums_torch(theta, phi, doc_ids, words, W, nb)
    rows = torch.arange(u.shape[0], device=u.device)
    return lda_walk_torch(theta, phi, running, u, rows, doc_ids, words, W)


# ---------------------------------------------------------------------------
# K6: running block sums of the factored weights
# ---------------------------------------------------------------------------


def lda_blocksums(theta, phi, doc_ids, words, W: int, nb: int) -> torch.Tensor:
    """(Bt, nb) float32 running W-block sums of theta[doc_ids] *
    phi[words] (K6); the (Bt, K) product never exists."""
    return _lda_blocksums(theta, phi, doc_ids, words, W, nb)


def _lda_blocksums(theta, phi, doc_ids, words, W: int, nb: int,
                   layout=None) -> torch.Tensor:
    """:func:`lda_blocksums` in the layout ``layout`` (``"warp"`` or
    ``"group"``); None picks it with :func:`lda_blocksums_layout`.  Both
    give the same sums; forcing is for holding and timing them against
    each other."""
    layout = _resolve_layout(layout, lda_blocksums_layout(nb, W))
    ncols = _check_factors(theta, phi, nb, W)
    Bt = doc_ids.shape[0]
    _check_vec("doc_ids", doc_ids, torch.int32, Bt, theta)
    _check_vec("words", words, torch.int32, Bt, theta)
    if layout == "group" and not group_fits(nb, W):
        raise ValueError(f"block sums (group layout) need too much shared memory "
                         f"at nb={nb}, W={W}")
    out = torch.empty((Bt, nb), dtype=torch.float32, device=theta.device)
    _launch(
        "lda_blocksums", theta.data_ptr(), phi.data_ptr(), doc_ids.data_ptr(),
        words.data_ptr(), out.data_ptr(), Bt, ncols, nb, W, int(layout == "group"),
        _DTYPES[theta.dtype],
    )
    return out


def _tile_cols(Kp: int, W: int) -> int:
    """Column tile of the plain pass A: per-block slices at small K,
    ~128-wide tiles beyond (the reference XLA twin's choice)."""
    return W if Kp <= 512 else max(W, 128)


def lda_blocksums_torch(theta, phi, doc_ids, words, W: int, nb: int) -> torch.Tensor:
    """Plain version of :func:`lda_blocksums`, streamed in (Bt, TK)
    column tiles."""
    Kp = nb * W
    ncols = theta.shape[1]
    TK = _tile_cols(Kp, W)
    doc_ids = doc_ids.long()
    words = words.long()
    sums = []
    for c0 in range(0, Kp, TK):
        c1 = min(c0 + TK, Kp)
        th = theta[:, c0:min(c1, ncols)][doc_ids].float()
        ph = phi[:, c0:min(c1, ncols)][words].float()
        prod = th * ph
        if prod.shape[1] < c1 - c0:  # the zero padding of the last block
            prod = torch.nn.functional.pad(prod, (0, c1 - c0 - prod.shape[1]))
        sums.append(prod.view(prod.shape[0], -1, W).sum(dim=-1))
    return torch.cumsum(torch.cat(sums, dim=1), dim=1)


# ---------------------------------------------------------------------------
# K7: walk only the selected W-block of each sample's rows
# ---------------------------------------------------------------------------


def lda_walk(theta, phi, running, u, rows, doc_ids, words, W: int) -> torch.Tensor:
    """(Bt,) int32 draws in [0, Kp) from prebuilt running block sums
    (K7): draw s uses running row ``rows[s]``, and reads only block jb of
    theta[doc_ids[s]] and phi[words[s]].  The kernel finds jb itself."""
    return _lda_walk(theta, phi, running, u, rows, doc_ids, words, W)


def _lda_walk(theta, phi, running, u, rows, doc_ids, words, W: int,
              layout=None) -> torch.Tensor:
    """:func:`lda_walk` in the layout ``layout`` (``"warp"`` or
    ``"group"``); None picks it with :func:`lda_walk_layout`.  Both give
    the same indices; forcing is for holding and timing them against each
    other."""
    nb = running.shape[1]
    layout = _resolve_layout(layout, lda_walk_layout(nb, W))
    ncols = _check_factors(theta, phi, nb, W)
    Bt = u.shape[0]
    if running.device != theta.device or running.dtype != torch.float32 \
            or running.dim() != 2 or not running.is_contiguous():
        raise ValueError("running must be a contiguous 2-D float32 CUDA tensor")
    _check_vec("u", u, torch.float32, Bt, theta)
    for n, t in (("rows", rows), ("doc_ids", doc_ids), ("words", words)):
        _check_vec(n, t, torch.int32, Bt, theta)
    out = torch.empty((Bt,), dtype=torch.int32, device=theta.device)
    _launch(
        "lda_walk", theta.data_ptr(), phi.data_ptr(), running.data_ptr(),
        u.data_ptr(), rows.data_ptr(), doc_ids.data_ptr(), words.data_ptr(),
        out.data_ptr(), Bt, ncols, nb, W, int(layout == "group"), _DTYPES[theta.dtype],
    )
    return out


def lda_walk_torch(theta, phi, running, u, rows, doc_ids, words, W: int) -> torch.Tensor:
    """Plain version of :func:`lda_walk`: gathers one W-block per draw."""
    ncols = theta.shape[1]
    run = running[rows.long()]
    stop = run[:, -1] * u.float()
    jb, lo = _select_tile(run, stop, W)
    cols = jb.long()[:, None] * W + torch.arange(W, device=theta.device)[None, :]
    valid = cols < ncols
    cc = cols.clamp(max=ncols - 1)
    th = theta[doc_ids.long()[:, None], cc].float()
    ph = phi[words.long()[:, None], cc].float()
    blk = torch.where(valid, th * ph, torch.zeros((), device=theta.device))
    R = _descent_tile(_fenwick_tile(blk, W), stop, lo, W)
    return jb * W + R


# ---------------------------------------------------------------------------
# The reference's _lda_draw_impl: route switch and clipping
# ---------------------------------------------------------------------------


def lda_draw_docs(theta, phi, doc_ids, words, u, W: int, impl: Optional[str] = None,
                  route: Optional[str] = None) -> torch.Tensor:
    """(B,) int32 draws in [0, K): one launch of K8, or K6 then K7 when
    ``route="two_pass"`` or when the fused kernel's shared memory fits in
    neither layout (``route=None``).  Both routes return the same
    indices."""
    K = theta.shape[1]
    nb = num_blocks(K, W)
    if route is None:
        route = "fused" if group_fits(nb, W) or fused_fits(nb, W) else "two_pass"
    if route not in ("fused", "two_pass"):
        raise ValueError(f"route must be 'fused' or 'two_pass', got {route!r}")
    if runtime.resolve_impl(impl, theta) == "torch":
        idx = lda_fused_draw_torch(theta, phi, doc_ids, words, u, W)
    elif route == "fused":
        idx = lda_fused_draw(theta, phi, doc_ids, words, u, W)
    else:
        running = lda_blocksums(theta, phi, doc_ids, words, W, nb)
        rows = torch.arange(u.shape[0], dtype=torch.int32, device=u.device)
        idx = lda_walk(theta, phi, running, u, rows, doc_ids, words, W)
    return idx.clamp_(max=K - 1)
