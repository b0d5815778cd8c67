"""The sparse LDA MH sweep: the wrapper of the Hopper kernel S1.

``mh_sweep`` launches ``csrc/sparse_mh.cu`` (``steps`` MH cycles of every
live token in registers, in-kernel Threefry); it replaces no TPU kernel,
since the reference's ``_mh_sweep`` (``repro/lda/sparse.py``) is plain
XLA, but a literal PyTorch translation is hundreds of small launches per
chunk.  Its plain version is ``ref.mh_sweep_torch``, which it equals bit
for bit.

S1 has two layouts (:data:`LAYOUTS`) that make the same float operations
in the same order: ``"position"``, the first port's kernel (one thread a
word position, 64 positions of one document a block, the document's list
scanned every cycle), and ``"doc"`` (one document a block of 128
threads, its list staged once with a topic -> count map in shared
memory, a binary search for the doc-sparse position, threads looping
over its live tokens; ``ref.mh_sweep_doc_order_torch`` models it).
:func:`mh_layout` picks one from the shape; the private
:func:`_mh_sweep` takes ``layout=`` to force one.

The inputs are what ``lda.sparse.sparse_counts`` gives: each document's
ids in [0, K) and its counts >= 0 (so their prefix is non-decreasing,
which the binary search needs), topics z in [0, K) and words indexing
phi's rows (none of it checked: that would synchronise).

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the new topics and three counters (the word and
doc accepts and the live positions, zeroed) with ``torch``, launches on
the current stream without synchronising, raises if the launch failed,
and adds one to ``LAUNCHES["sparse_mh"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rng as _rng
from repro_torch.kernels.sparse_mh.ref import MODES, ceil_log2

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"sparse_mh": 0}
LAYOUTS = ("position", "doc")
DOC_THREADS = 128    # threads a block of the doc layout (kDocThreads)
# a block's shared memory without opting in; the doc layout's static part
# (warp counts and accept sums) is 48 bytes
_SMEM_LIMIT = 48 * 1024
_DOC_STATIC_SMEM = 48
# the position layout keeps a document's list (ids, cnt, cc): 12 bytes an
# entry within the limit
MAX_CAP = 4096

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGS = {"sparse_mh": [_P] * 11 + [_I] * 8 + [_U] * 3 + [ctypes.c_float, _P]}


def reset_launches() -> None:
    LAUNCHES["sparse_mh"] = 0


def _check(name: str, t: torch.Tensor, dtype, shape, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def doc_bytes(K: int, cap: int, L: int) -> int:
    """Shared memory one document takes in the doc layout: its topic ->
    count map, ids and cc, and its positions in the live list."""
    return 4 * (K + 2 * cap + L)


def fitting_layouts(K: int, cap: int, L: int) -> tuple:
    """The layouts of :data:`LAYOUTS` that take lists of ``cap`` over K
    topics and documents of L positions."""
    doc_fits = doc_bytes(K, cap, L) + _DOC_STATIC_SMEM <= _SMEM_LIMIT
    return tuple(lay for lay, ok in zip(LAYOUTS, (cap <= MAX_CAP, doc_fits)) if ok)


def mh_layout(K: int, cap: int, L: int) -> str:
    """S1's layout for documents of L positions, K topics and lists of
    ``cap``: ``"doc"`` where one document's map, list and positions fit a
    block's shared memory (about K + 2 cap + L <= 12,276), else
    ``"position"`` (a choice by shape, the same for every input)."""
    return "doc" if "doc" in fitting_layouts(K, cap, L) else "position"


def mh_sweep(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed, row0: int,
             alpha: float, *, steps: int, mode: str
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """S1: ``steps`` MH cycles over every position of (M, L) documents ->
    ``(z, word_accepts, doc_accepts, live_positions)``, the counts as 0-d
    int32 tensors, in the layout :func:`mh_layout` picks.

    z, docs (M, L) int32, mask (M, L) bool, theta (M, K) and phi (V, K)
    float32, ids and cnt (M, cap) int32, tbl_a (V, K) float32 and, for
    the alias modes, tbl_b (V, K) int32; ``seed`` a (2,) seed pair on the
    host; ``row0`` the first document's global index."""
    return _mh_sweep(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed, row0,
                     alpha, steps=steps, mode=mode)


def _mh_sweep(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed, row0: int,
              alpha: float, *, steps: int, mode: str, layout=None):
    """:func:`mh_sweep` in the layout ``layout`` (one of :data:`LAYOUTS`;
    None picks it with :func:`mh_layout`).  Both layouts give the same z
    and counts bit for bit."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS} or None, got {layout!r}")
    if not theta.is_cuda:
        raise ValueError(f"theta must be a CUDA tensor, got {theta.device}")
    if docs.dim() != 2 or theta.dim() != 2 or phi.dim() != 2 or ids.dim() != 2:
        raise ValueError("z, docs, theta, phi, ids and cnt must be 2-D")
    M, L = docs.shape
    K = theta.shape[1]
    V = phi.shape[0]
    cap = ids.shape[1]
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")
    if layout is None:
        layout = mh_layout(K, cap, L)
    if layout not in fitting_layouts(K, cap, L):
        raise ValueError(f"the {layout} layout does not take K={K}, cap={cap}, L={L} "
                         f"(fitting_layouts: {fitting_layouts(K, cap, L)})")
    for name, t, dtype, shape in (
            ("z", z, torch.int32, (M, L)), ("docs", docs, torch.int32, (M, L)),
            ("mask", mask, torch.bool, (M, L)), ("theta", theta, torch.float32, (M, K)),
            ("phi", phi, torch.float32, (V, K)), ("ids", ids, torch.int32, (M, cap)),
            ("cnt", cnt, torch.int32, (M, cap)), ("tbl_a", tbl_a, torch.float32, (V, K))):
        _check(name, t, dtype, shape, theta)
    alias = mode != "cdf"
    if alias:
        _check("tbl_b", tbl_b, torch.int32, (V, K), theta)
    s0, s1 = _rng.seed_words(seed)
    out = torch.empty((M, L), dtype=torch.int32, device=theta.device)
    acc = torch.zeros(3, dtype=torch.int32, device=theta.device)
    lib = _build.bind("sparse_mh", _SIGS, ("sparse_mh_doc_threads", DOC_THREADS))
    _build.launch(lib, "sparse_mh", LAUNCHES, z.data_ptr(), docs.data_ptr(),
                  mask.data_ptr(), theta.data_ptr(), phi.data_ptr(), ids.data_ptr(),
                  cnt.data_ptr(), tbl_a.data_ptr(), tbl_b.data_ptr() if alias else None,
                  out.data_ptr(), acc.data_ptr(), M, L, K, cap, steps, int(alias),
                  1 << ceil_log2(K), LAYOUTS.index(layout), s0, s1,
                  int(row0) & 0xFFFFFFFF, float(alpha))
    return out, acc[0], acc[1], acc[2]
