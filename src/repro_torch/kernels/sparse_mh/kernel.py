"""The sparse LDA MH sweep: the wrapper of the Hopper kernel S1.

``mh_sweep`` launches ``csrc/sparse_mh.cu`` (one thread per word
position, ``steps`` MH cycles in registers, in-kernel Threefry); it
replaces no TPU kernel, since the reference's ``_mh_sweep``
(``repro/lda/sparse.py``) is plain XLA, but a literal PyTorch
translation is hundreds of small launches per chunk.  Its plain version is
``ref.mh_sweep_torch``, which it equals bit for bit.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the new topics and three counters (the word and
doc accepts and the live positions, zeroed) with ``torch``, launches on the current stream without
synchronising, raises if the launch failed, and adds one to
``LAUNCHES["sparse_mh"]``.
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
_THREADS = 64   # positions per block (sparse_mh.cu's kThreads)
# a document's retained list (ids, cnt, cc) lives in a block's shared
# memory: 12 bytes an entry within the 48 KB a block gets without opting in
MAX_CAP = 4096

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGS = {"sparse_mh": [_P] * 11 + [_I] * 7 + [_U] * 3 + [ctypes.c_float, _P]}


def reset_launches() -> None:
    LAUNCHES["sparse_mh"] = 0


def _check(name: str, t: torch.Tensor, dtype, shape, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def mh_sweep(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed, row0: int,
             alpha: float, *, steps: int, mode: str
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """S1: ``steps`` MH cycles over every position of (M, L) documents ->
    ``(z, word_accepts, doc_accepts, live_positions)``, the counts as 0-d
    int32 tensors.

    z, docs (M, L) int32, mask (M, L) bool, theta (M, K) and phi (V, K)
    float32, ids and cnt (M, cap) int32, tbl_a (V, K) float32 and, for
    the alias modes, tbl_b (V, K) int32; ``seed`` a (2,) seed pair on the
    host; ``row0`` the first document's global index.  Words must index
    phi's rows (not checked: that would synchronise)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not theta.is_cuda:
        raise ValueError(f"theta must be a CUDA tensor, got {theta.device}")
    if docs.dim() != 2 or theta.dim() != 2 or phi.dim() != 2 or ids.dim() != 2:
        raise ValueError("z, docs, theta, phi, ids and cnt must be 2-D")
    M, L = docs.shape
    K = theta.shape[1]
    V = phi.shape[0]
    cap = ids.shape[1]
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"cap must be in [1, {MAX_CAP}], got {cap}")
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
    lib = _build.bind("sparse_mh", _SIGS, ("sparse_mh_threads", _THREADS))
    _build.launch(lib, "sparse_mh", LAUNCHES, z.data_ptr(), docs.data_ptr(),
                  mask.data_ptr(), theta.data_ptr(), phi.data_ptr(), ids.data_ptr(),
                  cnt.data_ptr(), tbl_a.data_ptr(), tbl_b.data_ptr() if alias else None,
                  out.data_ptr(), acc.data_ptr(), M, L, K, cap, steps, int(alias),
                  1 << ceil_log2(K), s0, s1, int(row0) & 0xFFFFFFFF, float(alpha))
    return out, acc[0], acc[1], acc[2]
