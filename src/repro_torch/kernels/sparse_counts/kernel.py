"""The sparse sweep's counts and lists: the wrapper of the Hopper kernel S2.

``sparse_counts`` launches ``csrc/sparse_counts.cu``: one block a
document builds its topic histogram in shared memory with integer
atomics, writes its doc-topic row, adds its live tokens into the
word-topic counts, and ranks its nonzero topics into the list that a
stable descending sort of the row gives, ``width`` slots wide; the
largest number of nonzero topics of any document goes to one int32 by
``atomicMax``.  It replaces no TPU kernel (the reference's counts and
``lax.top_k`` are plain XLA); it replaces the port's two float
``index_add_`` calls and its sort of the whole (M, K) counts.  Its plain
version is ``ref.sparse_counts_torch``, which it equals bit for bit;
``ref.sparse_counts_rank_order_torch`` models its ranking.

A document's histogram and its nonzero topics sit in shared memory, K +
2 min(L, K) ints (:func:`smem_bytes`); :func:`fits` says whether they fit
a block's opt-in shared memory, as the card reports it
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``), or the H100's where no card
is named.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the outputs with ``torch`` (the word-topic counts
and the maximum zeroed), launches on the current stream without
synchronising, raises if the launch failed, and adds one to
``LAUNCHES["sparse_counts"]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"sparse_counts": 0}
THREADS = 128   # threads a block (kThreads)
# a block's shared memory with opting in on an H100 (227 KB), and the
# static part (the warps' totals)
_SMEM_OPTIN = 232448
_STATIC_SMEM = 4 * (THREADS // 32)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"sparse_counts": [_P] * 8 + [_I] * 4 + [_P], "sparse_counts_smem_optin": [_I]}


def reset_launches() -> None:
    LAUNCHES["sparse_counts"] = 0


def smem_bytes(K: int, L: int) -> int:
    """Dynamic shared memory of a block: the histogram and the compacted
    nonzero topics' ids and counts."""
    return 4 * (K + 2 * min(L, K))


def _lib() -> ctypes.CDLL:
    return _build.bind("sparse_counts", _SIGS, ("sparse_counts_threads", THREADS))


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """A block's shared memory with opting in on card ``index``, as the
    card reports it."""
    n = _lib().sparse_counts_smem_optin(index)
    if n <= 0:
        raise RuntimeError(f"card {index}: no opt-in shared memory size (CUDA error {-n})")
    return n


def fits(K: int, L: int, device: Optional[torch.device] = None) -> bool:
    """Whether a document of L positions over K topics fits a block of
    ``device`` (a CUDA device; an H100 where None)."""
    limit = _SMEM_OPTIN
    if device is not None and torch.device(device).type == "cuda":
        index = torch.device(device).index
        limit = smem_optin(torch.cuda.current_device() if index is None else index)
    return smem_bytes(K, L) + _STATIC_SMEM <= limit


def _check(name: str, t: torch.Tensor, dtype, shape, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def sparse_counts(z, docs, mask, K: int, V: int, width: int, *, word: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """The kernel: ``(doc_topic, word_topic, ids, cnt, nnz_max)``.

    z, docs (M, L) int32 and mask (M, L) bool on the card; doc_topic (M, K)
    and word_topic (V, K) float32 (None with ``word=False``), ids and cnt
    (M, width) int32 with ``1 <= width <= K``, nnz_max a 0-d int32."""
    if not z.is_cuda:
        raise ValueError(f"z must be a CUDA tensor, got {z.device}")
    if z.dim() != 2:
        raise ValueError(f"z must be 2-D, got shape {tuple(z.shape)}")
    M, L = z.shape
    if not 1 <= width <= K:
        raise ValueError(f"width must be in [1, K={K}], got {width}")
    if not fits(K, L, z.device):
        raise ValueError(f"a document of L={L} over K={K} topics takes "
                         f"{smem_bytes(K, L)} bytes of shared memory, over a block's")
    for name, t, dtype in (("z", z, torch.int32), ("docs", docs, torch.int32),
                           ("mask", mask, torch.bool)):
        _check(name, t, dtype, (M, L), z)
    dev = z.device
    doc_topic = torch.empty((M, K), dtype=torch.float32, device=dev)
    word_topic = torch.zeros((V, K), dtype=torch.float32, device=dev) if word else None
    ids = torch.empty((M, width), dtype=torch.int32, device=dev)
    cnt = torch.empty((M, width), dtype=torch.int32, device=dev)
    nnz_max = torch.zeros((), dtype=torch.int32, device=dev)
    _build.launch(_lib(), "sparse_counts", LAUNCHES, z.data_ptr(), docs.data_ptr(),
                  mask.data_ptr(), doc_topic.data_ptr(),
                  word_topic.data_ptr() if word else None, ids.data_ptr(),
                  cnt.data_ptr(), nnz_max.data_ptr(), M, L, K, width)
    return doc_topic, word_topic, ids, cnt, nnz_max
