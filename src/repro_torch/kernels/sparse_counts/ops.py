"""Public entry point of the sparse sweep's counts and lists.

:func:`sparse_counts` resolves ``impl`` through
:func:`repro_torch.kernels.runtime.resolve_impl`: the Hopper kernel for
CUDA tensors, the plain PyTorch version ``ref.sparse_counts_torch`` for
CPU tensors, ``impl="torch"`` for the plain version anywhere.  Both give
the same counts, lists and maximum bit for bit.  Inputs may come in any
integer dtype and the mask as bool or numbers; they are made contiguous
int32 / bool here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.sparse_counts.kernel import fits
from repro_torch.kernels.sparse_counts.kernel import sparse_counts as _sparse_counts_cuda
from repro_torch.kernels.sparse_counts.ref import sparse_counts_torch

__all__ = ["fits", "sparse_counts"]


def sparse_counts(z, docs, mask, K: int, V: int, width: int, *, word: bool = True,
                  impl: Optional[str] = None):
    """``(doc_topic, word_topic, ids, cnt, nnz_max)`` of topics ``z`` over
    (M, L) documents: (M, K) and (V, K) float32 counts of the live tokens
    (word_topic None with ``word=False``), each document's ``width``
    largest (topic, count) in the order of a stable descending sort (lower
    topic first among equal counts, then the zero-count topics by id), as
    (M, width) int32, and the largest number of nonzero topics in a
    document as a 0-d int32 on the inputs' device."""
    impl = runtime.resolve_impl(impl, z)
    dev = z.device
    live = torch.as_tensor(mask, device=dev)
    if live.dtype != torch.bool:
        live = live > 0
    if impl == "torch":
        return sparse_counts_torch(z, docs, live, K, V, width, word=word)

    def ints(x):
        return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()

    return _sparse_counts_cuda(ints(z), ints(docs), live.contiguous(), K, V, width,
                               word=word)
