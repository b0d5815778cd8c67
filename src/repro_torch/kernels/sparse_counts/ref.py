"""Plain PyTorch version of the sparse sweep's counts and lists, and an
exact-order model of the kernel's ranking.

:func:`sparse_counts_torch` is what the sparse sweep computes where the
kernel does not run: ``lda.gibbs._counts`` (float ``index_add_`` over
every position, masked ones add 0.0), ``lda.sparse.sparse_counts`` (the
first ``width`` columns of a stable descending sort of each document's
counts) and ``lda.sparse._support_max`` (the largest number of nonzero
topics in a document).  It is the plain version the kernel is held to.

:func:`sparse_counts_rank_order_torch` follows ``csrc/sparse_counts.cu``
step by step for each document: the histogram of its live tokens, the
nonzero topics compacted in id order by segments of ``ceil(K / threads)``
topics and an exclusive scan of the segments' counts, a zero topic
written to slot ``nnz + k - p`` (``p`` the nonzero topics below it), and
each nonzero topic ranked by ``#{greater count} + #{equal count, lower
id}``.  It gives what :func:`sparse_counts_torch` gives in every slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.sparse_counts.kernel import THREADS


def sparse_counts_torch(z, docs, mask, K: int, V: int, width: int, *, word: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """``(doc_topic, word_topic, ids, cnt, nnz_max)`` as the kernel gives
    them: (M, K) and (V, K) float32 counts (word_topic None with
    ``word=False``), (M, width) int32 lists, nnz_max a 0-d int32."""
    # imported here: lda.sparse imports this package
    from repro_torch.lda import gibbs, sparse

    doc_topic, word_topic = gibbs._counts(z, docs, mask, K, V)
    lists = sparse.sparse_counts(doc_topic, width)
    return (doc_topic, word_topic if word else None, lists.ids, lists.cnt,
            sparse._support_max(doc_topic).to(torch.int32))


def _segment_starts(flag, threads: int):
    """The nonzero topics below each thread's first topic: the segments'
    counts (``seg = ceil(K / threads)`` topics a thread) and their
    exclusive scan, as the kernel's block scan forms it; and ``seg``."""
    K = len(flag)
    seg = -(-K // threads)
    starts, run = [], 0
    for t in range(threads):
        starts.append(run)
        run += sum(flag[min(t * seg, K):min(t * seg + seg, K)])
    return starts, seg


def sparse_counts_rank_order_torch(z, docs, mask, K: int, V: int, width: int,
                                   threads: int = THREADS):
    """The kernel's outputs, computed in its order (module note)."""
    M, L = z.shape
    z, docs, mask = z.cpu(), docs.cpu(), mask.cpu()
    doc_topic = torch.empty((M, K), dtype=torch.float32)
    word_topic = torch.zeros((V, K), dtype=torch.float32)
    ids = torch.full((M, width), -1, dtype=torch.int32)
    cnt = torch.full((M, width), -1, dtype=torch.int32)
    nnz_max = 0
    for d in range(M):
        live = mask[d].nonzero()[:, 0]
        hist = torch.zeros(K, dtype=torch.int64)
        hist.index_add_(0, z[d, live].long(), torch.ones(len(live), dtype=torch.int64))
        word_topic.index_put_((docs[d, live].long(), z[d, live].long()),
                              torch.ones(len(live)), accumulate=True)
        doc_topic[d] = hist.to(torch.float32)
        h = hist.tolist()
        flag = [c > 0 for c in h]
        starts, seg = _segment_starts(flag, threads)
        nnz = sum(flag)
        nnz_max = max(nnz_max, nnz)
        nz_id, nz_cnt = [0] * nnz, [0] * nnz
        row_ids, row_cnt = ids[d].tolist(), cnt[d].tolist()
        for t in range(threads):
            p = starts[t]
            for k in range(min(t * seg, K), min(t * seg + seg, K)):
                if flag[k]:
                    nz_id[p], nz_cnt[p] = k, h[k]
                    p += 1
                elif nnz + k - p < width:
                    row_ids[nnz + k - p], row_cnt[nnz + k - p] = k, 0
        for j in range(nnz):
            c = nz_cnt[j]
            r = sum((ci > c) or (ci == c and i < j) for i, ci in enumerate(nz_cnt))
            if r < width:
                row_ids[r], row_cnt[r] = nz_id[j], c
        ids[d] = torch.tensor(row_ids, dtype=torch.int32)
        cnt[d] = torch.tensor(row_cnt, dtype=torch.int32)
    return doc_topic, word_topic, ids, cnt, torch.tensor(nnz_max, dtype=torch.int32)
