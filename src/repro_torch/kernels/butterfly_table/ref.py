"""Oracle for the butterfly table: the paper's closed form (entry (i, j)
of a W x W block holds ``u_v^w`` with ``m = i ^ (i+1), k = m >> 1,
u = (i & ~m) + (j & m), v = j & ~k, w = v + k``; row W-1 carries the
running per-sample prefix), in the reference's (B, K) layout."""

from __future__ import annotations

import torch

from repro_torch.core import butterfly as _bfly


def butterfly_table_ref(weights, W: int = 32) -> torch.Tensor:
    w = torch.as_tensor(weights).float()
    B, K = w.shape
    if B % W or K % W:
        raise ValueError(f"(B={B}, K={K}) must be multiples of W={W}")
    return _bfly.closed_form_table(w, W).transpose(1, 2).reshape(B, K)
