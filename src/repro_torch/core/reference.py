"""Algorithm 1/3 oracle: full prefix sums + binary search (searchsorted).

The baseline the paper optimizes from, and the correctness oracle every
other draw is held against.
"""

from __future__ import annotations

import numpy as np
import torch


def _float_like(weights) -> torch.Tensor:
    weights = torch.as_tensor(weights)
    if weights.dtype not in (torch.float32, torch.float64):
        weights = weights.to(torch.float32)
    return weights


def prefix_sums(weights: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis (Alg. 1 lines 11-15)."""
    return torch.cumsum(weights, dim=-1)


def draw_prefix(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-row indices: the smallest j with ``stop < P[j]``, stop = u*P[-1].

    ``weights``: (B, K) non-negative, ``u``: (B,) in [0,1).
    """
    weights = _float_like(weights)
    p = prefix_sums(weights)
    stop = p[:, -1] * u.to(p.dtype)
    idx = torch.searchsorted(p, stop[:, None], right=True)[:, 0]
    return idx.clamp(max=weights.shape[-1] - 1).to(torch.int32)


def draw_linear_np(weights: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Pure-numpy scalar-loop linear search (Alg. 2) — oracle of the oracle."""
    weights = np.asarray(weights, dtype=np.float64)
    out = np.zeros(weights.shape[0], dtype=np.int32)
    for b in range(weights.shape[0]):
        p = np.cumsum(weights[b])
        stop = p[-1] * u[b]
        j = 0
        while j < len(p) - 1 and stop >= p[j]:
            j += 1
        out[b] = j
    return out
