"""Sorted oracle for truncated decode sampling (the counterpart of
``repro.sampling.reference``).

The classic top-k / top-p / min-p: sort each row descending (the (B, K)
sorted copy the threshold path avoids), scan its cumulative sums, mask
past the boundary.  Kept naive on purpose: the tests hold the threshold
path against it, and ``chip_smoke.py`` times it as the sort-based
yardstick.  Boundary semantics match :mod:`.transforms`: every stage is a
value threshold (ties at the boundary are kept), stages compose
sequentially.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.sampling import transforms as _tr


def sorted_mask(weights, transforms: Sequence) -> torch.Tensor:
    """(B, K) keep-mask via descending sort + cumsum."""
    _tr.validate(transforms)
    wf = torch.as_tensor(weights).to(torch.float32)
    B, K = wf.shape
    zero = torch.zeros((), dtype=wf.dtype, device=wf.device)
    keep = wf > 0.0
    for t in _tr.truncations_of(transforms):
        wm = torch.where(keep, wf, zero)
        ws = torch.sort(wm, dim=-1, descending=True).values
        if isinstance(t, _tr.TopK):
            k = _tr._row(t.k, B, wf.device)
            j = (k.to(torch.int32) - 1).clamp(0, K - 1).long()
            kth = torch.gather(ws, 1, j[:, None])[:, 0]
            keep &= torch.where(k[:, None] > 0, wf >= kth[:, None], True)
        elif isinstance(t, _tr.TopP):
            p = _tr._row(t.p, B, wf.device)
            cum = torch.cumsum(ws, dim=-1)
            target = p * cum[:, -1]
            # the first sorted position whose cumsum reaches the target
            j = torch.argmax((cum >= target[:, None]).to(torch.int8), dim=-1)
            bound = torch.gather(ws, 1, j[:, None])[:, 0]
            keep &= torch.where(p[:, None] < 1.0, wf >= bound[:, None], True)
        elif isinstance(t, _tr.MinP):
            p = _tr._row(t.p, B, wf.device)
            keep &= torch.where(p[:, None] > 0.0, wf >= (p * ws[:, 0])[:, None], True)
    return keep


def truncate_sorted(weights, transforms: Sequence) -> torch.Tensor:
    """Masked weights via the sorting oracle."""
    weights = torch.as_tensor(weights)
    return torch.where(sorted_mask(weights, transforms), weights,
                       torch.zeros_like(weights))


def truncated_probs(weights, transforms: Sequence) -> torch.Tensor:
    """Renormalized per-row probabilities after oracle truncation."""
    wm = truncate_sorted(weights, transforms).to(torch.float32)
    return wm / wm.sum(dim=-1, keepdim=True)


def draw_truncated_sorted(weights, u, transforms: Sequence) -> torch.Tensor:
    """Sort-then-sample: oracle truncation, then the Alg. 1 prefix-sum
    draw (sort, cumsum, mask, searchsorted: several PyTorch calls)."""
    weights = torch.as_tensor(weights)
    wm = truncate_sorted(weights, transforms).to(torch.float32)
    p = torch.cumsum(wm, dim=-1)
    stop = p[:, -1] * torch.as_tensor(u, device=p.device).to(p.dtype)
    idx = torch.searchsorted(p, stop[:, None], right=True)[:, 0]
    return idx.clamp(max=weights.shape[-1] - 1).to(torch.int32)
