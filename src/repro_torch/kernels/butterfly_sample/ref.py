"""Oracles for the draw on given weights.

* ``butterfly_sample_ref`` — full prefix sums and a search (paper
  Alg. 1/3), as the reference's ``butterfly_sample/ref.py``: the port's
  ``core.reference.draw_prefix``.
* :func:`boundary_ties` — the given-weights form of
  ``lda_draw.ref.boundary_ties``: explains the mismatches between two
  draws on the same (B, K) weights against a float64 oracle.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.reference import draw_prefix as butterfly_sample_ref
from repro_torch.kernels.lda_draw import ref as _lref

__all__ = ["boundary_ties", "butterfly_sample_ref"]


def boundary_ties(a, b, weights, u) -> Dict[str, int]:
    """Mismatches between draws ``a`` and ``b`` ((B,) or (S, B), ``u`` of
    the same shape; draw s of row i uses row i of ``weights``) and how
    many are float64-checked boundary ties (see
    ``lda_draw.ref.boundary_ties``): the weights are the factor theta
    times an all-ones phi row."""
    w = torch.as_tensor(weights)
    B, K = w.shape
    rows = torch.arange(B)
    ones = torch.ones((1, K), dtype=w.dtype, device=w.device)
    return _lref.boundary_ties(a, b, w, ones, rows, torch.zeros_like(rows), u)
