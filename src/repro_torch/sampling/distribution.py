"""Built draw state per strategy, and the u-driven draw from it.

The reference keeps each strategy's precomputed table in a ``Categorical``
pytree.  This slice of the port carries only the state builders and the
u-driven draws for ``prefix``, ``fenwick``, ``butterfly``, ``two_level``
and the factored ``lda_kernel``; ``Categorical`` and ``plan`` come with
the sampling-API slice (ROADMAP queue 1, slice 8).

State per variant (a dict of tensors):

  ==========  =====================================================
  prefix      ``prefix``  (B, K) inclusive prefix sums
  fenwick     ``table``   (B, Kp) per-sample segment table
  butterfly   ``table``   (G, nb, W, W) paper-faithful butterfly table
  two_level   ``blocks``  (B, nb, W), ``running`` (B, nb)
  lda_kernel  ``theta`` (C, K) / ``phi`` (V, K) factors,
              ``doc_ids`` / ``words`` (B,) row selectors,
              ``running`` (B, nb) factored pass-A running block sums
  ==========  =====================================================
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import butterfly as _bfly

VARIANTS = ("prefix", "fenwick", "butterfly", "two_level", "lda_kernel")
FACTORED_VARIANTS = ("lda_kernel",)


def _float_like(weights: torch.Tensor) -> torch.Tensor:
    if weights.dtype not in (torch.float32, torch.float64):
        return weights.to(torch.float32)
    return weights


def _build_state(method: str, weights: torch.Tensor, W: int) -> Dict[str, Any]:
    """The draw state of ``method`` for (B, K) ``weights``."""
    if method == "prefix":
        return {"prefix": torch.cumsum(_float_like(weights), dim=-1)}
    if method == "fenwick":
        wp, _, _ = _bfly._prep(weights, W, group_pad=False)
        return {"table": _bfly.build_fenwick_table(wp, W)}
    if method == "butterfly":
        wp, _, _ = _bfly._prep(weights, W, group_pad=True)
        return {"table": _bfly.build_butterfly_table(wp, W)}
    if method == "two_level":
        blocks, running = _bfly.two_level_state(weights, W)
        return {"blocks": blocks, "running": running}
    if method == "lda_kernel":
        raise ValueError(
            "the factored 'lda_kernel' variant builds from (theta, phi, "
            "doc_ids, words) — use _build_state_factored"
        )
    raise ValueError(f"unknown variant {method!r}; options: {VARIANTS}")


def _build_state_factored(theta, phi, doc_ids, words, W: int) -> Dict[str, Any]:
    """The ``lda_kernel`` state: factored pass A (K6 on CUDA) straight
    from the factors — no (B, K) weight tensor."""
    from repro_torch.kernels.lda_draw import ops as _lops

    theta, phi, running = _lops.lda_build_running(theta, phi, doc_ids, words, W=W)
    return {"theta": theta, "phi": phi, "doc_ids": doc_ids, "words": words,
            "running": running}


def _draw_with_u(method: str, state: Dict[str, Any], u: torch.Tensor,
                 shape, W: int) -> torch.Tensor:
    """One draw per row from (B,) uniforms; ``shape`` is the unpadded
    (B, K).  ``lda_kernel`` also takes (S, B) uniforms for S draws."""
    B, K = shape
    if method == "prefix":
        p = state["prefix"]
        stop = p[:, -1] * u.to(p.dtype)
        idx = torch.searchsorted(p, stop[:, None], right=True)[:, 0]
        return idx.clamp(max=K - 1).to(torch.int32)
    if method == "fenwick":
        return _bfly.draw_fenwick_from_table(state["table"], u, W=W, K=K)
    if method == "butterfly":
        return _bfly.draw_butterfly_from_table(state["table"], u, W=W, B=B, K=K)
    if method == "two_level":
        return _bfly.draw_two_level_from_state(
            state["blocks"], state["running"], u, W, K
        )
    if method == "lda_kernel":
        from repro_torch.kernels.lda_draw import ops as _lops

        return _lops.lda_draw_from_running(
            state["theta"], state["phi"], state["running"], u,
            state["doc_ids"], state["words"], K=K, W=W,
        )
    raise ValueError(f"unknown u-driven variant {method!r}; options: {VARIANTS}")
