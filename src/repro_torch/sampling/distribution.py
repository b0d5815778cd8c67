"""Built draw state per strategy, and the u-driven draw from it.

The reference keeps each strategy's precomputed table in a ``Categorical``
pytree.  The port carries so far only the state builders and the
u-driven draws for ``prefix``, ``fenwick``, ``butterfly``, ``two_level``,
``kernel`` and the factored ``lda_kernel``; ``Categorical`` and ``plan``
come with the sampling-API slice (ROADMAP queue 1, slice 8).

State per variant (a dict of tensors):

  ==========  =====================================================
  prefix      ``prefix``  (B, K) inclusive prefix sums
  fenwick     ``table``   (B, Kp) per-sample segment table
  butterfly   ``table``   (G, nb, W, W) paper-faithful butterfly table
  two_level   ``blocks``  (B, nb, W), ``running`` (B, nb)
  kernel      ``weights`` (B, K) weights, ``running`` (B, nb) running
              block sums (pass A, K2 on CUDA)
  lda_kernel  ``theta`` (C, K) / ``phi`` (V, K) factors,
              ``doc_ids`` / ``words`` (B,) row selectors,
              ``running`` (B, nb) factored pass-A running block sums
  ==========  =====================================================

Kernels.  The ``butterfly`` table is built by the Hopper kernel K1
(``kernels/butterfly_table``) for CUDA tensors, written straight in the
(G, nb, W, W) layout the search reads; ``runtime.resolve_impl`` picks it,
and on CPU tensors the plain ``core.butterfly.build_butterfly_table``
gives the same table.  The JAX package builds this table with XLA ops and
keeps K1 as a separate entry point; the port uses the kernel for the same
table.  The ``kernel`` variant builds with pass A (K2) and draws with
pass B (K3), as the reference does through its Pallas kernels.

The reference's ``kernel`` state pads the weights' columns to its column
tile; :func:`kernel_state_from_numpy` and :func:`kernel_state_to_numpy`
carry that state between the two packages as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import butterfly as _bfly
from repro_torch.kernels import runtime
from repro_torch.kernels.butterfly_sample import ops as _kops
from repro_torch.kernels.butterfly_table import ops as _tops

VARIANTS = ("prefix", "fenwick", "butterfly", "two_level", "kernel", "lda_kernel")
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
        return {"table": _tops.butterfly_table(wp, W, layout="blocks")}
    if method == "two_level":
        blocks, running = _bfly.two_level_state(weights, W)
        return {"blocks": blocks, "running": running}
    if method == "kernel":
        wp, running = _kops.build_block_sums(weights, W=W)
        return {"weights": wp, "running": running}
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


def kernel_state_from_numpy(wp, running, device=None) -> Dict[str, torch.Tensor]:
    """The port's ``kernel`` state from the reference's ``(weights,
    running)`` leaves as numpy arrays.  Padded rows and columns are kept:
    the draws read only the rows they are given, and padded columns are
    zero, so they are never drawn."""
    dev = runtime.resolve_device(device)
    return {"weights": torch.as_tensor(np.array(wp, np.float32), device=dev),
            "running": torch.as_tensor(np.array(running, np.float32), device=dev)}


def kernel_state_to_numpy(state: Dict[str, torch.Tensor], W: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(weights, running) as numpy, the weights' columns padded with zeros
    to nb * W (the reference's pass B reads whole W-blocks)."""
    w = state["weights"].float().cpu()
    running = state["running"].cpu()
    pad = running.shape[1] * W - w.shape[1]
    return torch.nn.functional.pad(w, (0, pad)).numpy(), running.numpy()


def _draw_with_u(method: str, state: Dict[str, Any], u: torch.Tensor,
                 shape, W: int) -> torch.Tensor:
    """One draw per row from (B,) uniforms; ``shape`` is the unpadded
    (B, K).  ``kernel`` and ``lda_kernel`` also take (S, B) uniforms for
    S draws."""
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
    if method == "kernel":
        return _kops.butterfly_sample_from_sums(
            state["weights"], state["running"], u, K=K, W=W
        )
    if method == "lda_kernel":
        from repro_torch.kernels.lda_draw import ops as _lops

        return _lops.lda_draw_from_running(
            state["theta"], state["phi"], state["running"], u,
            state["doc_ids"], state["words"], K=K, W=W,
        )
    raise ValueError(f"unknown u-driven variant {method!r}; options: {VARIANTS}")
