"""Int8 compression: per-tensor quantization for checkpoints and optimizer
state, and the error-feedback compressed-allreduce simulation, the
counterpart of ``repro.dist.compression`` (bit-equal to it).

``quantize_int8`` is the per-tensor (one absmax scale) spelling used for
checkpoint compression; the 8-bit AdamW's blockwise quantizer lives in
``repro_torch.train.optimizer``.  Round-to-nearest against an absmax/127
scale bounds the elementwise reconstruction error at ``scale / 2``.

The scale divides a tensor by a tensor: PyTorch divides by a host scalar
through its reciprocal on the card, which rounds twice, where the
reference divides once.  ``torch.round`` rounds half to even, as
``jnp.round`` does.

``simulate_compressed_allreduce`` models the error-feedback scheme
(1-bit Adam / EF-SGD lineage): each worker quantizes ``grad + residual``,
ships int8, and keeps the quantization error as the next round's
residual, so the *accumulated* mean is unbiased though every single round
is lossy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _f32(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=x.device)


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 quantization: returns ``(q, scale)`` with
    ``q = round(x / scale)`` in [-127, 127] and ``scale = absmax / 127``
    (a 0-d float32 tensor)."""
    xf = torch.as_tensor(x).to(torch.float32)
    scale = torch.max(torch.abs(xf)) / _f32(xf, 127.0)
    scale = torch.maximum(scale, _f32(xf, 1e-20))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (error <= scale / 2 elementwise)."""
    q = torch.as_tensor(q)
    return q.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32, device=q.device)


def init_error_feedback(grads):
    """Zero residual tree matching ``grads``, one per worker."""
    return _tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def simulate_compressed_allreduce(grads: Sequence, residuals: Sequence) -> Tuple[object, List]:
    """One round of int8 compressed allreduce with error feedback.

    ``grads`` / ``residuals`` are per-worker trees (or bare tensors).  Each
    worker compresses ``g + residual``; the reduction averages the
    *dequantized* payloads; the quantization error stays local as the new
    residual.  Returns ``(mean_estimate, new_residuals)``."""
    n = len(grads)
    payloads, new_residuals = [], []
    for g, r in zip(grads, residuals):
        def one(gl, rl):
            c = gl.to(torch.float32) + rl
            q, s = quantize_int8(c)
            d = dequantize_int8(q, s)
            return d, c - d

        pairs = _tree_map(one, g, r)
        payloads.append(_tree_map(lambda pr: pr[0], pairs) if isinstance(pairs, dict)
                        else pairs[0])
        new_residuals.append(_tree_map(lambda pr: pr[1], pairs) if isinstance(pairs, dict)
                             else pairs[1])

    def mean(*xs):
        return sum(xs) / _f32(xs[0], float(n))

    return _tree_map(mean, *payloads), new_residuals
