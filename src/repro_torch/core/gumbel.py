"""Gumbel-max baseline: ``argmax(log w + G)`` with G ~ Gumbel(0, 1), the
counterpart of ``repro.core.gumbel``.  K random numbers per draw, one
reduction pass; the noise comes from a ``torch.Generator`` (the
reference's ``jax.random`` key), so draws match the reference in
distribution only."""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_noise(shape, generator: Optional[torch.Generator], device,
                 dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise: -log(E) with E ~ Exp(1)."""
    e = torch.empty(shape, dtype=dtype, device=device).exponential_(generator=generator)
    return -torch.log(e)


def log_weights(weights) -> torch.Tensor:
    """log w, with -inf for zero weights (never drawn)."""
    w = torch.as_tensor(weights)
    if w.dtype not in (torch.float32, torch.float64):
        w = w.to(torch.float32)
    logw = torch.log(torch.clamp(w, min=torch.finfo(w.dtype).tiny))
    return torch.where(w > 0, logw, torch.full((), float("-inf"), dtype=w.dtype,
                                               device=w.device))


def draw_gumbel(weights, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One index per row of (B, K) weights: (B,) int32."""
    logw = log_weights(weights)
    g = gumbel_noise(logw.shape, generator, logw.device, logw.dtype)
    return torch.argmax(logw + g, dim=-1).to(torch.int32)


def draw_gumbel_logits(logits, generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The same from logits (the serving path)."""
    z = torch.as_tensor(logits).to(torch.float32)
    g = gumbel_noise(z.shape, generator, z.device)
    return torch.argmax(z + g, dim=-1).to(torch.int32)
