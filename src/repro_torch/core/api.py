"""One-shot sampling entry points, the counterpart of ``repro.core.api``:
thin wrappers that build a throwaway :class:`~repro_torch.sampling.Categorical`
through a :func:`~repro_torch.sampling.plan` and draw once.  Hold a
``Categorical`` (``plan(...).build(w)``) to draw many times.

Methods (``METHODS``): ``auto`` (the default: :mod:`repro_torch.autotune`
picks a strategy for the workload's (B, K, draws, dtype) on the device
its tensors live on), ``butterfly``, ``fenwick``, ``two_level``,
``kernel``, ``prefix``, ``gumbel``, ``alias``, ``alias_device``,
``radix_forest``.  Inputs that are not tensors go to ``device`` (default
``cuda``).

Repeated distributions: ``dist_key="..."`` (with ``draws=`` as the reuse
hint for ``auto``) memoizes the alias / Fenwick / radix-forest state in
autotune's table cache across calls, keyed by a content digest of the
weights, so changed weights (in place too) rebuild.
"""

from __future__ import annotations

from typing import Optional

import torch

METHODS = (
    "auto", "butterfly", "fenwick", "two_level", "kernel", "prefix",
    "gumbel", "alias", "alias_device", "radix_forest",
)
_KEYED = ("gumbel", "alias", "alias_device")
# the variants whose built state the table cache memoizes under dist_key
# (cost_model.CACHED_TABLE_METHODS: an amortized build must mean reuse)
_CACHED_KINDS = ("alias", "fenwick", "alias_device", "radix_forest")


def sample_categorical(weights, generator: Optional[torch.Generator] = None, u=None,
                       method: str = "auto", W: Optional[int] = None, draws: int = 1,
                       dist_key: Optional[str] = None, device=None) -> torch.Tensor:
    """One category index per row of ``weights`` ((B,) int32; a 1-D row
    gives a scalar).  ``u`` ((B,) uniforms) drives the u-driven methods;
    ``gumbel`` and the alias methods need ``generator``.

    ``method="auto"`` resolves through a memoized ``sampling.plan`` for
    the weights' device; with ``u`` given it resolves over the u-driven
    methods only, so the uniforms always drive the draw.  ``draws`` is
    the expected uses per distribution and counts only with ``dist_key``:
    without it nothing is reused between calls, so ``auto`` resolves at
    one draw."""
    from repro_torch import sampling
    from repro_torch.sampling.distribution import as_tensor

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    weights = as_tensor(weights, device)
    if weights.dim() == 1:
        uu = None if u is None else torch.as_tensor(u).reshape(1)
        return sample_categorical(weights[None], generator=generator, u=uu, method=method,
                                  W=W, draws=draws, dist_key=dist_key)[0]
    eff_draws = draws if dist_key is not None else 1
    p = sampling.plan(tuple(weights.shape), method=method, W=W, dtype=weights.dtype,
                      draws=eff_draws, has_key=generator is not None and u is None,
                      backend=weights.device.type)
    if p.method in _KEYED and generator is None:
        raise ValueError(f"{p.method} requires a generator")
    if u is None and generator is None:
        raise ValueError("need generator or u")
    if dist_key is not None and p.method in _CACHED_KINDS:
        from repro_torch import autotune

        dist = autotune.get_table_cache().get_or_build_dist(dist_key, p, weights)
    else:
        dist = p.build(weights)
    if p.method in _KEYED:
        return p.draw(dist, generator=generator)
    return p.draw(dist, generator=generator, u=u)


def sample_from_logits(logits, generator: Optional[torch.Generator] = None,
                       temperature=1.0, method: str = "auto", W: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Temperature sampling from (B, V) logits (greedy at temperature 0);
    float logits keep their dtype through the softmax.  ``method="auto"``
    resolves per (B, V) workload at one draw (decode logits change every
    step) on the logits' device."""
    from repro_torch import sampling
    from repro_torch.sampling.distribution import as_tensor

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    logits = as_tensor(logits, device)
    if not logits.is_floating_point():
        logits = logits.to(torch.float32)
    if logits.dim() == 1:
        return sample_from_logits(logits[None], generator, temperature=temperature,
                                  method=method, W=W)[0]
    if isinstance(temperature, (int, float)) and temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    p = sampling.plan(tuple(logits.shape), method=method, W=W, dtype=logits.dtype,
                      draws=1, has_key=True, backend=logits.device.type)
    return p.sample_logits(logits, generator, temperature=temperature)
