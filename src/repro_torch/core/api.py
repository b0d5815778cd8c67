"""One-shot sampling entry points, the counterpart of ``repro.core.api``:
thin wrappers that build a throwaway :class:`~repro_torch.sampling.Categorical`
through a :func:`~repro_torch.sampling.plan` and draw once.  Hold a
``Categorical`` (``plan(...).build(w)``) to draw many times.

Methods (``METHODS``): ``butterfly``, ``fenwick``, ``two_level``,
``kernel``, ``prefix``, ``gumbel``, ``alias``, ``alias_device``,
``radix_forest``.  ``method="auto"`` and ``dist_key=`` (the table cache of
autotune) come with ROADMAP slice 9 and raise until then.  Inputs that are
not tensors go to ``device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Optional

import torch

METHODS = (
    "auto", "butterfly", "fenwick", "two_level", "kernel", "prefix",
    "gumbel", "alias", "alias_device", "radix_forest",
)
_KEYED = ("gumbel", "alias", "alias_device")
_SLICE9 = "ROADMAP queue 1, slice 9 (candidates and autotune)"


def sample_categorical(weights, generator: Optional[torch.Generator] = None, u=None,
                       method: str = "auto", W: Optional[int] = None, draws: int = 1,
                       dist_key: Optional[str] = None, device=None) -> torch.Tensor:
    """One category index per row of ``weights`` ((B,) int32; a 1-D row
    gives a scalar).  ``u`` ((B,) uniforms) drives the u-driven methods;
    ``gumbel`` and the alias methods need ``generator``."""
    from repro_torch import sampling
    from repro_torch.sampling.distribution import as_tensor

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    if method == "auto":
        raise NotImplementedError(f"method='auto' is not ported yet: {_SLICE9}")
    if dist_key is not None:
        raise NotImplementedError(f"dist_key= (the table cache) is not ported yet: {_SLICE9}")
    weights = as_tensor(weights, device)
    if weights.dim() == 1:
        uu = None if u is None else torch.as_tensor(u).reshape(1)
        return sample_categorical(weights[None], generator=generator, u=uu, method=method,
                                  W=W, draws=draws)[0]
    if method in _KEYED and generator is None:
        raise ValueError(f"{method} requires a generator")
    if u is None and generator is None:
        raise ValueError("need generator or u")
    p = sampling.plan(tuple(weights.shape), method=method, W=W, dtype=weights.dtype,
                      draws=1, has_key=generator is not None and u is None)
    dist = p.build(weights)
    if method in _KEYED:
        return p.draw(dist, generator=generator)
    return p.draw(dist, generator=generator, u=u)


def sample_from_logits(logits, generator: Optional[torch.Generator] = None,
                       temperature=1.0, method: str = "auto", W: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Temperature sampling from (B, V) logits (greedy at temperature 0);
    float logits keep their dtype through the softmax."""
    from repro_torch import sampling
    from repro_torch.sampling.distribution import as_tensor

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    if method == "auto":
        raise NotImplementedError(f"method='auto' is not ported yet: {_SLICE9}")
    logits = as_tensor(logits, device)
    if not logits.is_floating_point():
        logits = logits.to(torch.float32)
    if logits.dim() == 1:
        return sample_from_logits(logits[None], generator, temperature=temperature,
                                  method=method, W=W)[0]
    if isinstance(temperature, (int, float)) and temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    p = sampling.plan(tuple(logits.shape), method=method, W=W, dtype=logits.dtype,
                      draws=1, has_key=True)
    return p.sample_logits(logits, generator, temperature=temperature)
