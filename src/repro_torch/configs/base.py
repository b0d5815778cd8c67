"""Run configuration schema (this slice: the sampler preferences only;
``ModelConfig`` and the serving specs come with ROADMAP slice 12)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Decode-time sampler preferences, resolved once per workload shape
    by ``repro_torch.sampling.plan``.

    ``method``: auto | two_level | fenwick | butterfly | kernel | prefix |
    gumbel | alias | alias_device | radix_forest (``auto``: the autotune
    tuner's pick).  ``W = 0`` means the tuned W under ``auto``, else
    ``runtime.default_w(K)``.  ``draws`` is the
    expected uses per distribution (1 for decode).  ``top_k`` / ``top_p``
    / ``min_p`` are the model's default truncation, disabled at
    0 / 1.0 / 0."""

    method: str = "auto"
    W: int = 0
    draws: int = 1
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0

    @property
    def truncates(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0
