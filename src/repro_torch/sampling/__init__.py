"""Distribution-object sampling API — the primary way to draw.

* :class:`Categorical` — a batch of distributions holding its built draw
  state (butterfly/Fenwick tables, block sums, alias arrays, prefix sums).
  Build it with ``Categorical.from_weights`` / ``from_logits`` /
  ``from_factors``, refresh it with ``dist.refreshed(new_weights)``.
* :class:`SamplerPlan` — from :func:`plan`, a resolved strategy with
  ``build`` / ``draw`` / ``sample`` / ``sample_logits``.
* :mod:`.transforms` — top-k / top-p / min-p / temperature chains.

On the card::

    from repro_torch import sampling
    p = sampling.plan((64, 256000), method="kernel", transforms="kp")
    tok = p.sample_logits(logits, generator,
                          transforms=(sampling.TopK(64), sampling.TopP(0.95)))

Over a ``torch.distributed`` ``DeviceMesh``, ``plan(..., mesh=mesh)``
routes every draw through :mod:`.sharded`: per-shard kernels and counter
uniforms seeded by ``key=``, no collective on the draw path::

    p = sampling.plan((64, 256000), method="kernel", mesh=mesh, transforms="kp")
    tok = p.sample_logits(logits, key=seed_pair,
                          transforms=(sampling.TopK(64), sampling.TopP(0.95)))
"""

from repro_torch.sampling.distribution import (
    FACTORED_VARIANTS,
    KEY_VARIANTS,
    U_VARIANTS,
    VARIANTS,
    Categorical,
    build_count,
    draw,
    logits_to_weights,
)
from repro_torch.sampling.plan import SamplerPlan, plan, plan_stats, reset_plans
from repro_torch.sampling import sharded
from repro_torch.sampling import transforms
from repro_torch.sampling.transforms import MinP, Temperature, TopK, TopP

__all__ = [
    "Categorical",
    "FACTORED_VARIANTS",
    "KEY_VARIANTS",
    "MinP",
    "SamplerPlan",
    "Temperature",
    "TopK",
    "TopP",
    "U_VARIANTS",
    "VARIANTS",
    "build_count",
    "draw",
    "logits_to_weights",
    "plan",
    "plan_stats",
    "reset_plans",
    "sharded",
    "transforms",
]
