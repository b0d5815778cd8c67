"""``SamplerPlan`` — a resolved sampling strategy for one (B, K) workload,
the counterpart of ``repro.sampling.plan``.

``plan(spec_or_shape, method=...)`` resolves the strategy once and returns
a frozen, hashable :class:`SamplerPlan` whose ``build`` / ``draw`` /
``sample`` / ``sample_logits`` route through :mod:`.distribution`.  Plans
are memoized per (shape, dtype, method, W, draws, has_key, backend,
factored, devices, transforms signature): re-planning a workload is a
dictionary hit (:func:`plan_stats`).  ``W=None`` resolves to
``runtime.default_w(K)`` and the tiles to ``runtime.default_tb`` /
``default_tk``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue-1 slice): ``method="auto"`` (slice 9, autotune) and ``mesh=`` /
``spec=`` (slice 11, multi-device draws).

The decode hot path::

    p = plan((64, 256000), method="kernel", transforms="kp")
    tok = p.sample_logits(logits, generator, transforms=(TopK(64), TopP(0.95)))

runs the truncated draw of ``kernels.butterfly_sample`` (K9, or K11 and
K12) — no sort, no (B, V) sorted copy.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.sampling import distribution as _dist
from repro_torch.sampling.distribution import Categorical

_PLAN_CACHE: Dict[Tuple, "SamplerPlan"] = {}
_PLAN_LOCK = threading.Lock()
_STATS = {"autotune_resolves": 0, "plan_hits": 0, "plan_misses": 0}

METHODS = _dist.VARIANTS + ("kernel_trunc",)
AUTO_SLICE = "ROADMAP queue 1, slice 9 (candidates and autotune)"
MESH_SLICE = "ROADMAP queue 1, slice 11 (multi-device draws)"


def plan_stats() -> dict:
    with _PLAN_LOCK:
        return dict(_STATS)


def reset_plans() -> None:
    """Drop memoized plans and zero the counters (test isolation)."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class SamplerPlan:
    """A resolved (method, W) strategy for one (B, K) workload."""

    method: str
    W: int
    shape: Tuple[int, int]
    dtype: str
    draws: int
    has_key: bool
    backend: str
    tb: int = 0
    tk: int = 0
    factored: bool = False
    devices: int = 1
    transforms: str = ""

    @property
    def table_method(self) -> str:
        """The buildable variant: ``kernel_trunc`` is the truncated *draw*
        strategy and carries plain ``kernel`` state when a table is built."""
        return "kernel" if self.method == "kernel_trunc" else self.method

    # -- building ----------------------------------------------------------

    def build(self, weights) -> Categorical:
        """The plan's :class:`Categorical` for (B, K) weights."""
        if self.method in _dist.FACTORED_VARIANTS:
            raise ValueError(
                f"plan resolved to factored variant {self.method!r}; build "
                "it with build_from_factors(theta, phi, words)"
            )
        weights = torch.as_tensor(weights)
        if tuple(weights.shape) != self.shape:
            raise ValueError(f"plan was made for shape {self.shape}, got "
                             f"{tuple(weights.shape)}")
        return Categorical._build(weights, self.table_method, self.W, self.tb)

    def build_from_logits(self, logits, temperature=1.0, transforms=None) -> Categorical:
        """The plan's distribution from logits; a ``transforms`` chain is
        baked into the table (masked weights)."""
        if transforms:
            from repro_torch.sampling import transforms as _tr

            return self.build(_tr.apply_to_logits(transforms, logits, temperature))
        return self.build(_dist.logits_to_weights(logits, temperature))

    def build_from_factors(self, theta, phi, words, doc_ids=None) -> Categorical:
        """Build from a (theta, phi, words) factorization: straight from
        the factors for ``lda_kernel``, else through the (B, K) product."""
        theta = torch.as_tensor(theta)
        words = torch.as_tensor(words, device=theta.device).to(torch.int32)
        if doc_ids is None:
            doc_ids = torch.arange(words.shape[0], dtype=torch.int32, device=theta.device)
        doc_ids = torch.as_tensor(doc_ids, device=theta.device).to(torch.int32)
        if self.method in _dist.FACTORED_VARIANTS:
            return Categorical._build_factored(theta, phi, doc_ids, words, self.method,
                                               self.W, self.tb)
        return self.build(theta[doc_ids.long()] * torch.as_tensor(phi)[words.long()])

    # -- drawing -----------------------------------------------------------

    def draw(self, dist: Categorical, generator: Optional[torch.Generator] = None,
             u=None, num_samples: int = 1) -> torch.Tensor:
        """Draw from a built distribution (see :func:`distribution.draw`)."""
        return _dist.draw(dist, generator=generator, u=u, num_samples=num_samples)

    def sample(self, weights, generator: Optional[torch.Generator] = None, u=None,
               num_samples: int = 1) -> torch.Tensor:
        """Build a throwaway distribution and draw from it."""
        if self.table_method in _dist.FACTORED_VARIANTS:
            raise ValueError(
                f"plan resolved to factored variant {self.method!r}; build "
                "it with build_from_factors(theta, phi, words) and draw from that"
            )
        return self.draw(self.build(weights), generator=generator, u=u,
                         num_samples=num_samples)

    def sample_logits(self, logits, generator: Optional[torch.Generator] = None,
                      temperature=1.0, num_samples: int = 1, transforms=None
                      ) -> torch.Tensor:
        """Temperature sampling from (B, V) logits (the serving hot path).

        ``temperature == 0`` is argmax.  A ``gumbel`` plan samples in logit
        space.  ``transforms`` is a truncation chain (per-row parameters
        allowed): a ``kernel`` / ``kernel_trunc`` plan runs the truncated
        draw (threshold by bisection, no sort); other variants mask by the
        threshold twin and build from the masked weights."""
        logits = torch.as_tensor(logits)
        if isinstance(temperature, (int, float)) and temperature == 0.0:
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            if num_samples == 1:
                return greedy
            return greedy.expand(num_samples, *greedy.shape)
        if transforms:
            return self._sample_logits_truncated(logits, generator, temperature,
                                                 num_samples, transforms)
        if self.method == "gumbel":
            return self._gumbel_logits(_scale(logits, temperature), generator,
                                       num_samples)
        weights = _dist.logits_to_weights(logits, temperature)
        return self.sample(weights, generator=generator, num_samples=num_samples)

    @staticmethod
    def _gumbel_logits(z, generator, num_samples: int) -> torch.Tensor:
        from repro_torch.core import gumbel as _gumbel

        if num_samples == 1:
            return _gumbel.draw_gumbel_logits(z, generator)
        return torch.stack([_gumbel.draw_gumbel_logits(z, generator)
                            for _ in range(num_samples)])

    def _sample_logits_truncated(self, logits, generator, temperature,
                                 num_samples: int, transforms) -> torch.Tensor:
        from repro_torch.sampling import transforms as _tr

        temp = _tr.temperature_of(transforms, temperature)
        trunc = _tr.truncations_of(transforms)
        if not trunc:
            return self.sample_logits(logits, generator, temperature=temp,
                                      num_samples=num_samples)
        B = logits.shape[0]
        kpm = _tr.canonical_params(transforms, B, device=logits.device)
        if self.method in ("kernel", "kernel_trunc") and kpm is not None:
            # the decode fast path: softmax straight into the truncated draw
            # (K9; S draws per row take tau, K11 and K12, where the
            # reference masks the weights and builds kernel state — the
            # same masked running sums and walks, so the same draws)
            from repro_torch.kernels.butterfly_sample import ops as _kops

            w = _dist.logits_to_weights(logits, temp)
            shape = (B,) if num_samples == 1 else (num_samples, B)
            u = torch.rand(shape, generator=generator, device=logits.device)
            return _kops.butterfly_sample_truncated(w, u, kpm, W=self.W)
        w = _dist.logits_to_weights(logits, temp)
        if self.method == "gumbel":
            # stay in logit space: truncated tokens to -inf, survivors'
            # relative logits untouched (the renormalized truncated draw)
            tau = _tr.thresholds(w, trunc)
            z = _scale(logits, temp)
            zm = torch.where(w.to(torch.float32) >= tau[:, None], z,
                             torch.full((), float("-inf"), dtype=z.dtype,
                                        device=z.device))
            return self._gumbel_logits(zm, generator, num_samples)
        return self.sample(_tr.apply(w, trunc), generator=generator,
                           num_samples=num_samples)


def _scale(logits: torch.Tensor, temperature) -> torch.Tensor:
    t = torch.as_tensor(temperature, device=logits.device)
    return logits / (t[:, None] if t.dim() == 1 else t)


def _normalize_shape(spec_or_shape, shape) -> Tuple[int, int]:
    if hasattr(spec_or_shape, "shape") and not isinstance(spec_or_shape, tuple):
        spec_or_shape = tuple(spec_or_shape.shape)
    if isinstance(spec_or_shape, (tuple, list)) and len(spec_or_shape) == 2:
        return (int(spec_or_shape[0]), int(spec_or_shape[1]))
    if shape is not None and len(shape) == 2:
        return (int(shape[0]), int(shape[1]))
    raise ValueError(
        "plan() needs a (B, K) workload shape: pass a 2-tuple, a tensor, "
        "or a SamplerSpec together with shape=(B, K)"
    )


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def plan(spec_or_shape, method: Optional[str] = None, *, shape=None,
         W: Optional[int] = None, dtype="float32", draws: int = 1,
         has_key: bool = True, backend: Optional[str] = None, factored: bool = False,
         mesh=None, spec=None, devices: Optional[int] = None, transforms="",
         ) -> SamplerPlan:
    """Resolve a sampling strategy for a (B, K) workload, once.

    ``spec_or_shape`` is a (B, K) tuple, a tensor (shape and dtype taken
    from it), or a ``configs.base.SamplerSpec`` (method, W and draws taken
    from it; the workload via ``shape=``).  ``W`` falsy picks
    ``runtime.default_w(K)``.  ``transforms`` (a chain or its signature,
    e.g. ``"kp"``) joins the memo key; parameter values stay out of it."""
    if mesh is not None or spec is not None:
        raise NotImplementedError(f"plan(mesh=/spec=) is not ported yet: {MESH_SLICE}")
    if hasattr(spec_or_shape, "method") and hasattr(spec_or_shape, "W"):
        sspec = spec_or_shape
        method = method if method not in (None, "auto") else sspec.method
        W = W or (sspec.W or None)
        draws = max(draws, getattr(sspec, "draws", 1))
        spec_or_shape = None
    if hasattr(spec_or_shape, "dtype") and hasattr(spec_or_shape, "shape"):
        dtype = spec_or_shape.dtype
    method = method or "auto"
    if method == "auto":
        raise NotImplementedError(f"method='auto' is not ported yet: {AUTO_SLICE}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")
    B, K = _normalize_shape(spec_or_shape, shape)
    dtype_name = _dtype_name(dtype)
    if transforms and not isinstance(transforms, str):
        from repro_torch.sampling import transforms as _tr

        transforms = _tr.signature(transforms)
    transforms = transforms or ""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    devices = int(devices or 1)
    key = (B, K, dtype_name, method, W or 0, int(draws), bool(has_key), backend,
           bool(factored), devices, transforms)
    with _PLAN_LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            _STATS["plan_hits"] += 1
            return hit
        _STATS["plan_misses"] += 1
    Wr = int(W or runtime.default_w(K))
    p = SamplerPlan(method=method, W=Wr, shape=(B, K), dtype=dtype_name,
                    draws=int(draws), has_key=bool(has_key), backend=backend,
                    tb=runtime.default_tb(B), tk=runtime.default_tk(K, Wr),
                    factored=bool(factored), devices=devices, transforms=transforms)
    with _PLAN_LOCK:
        _PLAN_CACHE.setdefault(key, p)
        return _PLAN_CACHE[key]
