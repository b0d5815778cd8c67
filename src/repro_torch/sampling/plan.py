"""``SamplerPlan`` — a resolved sampling strategy for one (B, K) workload,
the counterpart of ``repro.sampling.plan``.

``plan(spec_or_shape, method="auto", ...)`` resolves the strategy once
(``method="auto"``, the default: :mod:`repro_torch.autotune`, tuning cache
first, cost model on a miss) and returns a frozen, hashable
:class:`SamplerPlan` whose ``build`` / ``draw`` / ``sample`` /
``sample_logits`` route through :mod:`.distribution`.  Plans are memoized
per (shape, dtype, method, W, draws, has_key, backend, factored, devices,
mesh signature, transforms signature): re-planning a workload is a
dictionary hit, and the ``autotune_resolves`` counter of
:func:`plan_stats` stays at one per distinct workload.  ``W=None``
resolves to the tuned W under ``auto``, else ``runtime.default_w(K)``.

The backend is the device type of the workload: a tensor's own, or the
caller's ``backend=``; a bare shape takes ``cuda`` when a card is present,
else ``cpu``.  A CPU workload and a card workload resolve apart.

``mesh=`` (a ``DeviceMesh`` with ``mesh_dim_names``) makes the plan
sharded: (B, K) is the global workload, rows shard over the mesh's data
axes (``spec=`` overrides them), and ``build`` / ``draw`` / ``sample`` /
``sample_logits`` route to :mod:`.sharded`, which draws every random
number from the counter RNG: pass ``key=`` (a raw (2,) uint32 pair or an
int); ``u=`` and ``generator=`` raise there.

The decode hot path::

    p = plan((64, 256000), method="kernel", transforms="kp")
    tok = p.sample_logits(logits, generator, transforms=(TopK(64), TopP(0.95)))

runs the truncated draw of ``kernels.butterfly_sample`` (K9, or K11 and
K12) — no sort, no (B, V) sorted copy; ``plan((64, 256000),
transforms="kp")`` resolves to ``kernel_trunc`` on the card, the same
route.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import runtime
from repro_torch.sampling import distribution as _dist
from repro_torch.sampling import sharded as _sharded
from repro_torch.sampling.distribution import Categorical

_PLAN_CACHE: Dict[Tuple, "SamplerPlan"] = {}
_PLAN_LOCK = threading.Lock()
_STATS = {"autotune_resolves": 0, "plan_hits": 0, "plan_misses": 0}

METHODS = _dist.VARIANTS + ("kernel_trunc",)


def plan_stats() -> dict:
    with _PLAN_LOCK:
        return dict(_STATS)


def reset_plans() -> None:
    """Drop memoized plans and zero the counters (test isolation)."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
    _sharded.reset_sharded_cache()


def _sharded_randomness(u, generator) -> None:
    if u is not None:
        raise ValueError("sharded plans derive uniforms from the counter RNG; "
                         "pass key= instead of u=")
    if generator is not None:
        raise ValueError("sharded plans derive all randomness from the counter RNG; "
                         "pass key= instead of generator=")


@dataclasses.dataclass(frozen=True)
class SamplerPlan:
    """A resolved (method, W) strategy for one (B, K) workload.  A sharded
    plan (``mesh`` set) routes its draws through :mod:`.sharded`."""

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
    mesh: Optional[object] = None     # DeviceMesh of a sharded plan
    spec: Optional[tuple] = None      # row-axes override (PartitionSpec layout)
    devices: int = 1                  # shards the batch rows split into
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
        if self.mesh is not None:
            return _sharded.build_sharded(self, weights)
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
        if self.mesh is not None:
            raise ValueError(
                "sharded plans don't build factored state globally: doc_ids/words "
                "index *local* factor rows.  Build per shard instead (plan the "
                "per-shard shape with devices=N; see "
                "repro_torch.lda.distributed.make_sharded_gibbs)"
            )
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
             u=None, num_samples: int = 1, *, key=None) -> torch.Tensor:
        """Draw from a built distribution (see :func:`distribution.draw`).
        A sharded plan draws per shard from the counter RNG seeded by
        ``key``."""
        if self.mesh is not None:
            _sharded_randomness(u, generator)
            return _sharded.draw_sharded(self, dist, key, num_samples)
        _unsharded_key(key)
        return _dist.draw(dist, generator=generator, u=u, num_samples=num_samples)

    def sample(self, weights, generator: Optional[torch.Generator] = None, u=None,
               num_samples: int = 1, *, key=None) -> torch.Tensor:
        """Build a throwaway distribution and draw from it (a sharded plan:
        build and draw per shard, one K5 launch for a ``kernel`` plan)."""
        if self.table_method in _dist.FACTORED_VARIANTS:
            raise ValueError(
                f"plan resolved to factored variant {self.method!r}; build "
                "it with build_from_factors(theta, phi, words) and draw from that"
            )
        if self.mesh is not None:
            _sharded_randomness(u, generator)
            return _sharded.sample_sharded(self, weights, key, num_samples)
        return self.draw(self.build(weights), generator=generator, u=u,
                         num_samples=num_samples, key=key)

    def sample_logits(self, logits, generator: Optional[torch.Generator] = None,
                      temperature=1.0, num_samples: int = 1, transforms=None, *,
                      key=None) -> torch.Tensor:
        """Temperature sampling from (B, V) logits (the serving hot path).

        ``temperature == 0`` is argmax.  A ``gumbel`` plan samples in logit
        space.  ``transforms`` is a truncation chain (per-row parameters
        allowed): a ``kernel`` / ``kernel_trunc`` plan runs the truncated
        draw (threshold by radix select and bisection, no sort); other
        variants mask by the threshold twin and build from the masked
        weights.  A sharded plan draws per shard from the counter RNG
        seeded by ``key`` (K5, or K10 under a chain, for a ``kernel``
        plan's one token per row)."""
        if isinstance(temperature, (int, float)) and temperature == 0.0:
            greedy = torch.argmax(torch.as_tensor(logits), dim=-1).to(torch.int32)
            if num_samples == 1:
                return greedy
            return greedy.expand(num_samples, *greedy.shape)
        if self.mesh is not None:
            _sharded_randomness(None, generator)
            return _sharded.sample_logits_sharded(self, logits, key, temperature=temperature,
                                                  num_samples=num_samples,
                                                  transforms=transforms)
        _unsharded_key(key)
        logits = torch.as_tensor(logits)
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


def _unsharded_key(key) -> None:
    if key is not None:
        raise ValueError("key= seeds the counter RNG of sharded plans (mesh=); an "
                         "unsharded plan draws from generator= or u=")


def _scale(logits: torch.Tensor, temperature) -> torch.Tensor:
    return _dist._scale_by_temperature(torch.as_tensor(logits), temperature)


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

    ``spec_or_shape`` is a (B, K) tuple, a tensor (shape, dtype and
    backend taken from it), or a ``configs.base.SamplerSpec`` (method, W
    and draws taken from it; the workload via ``shape=``).
    ``method="auto"`` (the default) consults the autotune tuner once per
    distinct workload for ``backend`` (the device type of the workload's
    tensors).  ``W`` falsy picks the tuned W under ``auto``, else
    ``runtime.default_w(K)``.  ``transforms`` (a chain or its signature,
    e.g. ``"kp"``) joins the memo key and the tuner's ``|tr:`` bucket
    (``kernel_trunc`` becomes a candidate on the card); parameter values
    stay out of it.

    ``mesh=`` makes the plan sharded: (B, K) is the global workload, rows
    shard over the mesh's data axes (``spec=`` overrides them), the tiles
    are resolved for the per-shard (B / shards, K) workload, and the mesh
    signature joins the memo key and the tuner's ``|devN`` bucket.
    ``devices=`` without a mesh tags a caller that is already per shard
    (the shape is not divided)."""
    if hasattr(spec_or_shape, "method") and hasattr(spec_or_shape, "W"):
        sspec = spec_or_shape
        method = method if method not in (None, "auto") else sspec.method
        W = W or (sspec.W or None)
        draws = max(draws, getattr(sspec, "draws", 1))
        spec_or_shape = None
    if hasattr(spec_or_shape, "dtype") and hasattr(spec_or_shape, "shape"):
        dtype = spec_or_shape.dtype
    if backend is None and isinstance(spec_or_shape, torch.Tensor):
        backend = spec_or_shape.device.type
    method = method or "auto"
    if method != "auto" and method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: ('auto',) + {METHODS}")
    B, K = _normalize_shape(spec_or_shape, shape)
    dtype_name = _dtype_name(dtype)
    if transforms and not isinstance(transforms, str):
        from repro_torch.sampling import transforms as _tr

        transforms = _tr.signature(transforms)
    transforms = transforms or ""
    if backend is None:
        from repro_torch.autotune.tuner import default_backend

        backend = default_backend()
    mesh_sig: Tuple = ()
    if mesh is not None:
        nd = _sharded.data_size(mesh, spec)   # validates spec's axes too
        if B % nd:
            raise ValueError(f"cannot shard B={B} rows over {nd} devices along "
                             f"{_sharded.data_axes(mesh, spec)}: not divisible")
        if devices not in (None, nd):
            raise ValueError(f"devices={devices} contradicts the mesh's {nd} data shards")
        devices, B_res = nd, B // nd
        mesh_sig = _sharded.mesh_signature(mesh, spec)
    else:
        if spec is not None:
            raise ValueError("spec= only has meaning with mesh=: an unsharded plan "
                             "would silently ignore it")
        devices = int(devices or 1)
        B_res = B
    key = (B, K, dtype_name, method, W or 0, int(draws), bool(has_key), backend,
           bool(factored), devices, mesh_sig, transforms)
    with _PLAN_LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            _STATS["plan_hits"] += 1
            return hit
        _STATS["plan_misses"] += 1
    resolved, Wr, tb, tk = method, W, 0, 0
    if method == "auto":
        from repro_torch import autotune

        with _PLAN_LOCK:
            _STATS["autotune_resolves"] += 1
        res = autotune.get_tuner().resolve_full(
            B_res, K, draws=draws, dtype_name=dtype_name, has_key=has_key,
            factored=factored, devices=devices, transforms=transforms, backend=backend)
        resolved, Wr, tb, tk = res.method, W or res.W, res.tb, res.tk
    Wr = int(Wr or runtime.default_w(K))
    if not (tb and tk):
        tb, tk = runtime.default_tb(B_res), runtime.default_tk(K, Wr)
    p = SamplerPlan(method=resolved, W=Wr, shape=(B, K), dtype=dtype_name,
                    draws=int(draws), has_key=bool(has_key), backend=backend,
                    tb=int(tb), tk=int(tk), factored=bool(factored), mesh=mesh, spec=spec,
                    devices=devices, transforms=transforms)
    with _PLAN_LOCK:
        _PLAN_CACHE.setdefault(key, p)
        return _PLAN_CACHE[key]
