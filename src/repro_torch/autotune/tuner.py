"""Measured tuner (autotune layer 2), the counterpart of
``repro.autotune.tuner``.

``Tuner.resolve_full`` is the entry point behind ``method="auto"``: it
maps a workload descriptor (B, K, draws, dtype, has a random stream?,
factored?, truncation signature, mesh shards) to a concrete
:class:`Resolution` (method, W, tiles).

Resolution order:

  1. a :class:`TuningCache` hit for the shape bucket (a measured or
     imported winner beats a cost-model guess),
  2. on a miss in mode ``measure``: time every candidate on synthetic
     data of the real shape on the backend's device, persist the winner
     (``source="measured"``),
  3. on a miss in mode ``model`` (the default): rank the candidates with
     the cost model and persist the pick (``source="model"``),
  4. mode ``off``: the cost model every time, nothing persisted.

The mode comes from ``$REPRO_AUTOTUNE`` (``measure`` | ``model`` |
``off``), the switch the reference reads too; ``measure`` re-tunes
buckets whose entry is only a model guess.

The backend is per call: the device type of the call's tensors
(``"cuda"`` or ``"cpu"``), so a CPU call and a card call in one process
land in different buckets.  A caller that gives only a shape gets the
process default (``cuda`` when a card is present).

Measure mode never times while a CUDA stream captures a graph or
``torch.compile`` traces (a stopwatch there measures recording, not
execution): it takes the cost model's pick and persists it as
``source="model"``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.autotune import cost_model
from repro_torch.autotune.cache import TuningCache, bucket_key

# methods that draw from given uniforms: always candidates
U_METHODS = ("prefix", "fenwick", "two_level", "butterfly", "radix_forest")
# methods that need a random stream (a generator): candidates only when
# the caller has one
KEY_METHODS = ("gumbel", "alias", "alias_device")
# every strategy any resolver can return: the ingest whitelist
KNOWN_METHODS = U_METHODS + KEY_METHODS + (
    "kernel", "kernel_trunc", "lda_kernel", "sparse_mh",
)
# the methods whose draws take a block width: timed at two W
BLOCKED_METHODS = ("fenwick", "two_level", "butterfly", "kernel", "kernel_trunc",
                   "lda_kernel")

MODES = ("measure", "model", "off")


@dataclasses.dataclass(frozen=True)
class Resolution:
    """A full tuner answer: strategy plus the tile parameters (``tb``
    rows per draw tile, ``tk`` pass-A column tile) recorded per bucket."""

    method: str
    W: int
    tb: int
    tk: int
    source: str = "model"

    def pair(self) -> Tuple[str, int]:
        return self.method, self.W


def _mode_from_env() -> str:
    mode = os.environ.get("REPRO_AUTOTUNE", "model").lower()
    return mode if mode in MODES else "model"


def default_backend() -> str:
    """The backend of a caller that gives only a shape: ``cuda`` when a
    card is present, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _tracing_active() -> bool:
    """True while ``torch.compile`` traces, a ``FakeTensorMode`` is active
    (the dry-run's trace) or a CUDA stream captures a graph: timing there
    measures recording, not execution, and nothing concrete exists to
    digest."""
    from torch._guards import active_fake_mode

    if torch.compiler.is_compiling() or active_fake_mode() is not None:
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def candidate_methods(
    B: int, K: int, backend: str, has_key: bool, factored: bool = False,
    transforms: str = "", sparse: bool = False,
) -> Tuple[str, ...]:
    """All viable strategies for this workload: the u-driven methods,
    the keyed ones when the caller has a random stream, plus whatever the
    kernels registry offers on ``backend`` (``factored``: the fused
    factored draw; a ``transforms`` signature: the fused truncated draw;
    ``sparse``: the MH sweep)."""
    from repro_torch import kernels

    cands = list(U_METHODS)
    if has_key:
        cands.extend(KEY_METHODS)
    cands.extend(kernels.candidates(B, K, backend, factored=factored,
                                    truncated=bool(transforms), sparse=sparse))
    # a registry-contributed keyed strategy (alias_device) cannot serve a
    # caller that brings uniforms only
    if not has_key:
        cands = [c for c in cands if c not in KEY_METHODS]
    return tuple(dict.fromkeys(cands))  # dedupe, keep order


def _workload(method: str, B: int, K: int, W: int, dtype: torch.dtype, seed: int,
              factored: bool, truncated: bool, device: torch.device,
              sparse: bool = False):
    """The call ``measure_method`` times, on synthetic inputs made on
    ``device`` from ``seed``; ``None`` when the method does not serve the
    workload."""
    from repro_torch.core import api as _api
    from repro_torch.sampling import transforms as _tr

    if method == "sparse_mh":
        if not sparse:
            return None
        from repro_torch.lda import sparse as _sparse

        return _sparse._mh_workload(B, K, device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed)
    w = (0.1 + 0.9 * torch.rand((B, K), generator=g, device=device)).to(dtype)
    u = torch.rand((B,), generator=g, device=device)
    keyed = method in KEY_METHODS
    if truncated:
        chain = _tr.chain(top_k=max(K // 8, 1), top_p=0.9)
        if method == "kernel_trunc":
            from repro_torch.kernels.butterfly_sample import ops as _kops

            kpm = _tr.canonical_params(chain, B, device=device)
            return lambda: _kops.butterfly_sample_truncated(w, u, kpm, W=W)
        if not factored:
            if keyed:
                return lambda: _api.sample_categorical(_tr.apply(w, chain), g,
                                                       method=method, W=W)
            return lambda: _api.sample_categorical(_tr.apply(w, chain), u=u,
                                                   method=method, W=W)
    if method in cost_model.FACTORED_METHODS:
        if not factored:
            return None
    if method == "kernel_trunc":
        return None
    if factored:
        # an LDA-shaped factorization at the real (B, K): flat methods are
        # timed with the gather and the (B, K) product they really pay
        C, V = max(1, B // 32), 64
        theta = (0.1 + 0.9 * torch.rand((C, K), generator=g, device=device)).to(dtype)
        phi = (0.1 + 0.9 * torch.rand((V, K), generator=g, device=device)).to(dtype)
        doc_ids = torch.randint(0, C, (B,), generator=g, device=device, dtype=torch.int32)
        words = torch.randint(0, V, (B,), generator=g, device=device, dtype=torch.int32)
        if method in cost_model.FACTORED_METHODS:
            from repro_torch.kernels.lda_draw import lda_draw_factored

            return lambda: lda_draw_factored(theta, phi, doc_ids, words, u, W=W)
        dl, wl = doc_ids.long(), words.long()
        if keyed:
            return lambda: _api.sample_categorical(theta[dl] * phi[wl], g,
                                                   method=method, W=W)
        return lambda: _api.sample_categorical(theta[dl] * phi[wl], u=u,
                                               method=method, W=W)
    if keyed:
        return lambda: _api.sample_categorical(w, g, method=method, W=W)
    return lambda: _api.sample_categorical(w, u=u, method=method, W=W)


def measure_method(
    method: str,
    B: int,
    K: int,
    W: int,
    *,
    dtype=None,
    iters: int = 3,
    warmup: int = 1,
    seed: int = 0,
    factored: bool = False,
    truncated: bool = False,
    sparse: bool = False,
    device=None,
) -> Optional[float]:
    """Median microseconds of one (B, K) draw call on synthetic weights on
    ``device`` (default: the process default backend's), timed by the
    host clock around the call with ``torch.cuda.synchronize()`` on both
    sides: the call's launches and checks count, as a caller pays them.

    ``factored=True`` times the LDA workload (flat methods include the
    gather and the product); ``sparse=True`` admits ``sparse_mh``, timed as
    a B-token MH draw (``lda.sparse._mh_workload``); ``truncated=True``
    times a top-k/top-p workload at (max(K // 8, 1), 0.9) (``kernel_trunc``
    its fused draw, every other method the threshold search and masking
    first).

    ``None`` only where the method deliberately does not run: it does not
    serve the workload, it refuses the shape with ``ValueError``, or the
    card runs out of memory.  Any other failure (a kernel that does not
    build or launch) propagates."""
    dev = torch.device(device if device is not None else default_backend())
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype or "float32"))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        fn = _workload(method, B, K, W, dt, seed, factored, truncated, dev, sparse)
        if fn is None:
            return None
        for _ in range(max(warmup, 1)):
            fn()
        sync()
        times = []
        for _ in range(max(iters, 1)):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
    except (torch.cuda.OutOfMemoryError, ValueError):
        return None
    return float(np.median(times) * 1e6)


def measure_candidates(
    cands: Sequence[str], B: int, K: int, *, dtype_name: str = "float32",
    factored: bool = False, truncated: bool = False, sparse: bool = False,
    device=None, iters: int = 3, warmup: int = 1,
) -> Dict[Tuple[str, int], Optional[float]]:
    """``measure_method`` for every candidate, the blocked methods at the
    model's W and at 32: {(method, W): us or None}."""
    w_guess = cost_model.default_w(K)
    out: Dict[Tuple[str, int], Optional[float]] = {}
    for method in cands:
        for W in (sorted({w_guess, 32}) if method in BLOCKED_METHODS else (w_guess,)):
            out[(method, W)] = measure_method(
                method, B, K, W, dtype=dtype_name, factored=factored,
                truncated=truncated, sparse=sparse, device=device,
                iters=iters, warmup=warmup)
    return out


class Tuner:
    """Workload -> (method, W) resolver with a persistent winner cache."""

    def __init__(self, cache: Optional[TuningCache] = None, mode: Optional[str] = None,
                 backend: Optional[str] = None):
        self.cache = cache if cache is not None else TuningCache()
        self._mode = mode
        self._backend = backend

    @property
    def mode(self) -> str:
        return self._mode or _mode_from_env()

    @property
    def backend(self) -> str:
        """The backend of calls that name none: the one this tuner was
        made for, else the process default."""
        return self._backend or default_backend()

    # -- the entry point behind method="auto" -----------------------------

    def resolve(self, B: int, K: int, *, draws: int = 1, dtype_name: str = "float32",
                has_key: bool = True, factored: bool = False, devices: int = 1,
                transforms: str = "", sparse: bool = False, kd: Optional[float] = None,
                candidates: Optional[Sequence[str]] = None,
                backend: Optional[str] = None) -> Tuple[str, int]:
        """(method, W); see :meth:`resolve_full`."""
        return self.resolve_full(
            B, K, draws=draws, dtype_name=dtype_name, has_key=has_key,
            factored=factored, devices=devices, transforms=transforms,
            sparse=sparse, kd=kd, candidates=candidates, backend=backend,
        ).pair()

    def resolve_full(self, B: int, K: int, *, draws: int = 1, dtype_name: str = "float32",
                     has_key: bool = True, factored: bool = False, devices: int = 1,
                     transforms: str = "", sparse: bool = False,
                     kd: Optional[float] = None,
                     candidates: Optional[Sequence[str]] = None,
                     backend: Optional[str] = None) -> Resolution:
        """Full resolution with the tile parameters.

        ``backend`` is the device type of the call's tensors (default:
        :attr:`backend`).  ``devices > 1`` marks a mesh-sharded workload:
        ``B`` is the per-shard row count and the winner lands in the
        topology's ``|devN`` bucket.  A ``transforms`` signature (``"kp"``
        ...) marks a truncated decode (``kernel_trunc`` joins on the card;
        every candidate is costed with its threshold search).
        ``sparse=True`` admits the MH sweep.  ``candidates`` replaces the
        registry's set (e.g. to leave a method out of a measurement)."""
        backend = backend or self.backend
        cands = tuple(
            candidates if candidates is not None
            else candidate_methods(B, K, backend, has_key, factored=factored,
                                   transforms=transforms, sparse=sparse)
        )
        mode = self.mode
        truncated = bool(transforms)
        key = bucket_key(backend, B, K, draws, dtype_name, has_key=has_key,
                         factored=factored, devices=devices, transforms=transforms,
                         sparse=sparse)

        if mode != "off":
            hit = self.cache.get(key)
            if hit is not None and hit["method"] in cands:
                if not (mode == "measure" and hit.get("source") == "model"):
                    W = int(hit.get("W", 32))
                    tb0, tk0 = cost_model.default_tiles(B, K, W)
                    return Resolution(method=hit["method"], W=W,
                                      tb=int(hit.get("tb") or tb0),
                                      tk=int(hit.get("tk") or tk0),
                                      source=str(hit.get("source", "model")))

        dtype_bytes = 2 if "16" in dtype_name else 8 if "64" in dtype_name else 4
        if mode == "measure" and not _tracing_active():
            method, W, us = self._tune(cands, B, K, draws, dtype_name, dtype_bytes,
                                       backend, factored=factored, truncated=truncated,
                                       sparse=sparse)
            source = "measured"
        else:
            method, W, us = cost_model.choose(
                cands, B, K, draws=draws, dtype_bytes=dtype_bytes, backend=backend,
                factored=factored, truncated=truncated, sparse=sparse, kd=kd)
            source = "model"
        tb, tk = cost_model.default_tiles(B, K, W)
        if mode != "off":
            self.cache.put(key, method, W, us, source=source, tb=tb, tk=tk)
            self.cache.save_if_dirty()
        return Resolution(method=method, W=W, tb=tb, tk=tk, source=source)

    def _tune(self, cands, B, K, draws, dtype_name, dtype_bytes, backend,
              factored=False, truncated=False, sparse=False):
        """Time every candidate on ``backend``'s device at the bucket's
        shape; the cost model's pick if none runs (every one refused the
        shape or ran out of memory)."""
        timed = measure_candidates(cands, B, K, dtype_name=dtype_name, factored=factored,
                                   truncated=truncated, sparse=sparse, device=backend)
        best = measured_winner(timed, K, draws=draws, dtype_bytes=dtype_bytes,
                               backend=backend)
        if best is None:
            return cost_model.choose(cands, B, K, draws=draws, dtype_bytes=dtype_bytes,
                                     backend=backend, factored=factored,
                                     truncated=truncated, sparse=sparse)
        return best


def amortized_us(us: float, method: str, K: int, W: int, *, draws: int = 1,
                 dtype_bytes: int = 4, backend: str = "cpu") -> float:
    """A measured build + one draw as the time per draw over ``draws``
    uses: a cached-table method's build amortizes by the cost model's own
    ratio (table reuse is what ``dist_key`` or a held ``Categorical``
    buys); every other method's time is its time."""
    if draws <= 1 or method not in cost_model.CACHED_TABLE_METHODS:
        return us
    kw = dict(W=W, dtype_bytes=dtype_bytes, backend=backend)
    full = cost_model.method_cost_eq(method, K, draws=1, **kw)
    return us * cost_model.method_cost_eq(method, K, draws=draws, **kw) / full


def measured_winner(timed: Dict[Tuple[str, int], Optional[float]], K: int, *,
                    draws: int = 1, dtype_bytes: int = 4, backend: str = "cpu"
                    ) -> Optional[Tuple[str, int, float]]:
    """The fastest (method, W, us) of ``measure_candidates``' timings
    (first in candidate order on a tie), or ``None`` if none ran."""
    best = None
    for (method, W), us in timed.items():
        if us is None:
            continue
        us = amortized_us(us, method, K, W, draws=draws, dtype_bytes=dtype_bytes,
                          backend=backend)
        if best is None or us < best[2]:
            best = (method, W, us)
    return best


# ---------------------------------------------------------------------------
# Process-global tuner (what method="auto" consults)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[Tuner] = None


def get_tuner() -> Tuner:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Tuner()
    return _GLOBAL


def reset_tuner() -> None:
    """Drop the global tuner (tests re-point the cache and need it re-read)."""
    global _GLOBAL
    _GLOBAL = None
