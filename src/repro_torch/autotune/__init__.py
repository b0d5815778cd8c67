"""Autotuned sampler dispatch, the counterpart of ``repro.autotune``:
``method="auto"`` resolves to a concrete strategy per workload through
three layers:

  1. :mod:`.cost_model`: analytical per-method cost from (B, K, draws,
     dtype, backend); no timing.  The ``"cuda"`` constants were fitted on
     an H100 (``chip_smoke.py``, phase 5b).
  2. :mod:`.tuner` + :mod:`.cache`: measured tuning (``REPRO_AUTOTUNE=
     measure``; default ``model``), winners persisted to a JSON cache
     keyed by (backend, shape bucket): ``$REPRO_TORCH_AUTOTUNE_CACHE``,
     default ``~/.cache/repro_torch/autotune.json`` (the port's own file,
     apart from the reference's).
  3. :mod:`.tables`: memoized distributions (alias, Fenwick, alias_device,
     radix forest) for ``dist_key=``, keyed by a content digest.

The backend is the device type of the call's tensors, so a CPU call and a
card call resolve in different buckets::

    from repro_torch import autotune
    autotune.resolve(4096, 1024, backend="cuda")       # what would run?
    autotune.get_tuner().cache.save()                   # persist winners
    autotune.get_table_cache().invalidate("lda_phi")    # phi was resampled
"""

from repro_torch.autotune.cache import (
    BENCH_SCHEMA,
    PATH_ENV,
    SCHEMA,
    TuningCache,
    bucket_key,
    default_cache_path,
)
from repro_torch.autotune.cost_model import (
    BACKENDS,
    FACTORED_METHODS,
    SPARSE_METHODS,
    BackendParams,
    choose,
    default_tiles,
    default_w,
    method_cost_eq,
    predict_us,
    rank_methods,
)
from repro_torch.autotune.tables import (
    TableCache,
    content_digest,
    get_table_cache,
    reset_table_cache,
)
from repro_torch.autotune.tuner import (
    Resolution,
    Tuner,
    candidate_methods,
    get_tuner,
    measure_candidates,
    measure_method,
    reset_tuner,
)


def resolve(B: int, K: int, *, draws: int = 1, dtype_name: str = "float32",
            has_key: bool = True, factored: bool = False, devices: int = 1,
            sparse: bool = False, kd=None, backend=None):
    """The global tuner's (method, W) for a workload descriptor
    (``devices > 1``: B is a mesh shard's rows; ``backend``: the device
    type of the call's tensors)."""
    return get_tuner().resolve(B, K, draws=draws, dtype_name=dtype_name,
                               has_key=has_key, factored=factored, devices=devices,
                               sparse=sparse, kd=kd, backend=backend)


def resolve_full(B: int, K: int, *, draws: int = 1, dtype_name: str = "float32",
                 has_key: bool = True, factored: bool = False, devices: int = 1,
                 sparse: bool = False, kd=None, backend=None) -> Resolution:
    """Full resolution including the tile parameters."""
    return get_tuner().resolve_full(B, K, draws=draws, dtype_name=dtype_name,
                                    has_key=has_key, factored=factored, devices=devices,
                                    sparse=sparse, kd=kd, backend=backend)


def reset() -> None:
    """Drop all process-global autotune state (tests re-point the cache),
    and ``repro_torch.sampling``'s memoized plans with it: a plan freezes
    a resolution, so it must not outlive the tuner state it came from."""
    reset_tuner()
    reset_table_cache()
    from repro_torch import sampling

    sampling.reset_plans()


__all__ = [
    "BACKENDS", "BENCH_SCHEMA", "FACTORED_METHODS", "PATH_ENV", "SCHEMA",
    "SPARSE_METHODS", "BackendParams", "Resolution", "TableCache", "Tuner",
    "TuningCache", "bucket_key", "candidate_methods", "choose", "content_digest",
    "default_cache_path", "default_tiles", "default_w", "get_table_cache",
    "get_tuner", "measure_candidates", "measure_method", "method_cost_eq",
    "predict_us", "rank_methods", "reset", "reset_table_cache", "reset_tuner",
    "resolve", "resolve_full",
]
