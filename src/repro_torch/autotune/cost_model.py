"""Analytical per-method sampling cost model (autotune layer 1), the
counterpart of ``repro.autotune.cost_model``.

Predicts the cost of drawing one index per row of a (B, K) weight matrix
for every registered strategy from the workload descriptor

    (B, K, draws-per-distribution, dtype, backend)

so ``method="auto"`` can pick a sampler without timing anything.  Costs
are *effective bytes per row* (real memory traffic plus byte-equivalents
of per-row gathers, RNG work and serial preprocessing), turned into
microseconds with per-backend bandwidth and launch constants.

The ``"cpu"``, ``"gpu"`` and ``"tpu"`` entries and every term of the
effective-byte model are the reference's, so the CPU rankings equal its
rankings.  The ``"cuda"`` entry is the port's own, fitted on an H100 by
``chip_smoke.py``'s autotune grid (phase 5b).  On the card the cost of a
call at small shapes is the host's: each PyTorch operation of a method
costs a launch, so a method with many small operations loses to a single
kernel long before the bytes matter.  ``BackendParams.call_us`` carries
that host time per method and per workload form, ``eq_scale`` the ratio
of a method's time per effective byte to the bandwidth's, and ``row_ns``
the time of its passes along one row (a few rows of 256,000 categories
leave most of the card idle).  All three are empty on the reference's
backends, which keeps their predictions equal.

The model stays monotonic in K for every method and backend (each term
has a nonnegative dK coefficient): ``tests/test_torch_autotune.py`` pins
that for ``"cuda"`` too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Backend descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendParams:
    """Bandwidth / overhead constants used to turn bytes into microseconds."""

    name: str
    bandwidth_gbps: float     # effective streaming bandwidth
    launch_us: float          # fixed per-dispatch overhead
    seq_penalty: float        # multiplier on inherently serial preprocessing
    # byte-equivalent of one counter-RNG draw + log per element
    rng_eq: float = 12.0
    # the hand-written kernels run natively (TPU: Pallas; the port: CUDA);
    # must stay in sync with repro_torch.kernels' availability rule
    has_kernels: bool = False
    # host microseconds per call by method, on top of launch_us: the
    # launches and checks of the method's operations.  Keys "m" (plain
    # workload), "m|fac" (a factored workload: the product formed
    # first), "m|tr" (a truncated one: the threshold search first).
    call_us: Tuple[Tuple[str, float], ...] = ()
    # per-method multiplier on the effective bytes: how much slower than
    # the streaming bandwidth the method's operations move them
    eq_scale: Tuple[Tuple[str, float], ...] = ()
    # per-method nanoseconds per category of one row: the time of the
    # method's passes along a row (a scan, a row per block), which more
    # rows do not lengthen while the card has room for them
    row_ns: Tuple[Tuple[str, float], ...] = ()


BACKENDS: Dict[str, BackendParams] = {
    "cpu": BackendParams("cpu", bandwidth_gbps=40.0, launch_us=5.0, seq_penalty=8.0,
                         rng_eq=64.0),
    "gpu": BackendParams("gpu", bandwidth_gbps=500.0, launch_us=8.0, seq_penalty=24.0),
    "tpu": BackendParams("tpu", bandwidth_gbps=800.0, launch_us=10.0, seq_penalty=32.0,
                         has_kernels=True),
    # fitted on NVIDIA H100 80GB HBM3, 700.00 W by chip_smoke.fit_cuda from
    # one run of chip_smoke.py's phase 5b grid (PERF.md §6): host us a
    # call, scales on the effective bytes, ns per category of a row;
    # sparse_mh's three terms from a later run's grid, the others kept
    "cuda": BackendParams(
        "cuda", bandwidth_gbps=3350.0, launch_us=10.0, seq_penalty=24.0,
        has_kernels=True,
        call_us=(
            ("alias", 91.3), ("alias_device", 3205.5), ("alias_device|tr", 6000.0),
            ("alias|tr", 140588.3), ("butterfly", 1741.1), ("butterfly|fac", 0.0),
            ("butterfly|tr", 12166.3), ("fenwick", 1190.3), ("fenwick|fac", 0.0),
            ("fenwick|tr", 12347.3), ("gumbel", 210.3), ("gumbel|tr", 11676.9),
            ("kernel", 221.1), ("kernel_trunc", 80.0), ("kernel|fac", 69.9),
            ("kernel|tr", 16217.1), ("lda_kernel", 60.2), ("prefix", 150.5),
            ("prefix|fac", 47.7), ("prefix|tr", 13237.7), ("radix_forest", 1458.1),
            ("radix_forest|fac", 0.0), ("radix_forest|tr", 11129.3),
            ("sparse_mh", 105.1), ("two_level", 568.6), ("two_level|fac", 0.0),
            ("two_level|tr", 13097.6),
        ),
        eq_scale=(
            ("alias", 59.237), ("alias_device", 117.840), ("butterfly", 3.593),
            ("fenwick", 5.929), ("gumbel", 4.006), ("kernel", 0.640),
            ("kernel_trunc", 23.479), ("lda_kernel", 0.615), ("prefix", 1.169),
            ("radix_forest", 5.378), ("sparse_mh", 0.516), ("two_level", 0.646),
        ),
        row_ns=(
            ("alias", 635871.053), ("alias_device", 0.000), ("butterfly", 3.414),
            ("fenwick", 1.653), ("gumbel", 0.000), ("kernel", 0.000),
            ("kernel_trunc", 1.529), ("lda_kernel", 1.611), ("prefix", 0.987),
            ("radix_forest", 2.710), ("sparse_mh", 0.278), ("two_level", 0.000),
        ),
    ),
}


def backend_params(backend: str) -> BackendParams:
    return BACKENDS.get(backend, BACKENDS["cpu"])


def _lookup(pairs: Tuple[Tuple[str, float], ...], key: str, default: float) -> float:
    for k, v in pairs:
        if k == key:
            return v
    return default


def _host_us(method: str, backend: str = "cpu", factored: bool = False,
             truncated: bool = False) -> float:
    """The backend's host microseconds per call of ``method`` beyond
    ``launch_us`` (0 on the reference's backends)."""
    bp = backend_params(backend)
    base = _lookup(bp.call_us, method, 0.0)
    if truncated and method not in TRUNCATED_METHODS:
        return base + _lookup(bp.call_us, f"{method}|tr", 0.0)
    if factored and method not in FACTORED_METHODS:
        return base + _lookup(bp.call_us, f"{method}|fac", 0.0)
    return base


# ---------------------------------------------------------------------------
# Per-method effective-byte model
# ---------------------------------------------------------------------------

# byte-equivalent of one per-row gather (a cache line touch)
LINE_EQ = 128.0
# fixed per-row setup of the blocked methods (block bookkeeping, padding,
# two-phase control); the reference's fit puts the prefix/butterfly
# crossover near the paper's K ~ 200 (Fig. 3)
BLOCK_SETUP_EQ = 640.0
# fused-kernel discount: pass A/B share one dispatch, block sums stay on chip
KERNEL_FUSION = 0.7
# extra per-element-per-round compute of the paper-faithful butterfly
BUTTERFLY_ROUND_EQ = 1.0
# the methods whose built tables the sampling API reuses across draws
# (the dist_key table cache, or a held Categorical), so their build term
# amortizes over draws-per-refresh
CACHED_TABLE_METHODS = ("alias", "fenwick", "alias_device", "radix_forest")


def default_w(K: int) -> int:
    """W ~ sqrt(K) (minimizes K/W + W), rounded to a power of two in
    [8, 128]."""
    if K <= 64:
        return 8
    w = 2 ** int(round(math.log2(math.sqrt(K))))
    return max(8, min(128, w))


def default_tiles(B: int, K: int, W: Optional[int] = None) -> Tuple[int, int]:
    """Default (tb, tk) tile sizes, the autotune-visible twins of
    ``repro_torch.kernels.runtime``'s policy."""
    from repro_torch.kernels import runtime

    W = W or default_w(K)
    return runtime.default_tb(B), runtime.default_tk(K, W)


# variants built straight from a (theta, phi) factorization
FACTORED_METHODS = ("lda_kernel",)
# surcharge for running a flat-weight method on a factored workload: the
# (B, K) product is formed first
FACTOR_MATERIALIZE_EQ = 2.0

# sparse-LDA terms (the reference's DESIGN.md §10)
SPARSE_METHODS = ("sparse_mh",)
SPARSE_KD_DEFAULT = 32.0
SPARSE_MH_BASE_LINES = 10.0
SPARSE_DESCENT_LINE = 0.7

# frozen-distribution strategy terms
ALIAS_DEVICE_PASS_DISCOUNT = 0.25
RADIX_HOT_LINE = 0.4
# root-table cap; mirrors repro_torch.core.radix.forest_bits
RADIX_ROOT_CAP = 12

# truncated-decode terms: truncation is a per-row threshold found by
# bisection; viable strategies pay for that search
TRUNC_ITERS = 32
TRUNCATED_METHODS = ("kernel_trunc",)
# per-element-per-iteration byte-equivalent of the in-kernel threshold
# search over an on-chip tile
TRUNC_VMEM_EQ = 0.05
# per-element-per-iteration byte-equivalent of the threshold twin, whose
# masked reductions re-stream the weights
TRUNC_XLA_EQ = 0.25


def method_cost_eq(
    method: str,
    K: int,
    *,
    W: Optional[int] = None,
    draws: int = 1,
    dtype_bytes: int = 4,
    backend: str = "cpu",
    factored: bool = False,
    truncated: bool = False,
    sparse: bool = False,
    kd: Optional[float] = None,
) -> float:
    """Effective bytes per row for one draw, the table build amortized
    over ``draws`` uses of the same distribution (only for the methods
    whose tables the sampling API reuses: ``CACHED_TABLE_METHODS``).

    ``factored=True`` costs the LDA workload (weights as a theta-phi
    product): flat-weight methods pay ``FACTOR_MATERIALIZE_EQ * K``.
    ``truncated=True`` costs the truncated decode: ordinary methods pay
    the threshold search (``TRUNC_ITERS`` masked re-streams) and the
    masked rewrite; ``kernel_trunc`` pays the in-kernel equivalent.
    ``sparse=True`` marks an LDA z-draw that can run the MH-alias sweep
    (``kd``: mean live topics per document)."""
    bp = backend_params(backend)
    c = float(dtype_bytes)
    d = max(int(draws), 1) if method in CACHED_TABLE_METHODS else 1
    W = W or default_w(K)
    log2K = math.log2(max(K, 2))
    log2W = math.log2(max(W, 2))

    if method == "sparse_mh":
        if not sparse:
            raise ValueError(
                "sparse_mh is only viable on sparse-capable LDA workloads"
            )
        kd_eff = min(float(kd) if kd else SPARSE_KD_DEFAULT, float(K))
        return (
            5.0 * bp.rng_eq
            + SPARSE_MH_BASE_LINES * LINE_EQ
            + kd_eff * c
            + log2K * SPARSE_DESCENT_LINE * LINE_EQ
        )
    if method == "kernel_trunc":
        if not truncated:
            raise ValueError(
                "kernel_trunc is only viable on truncated-decode workloads"
            )
        base = method_cost_eq(
            "kernel", K, W=W, draws=draws, dtype_bytes=dtype_bytes,
            backend=backend, factored=factored,
        )
        return base + TRUNC_ITERS * K * TRUNC_VMEM_EQ
    if method == "lda_kernel":
        if not factored:
            raise ValueError("lda_kernel is only viable on factored workloads")
        # pass A reads both factor rows and writes K/W running sums; the
        # draw re-reads one W-block of each factor row
        build = 2.0 * K * c + (K / W) * c
        draw = 2.0 * W * c + 2.0 * LINE_EQ + BLOCK_SETUP_EQ
        eq = build / d + draw
        return eq * KERNEL_FUSION if bp.has_kernels else eq
    if method == "prefix":
        build = 2.0 * K * c                        # read weights + write prefix
        draw = log2K * LINE_EQ                     # binary-search gathers
    elif method == "fenwick":
        build = (K + K / W) * c + K                # table write + W-1 adds/block
        draw = (log2W + 1.0) * LINE_EQ + BLOCK_SETUP_EQ
    elif method == "butterfly":
        build = (K + K / W) * c + K * log2W * BUTTERFLY_ROUND_EQ
        draw = (log2W + 1.0) * LINE_EQ + BLOCK_SETUP_EQ
    elif method == "two_level":
        build = (K + K / W) * c
        draw = W * c + 2.0 * LINE_EQ + BLOCK_SETUP_EQ
    elif method == "kernel":
        base = method_cost_eq(
            "two_level", K, W=W, draws=d, dtype_bytes=dtype_bytes,
            backend=backend, factored=factored, truncated=truncated,
        )
        if not bp.has_kernels:
            # no native kernel: the reference's interpret-mode emulation
            return base * 1000.0
        return base * KERNEL_FUSION
    elif method == "gumbel":
        build = 0.0
        draw = K * (c + bp.rng_eq)                 # full pass + RNG/log per draw
    elif method == "alias":
        # Vose build is O(K) but serial: charged the serialization penalty
        build = bp.seq_penalty * K * c
        draw = 2.0 * LINE_EQ + c
    elif method == "alias_device":
        build = (2.0 * log2K + 4.0) * K * c * ALIAS_DEVICE_PASS_DISCOUNT
        draw = 2.0 * LINE_EQ + c
    elif method == "radix_forest":
        M = float(min(1 << max(1, math.ceil(log2K)), 1 << RADIX_ROOT_CAP))
        build = 3.0 * K * c + M * c
        draw = LINE_EQ + log2K * RADIX_HOT_LINE * LINE_EQ + c
    else:
        raise ValueError(f"cost model knows no method {method!r}")
    if factored:
        build = build + FACTOR_MATERIALIZE_EQ * K * c
    if truncated:
        build = build + TRUNC_ITERS * K * c * TRUNC_XLA_EQ + 2.0 * K * c
    return build / d + draw


def predict_us(
    method: str,
    B: int,
    K: int,
    *,
    W: Optional[int] = None,
    draws: int = 1,
    dtype_bytes: int = 4,
    backend: str = "cpu",
    factored: bool = False,
    truncated: bool = False,
    sparse: bool = False,
    kd: Optional[float] = None,
) -> float:
    """Predicted microseconds for one (B, K) draw batch.

    The backend's per-call host time (``call_us``) and row time
    (``row_ns``) amortize over ``draws`` as the table build does, for the
    methods whose tables are reused (by the ratio of the amortized to the
    full effective bytes); both are zero on the reference's backends."""
    bp = backend_params(backend)
    kw = dict(W=W, dtype_bytes=dtype_bytes, backend=backend, factored=factored,
              truncated=truncated, sparse=sparse, kd=kd)
    eq = method_cost_eq(method, K, draws=draws, **kw)
    fixed = (_host_us(method, backend, factored=factored, truncated=truncated)
             + K * _lookup(bp.row_ns, method, 0.0) / 1e3)
    if fixed and draws > 1 and method in CACHED_TABLE_METHODS:
        fixed *= eq / method_cost_eq(method, K, draws=1, **kw)
    scale = _lookup(bp.eq_scale, method, 1.0)
    return bp.launch_us + fixed + B * eq * scale / (bp.bandwidth_gbps * 1e3)


def rank_methods(
    candidates: Sequence[str],
    B: int,
    K: int,
    *,
    draws: int = 1,
    dtype_bytes: int = 4,
    backend: str = "cpu",
    factored: bool = False,
    truncated: bool = False,
    sparse: bool = False,
    kd: Optional[float] = None,
) -> List[Tuple[float, str, int]]:
    """Sort candidate methods by predicted cost: [(us, method, W), ...]."""
    W = default_w(K)
    ranked = [
        (
            predict_us(m, B, K, W=W, draws=draws, dtype_bytes=dtype_bytes,
                       backend=backend, factored=factored,
                       truncated=truncated, sparse=sparse, kd=kd),
            m,
            W,
        )
        for m in candidates
    ]
    ranked.sort(key=lambda t: (t[0], t[1]))
    return ranked


def choose(
    candidates: Sequence[str],
    B: int,
    K: int,
    *,
    draws: int = 1,
    dtype_bytes: int = 4,
    backend: str = "cpu",
    factored: bool = False,
    truncated: bool = False,
    sparse: bool = False,
    kd: Optional[float] = None,
) -> Tuple[str, int, float]:
    """Best (method, W, predicted_us) among ``candidates``."""
    us, method, W = rank_methods(
        candidates, B, K, draws=draws, dtype_bytes=dtype_bytes, backend=backend,
        factored=factored, truncated=truncated, sparse=sparse, kd=kd,
    )[0]
    return method, W, us
