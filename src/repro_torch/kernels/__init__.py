"""Hand-written Hopper kernels of the port, each beside its plain version.

Each kernel package ships ``kernel.py`` (the CUDA wrapper, built from
``csrc/`` on first use), ``ops.py`` (the public entry points: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors) and
``ref.py`` (exact-order CPU models of the kernels' summation orders).

``candidates()`` is the registry the autotune tuner walks, the
counterpart of ``repro.kernels.candidates``: every kernel-backed sampling
strategy with its entry point and an availability predicate, so method
selection never hard-codes kernel names.  The backend is the device type
of the workload's tensors (``"cuda"`` or ``"cpu"``), passed by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple


@dataclasses.dataclass(frozen=True)
class KernelCandidate:
    """One kernel-backed strategy the tuner may select."""

    method: str                     # name accepted by sample_categorical
    module: str                     # repro_torch module that implements it
    # is this candidate viable for (B, K, backend)?  The plain PyTorch
    # version of a two-pass CUDA kernel is a test oracle, never a candidate.
    available: Callable[[int, int, str], bool]
    description: str = ""
    # factored candidates need the workload's weights as a (theta, phi)
    # product: only offered when the caller says factored=True
    factored: bool = False
    # truncated candidates fold a top-k/top-p/min-p threshold pass into
    # the draw: only offered when the caller declares a truncation chain
    truncated: bool = False
    # sparse candidates run the sparsity-aware MH sweep over per-doc live
    # topics: only offered when the caller's workload is an LDA z-draw
    # that can supply sparse doc-topic counts (sparse=True)
    sparse: bool = False


_REGISTRY: Tuple[KernelCandidate, ...] = (
    KernelCandidate(
        method="kernel",
        module="repro_torch.kernels.butterfly_sample",
        # the CUDA kernels K2-K5; on the CPU their plain versions are
        # the oracles the kernels are held to, not a strategy
        available=lambda B, K, backend: backend == "cuda" and K >= 2,
        description="fused butterfly draw (block selection in-kernel; K4, or K2 + K3)",
    ),
    KernelCandidate(
        method="kernel_trunc",
        module="repro_torch.kernels.butterfly_sample",
        available=lambda B, K, backend: backend == "cuda" and K >= 2,
        description=(
            "fused truncated decode draw (top-k/top-p/min-p threshold by radix "
            "select in-kernel, no sort; K9, or K11 + K12)"
        ),
        truncated=True,
    ),
    KernelCandidate(
        method="lda_kernel",
        module="repro_torch.kernels.lda_draw",
        # viable everywhere: K8 (or K6 + K7) on the card, the plain
        # zero-materialization version on the CPU
        available=lambda B, K, backend: K >= 2,
        description="fused factored theta-phi draw (weights never materialize)",
        factored=True,
    ),
    KernelCandidate(
        method="alias_device",
        module="repro_torch.kernels.alias_build",
        # viable everywhere: K13 assembles on the card, its plain version
        # on the CPU; O(1) draws once built
        available=lambda B, K, backend: K >= 2,
        description="split-based alias build (K13 assembly) + O(1) two-uniform draws",
    ),
    KernelCandidate(
        method="radix_forest",
        module="repro_torch.core.radix",
        # plain PyTorch on every backend: cumsum + searchsorted build,
        # fixed clamped bisection draw
        available=lambda B, K, backend: K >= 2,
        description=(
            "radix-tree forest draw (root dispatch on top uniform bits + "
            "fixed-depth clamped bisection; cheap rebuild)"
        ),
    ),
    KernelCandidate(
        method="sparse_mh",
        module="repro_torch.lda.sparse",
        # viable everywhere: the Hopper kernel S1 on the card, its plain
        # version on the CPU; sublinear per-token cost in K
        available=lambda B, K, backend: K >= 2,
        description=(
            "sparsity-aware MH-alias Gibbs sweep (WarpLDA proposals over "
            "fixed-width sparse doc-topic counts; no (B, K) weights)"
        ),
        factored=True,
        sparse=True,
    ),
)


def candidates(
    B: int, K: int, backend: str, factored: bool = False,
    truncated: bool = False, sparse: bool = False,
) -> Tuple[str, ...]:
    """Kernel-backed method names viable for a (B, K) draw on ``backend``
    (the device type of the workload's tensors: ``"cuda"`` or ``"cpu"``).
    ``factored=True`` adds the strategies that consume a (theta, phi)
    factorization directly; ``truncated=True`` the fused truncated-decode
    strategies; ``sparse=True`` the sparsity-aware LDA sweep."""
    return tuple(
        c.method for c in _REGISTRY
        if c.available(B, K, backend)
        and (factored or not c.factored)
        and (truncated or not c.truncated)
        and (sparse or not c.sparse)
    )


def registry() -> Tuple[KernelCandidate, ...]:
    return _REGISTRY
