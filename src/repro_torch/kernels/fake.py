"""Fake rules of the sampler kernels: what a kernel wrapper does when its
inputs are ``FakeTensor``s (``torch._subclasses.FakeTensorMode``, the
dry-run's trace), where no kernel can be built or launched.

A wrapper that is handed a fake tensor allocates exactly the outputs and
scratch its real call allocates (so a memory count sees them), adds one
to :data:`TRACED` under its launch name and the bytes its bound reckons
(each input read once, each output written once; PERF.md §6) to
:data:`TRACED_BYTES`, and returns.  It builds and launches nothing:
``_build.load`` is never reached.  A real tensor takes the wrapper's
launch path as before, after one type check.

The sampler kernels K1-K5 and K9-K13 have fake rules; K6-K8 and S1 (the
LDA kernels) are on no dry-run cell and have none.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor

# calls traced by a fake rule since the last reset_traced(), by launch name
TRACED: Dict[str, int] = {}
# the bytes each traced call's bound reckons, summed, by launch name
TRACED_BYTES: Dict[str, int] = {}


def is_fake(t) -> bool:
    """Is ``t`` a FakeTensor (a trace's stand-in with no storage)?"""
    return isinstance(t, FakeTensor)


def traced(name: str, nbytes: int) -> None:
    """Count one traced call of kernel ``name`` moving ``nbytes``."""
    TRACED[name] = TRACED.get(name, 0) + 1
    TRACED_BYTES[name] = TRACED_BYTES.get(name, 0) + int(nbytes)


def reset_traced() -> None:
    TRACED.clear()
    TRACED_BYTES.clear()


def require_real(t: torch.Tensor, what: str) -> None:
    """Raise, naming ``what``, where a computation reads a tensor's values
    on the host and ``t`` is fake: its result would be made up."""
    if is_fake(t):
        raise ValueError(f"{what} reads the values of its input on the host; "
                         "it cannot run on a fake tensor (a dry-run trace)")
