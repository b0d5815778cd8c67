"""Public entry point of the butterfly table (the counterpart of
``repro.kernels.butterfly_table.ops``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.butterfly_table.kernel import (
    butterfly_table_cuda,
    butterfly_table_torch,
)


def butterfly_table(weights, W: int = 32, impl: Optional[str] = None,
                    layout: str = "rows") -> torch.Tensor:
    """Butterfly-patterned partial-sums table for (B, K) weights, B and K
    multiples of W (pad with ``core.butterfly.pad_to_multiple``).

    ``layout="rows"`` gives the reference's (B, K) layout, ``"blocks"``
    the (G, nb, W, W) one of ``core.butterfly.build_butterfly_table``.
    ``impl=None`` follows the tensor's device (K1 on CUDA)."""
    w = torch.as_tensor(weights)
    if runtime.resolve_impl(impl, w) == "cuda":
        return butterfly_table_cuda(w.contiguous(), W, layout)
    return butterfly_table_torch(w, W, layout)
