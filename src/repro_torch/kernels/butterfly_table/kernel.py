"""The paper's butterfly table (Alg. 8): the wrapper of the Hopper kernel
K1 and its plain PyTorch version.

``butterfly_table_cuda`` (``csrc/butterfly_table.cu``) replaces the
reference's ``_table_kernel`` in ``repro/kernels/butterfly_table/kernel.py``;
``butterfly_table_torch`` is ``core.butterfly.build_butterfly_table``.

Two layouts of the same table:

* ``"rows"``   — (B, K), the reference's: block (g, c) of samples x
  categories at rows g*W.., columns c*W..;
* ``"blocks"`` — (G, nb, W, W), what ``core.butterfly.butterfly_search``
  reads; the kernel writes it directly, so no permuted copy is made.

Row W-1 of every block holds each sample's running prefix through that
block.  The kernel keeps a W x W block in the registers of W lanes (for
W = 64 and 128 the lanes of W / 32 warps, which exchange through shared
memory in the rounds with bit >= 32), so it takes W a power of two in
[2, 128].
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import butterfly as _bfly
from repro_torch.kernels import _build
from repro_torch.kernels.butterfly_sample.kernel import _DTYPES

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"butterfly_table": 0}
LAYOUTS = ("rows", "blocks")
MAX_W = 128
_SIGS = {"butterfly_table": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def reset_launches() -> None:
    LAUNCHES["butterfly_table"] = 0


def check_table_w(W: int) -> int:
    """K1 takes W a power of two in [2, 128]: one W x W block lives in the
    registers of W lanes."""
    if W < 2 or W > MAX_W or (W & (W - 1)) != 0:
        raise ValueError(
            f"the butterfly table kernel takes W a power of two in [2, {MAX_W}] "
            f"(one block in the registers of W lanes), got {W}"
        )
    return W


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def _shape(B: int, K: int, W: int):
    if B % W or K % W:
        raise ValueError(f"(B={B}, K={K}) must be multiples of W={W}; pad first")
    return B // W, K // W


def butterfly_table_cuda(weights: torch.Tensor, W: int, layout: str = "rows"
                         ) -> torch.Tensor:
    """The butterfly table of (B, K) float32 or bfloat16 CUDA weights, B
    and K multiples of W, as float32 in ``layout`` (K1)."""
    check_table_w(W)
    _check_layout(layout)
    if not weights.is_cuda:
        raise ValueError(f"weights must be a CUDA tensor, got {weights.device}")
    if weights.dtype not in _DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got {weights.dtype}")
    if weights.dim() != 2 or not weights.is_contiguous():
        raise ValueError("weights must be a contiguous 2-D tensor")
    B, K = weights.shape
    G, nb = _shape(B, K, W)
    out = torch.empty((B, K) if layout == "rows" else (G, nb, W, W),
                      dtype=torch.float32, device=weights.device)
    lib = _build.bind("butterfly_table", _SIGS)
    _build.launch(lib, "butterfly_table", LAUNCHES, weights.data_ptr(),
                  out.data_ptr(), G, nb, W, LAYOUTS.index(layout),
                  _DTYPES[weights.dtype])
    return out


def butterfly_table_torch(weights: torch.Tensor, W: int, layout: str = "rows"
                          ) -> torch.Tensor:
    """Plain version of :func:`butterfly_table_cuda`: the rounds of
    ``core.butterfly.build_butterfly_table`` in float32 (float64 stays
    float64)."""
    _check_layout(layout)
    B, K = weights.shape
    _shape(B, K, W)
    w = weights if weights.dtype in (torch.float32, torch.float64) else weights.float()
    t = _bfly.build_butterfly_table(w, W)
    return t if layout == "blocks" else t.transpose(1, 2).reshape(B, K)
