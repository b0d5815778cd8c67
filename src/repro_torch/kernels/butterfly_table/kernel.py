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

Two schedules (:data:`SCHEDULES`) of the same table at W = 64 and 128:
``"serial"``, one thread block per group of W rows walking its blocks in
order, and ``"split"``, a group's blocks built by several thread blocks
with no carry, then the running row added by a second kernel in the
serial order (``ref.table_split_order_torch``), so both give the same
table bit for bit.  :func:`table_schedule` picks one from the shapes; the
private ``_butterfly_table`` takes ``schedule=`` to force one.  Below
W = 64 the serial schedule is the only one (32 / W groups share a warp).

Handed fake tensors (a dry-run trace) the wrapper allocates its output
and runs its fake rule in place of the launch
(:mod:`repro_torch.kernels.fake`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import butterfly as _bfly
from repro_torch.kernels import _build
from repro_torch.kernels import fake as _fake
from repro_torch.kernels.butterfly_sample.kernel import _DTYPES

# launches since the last reset_launches() (a split call, two kernels back
# to back, counts one)
LAUNCHES: Dict[str, int] = {"butterfly_table": 0}
LAYOUTS = ("rows", "blocks")
# K1's schedules at W = 64 and 128.  The split builds a group's blocks on
# many SMs where the serial schedule walks them on one, and pays a second
# kernel that reads and writes the running row again.  _SPLIT_MAX_ROWS is
# the most rows (G * W) for which the split is taken: on the H100 it won
# at every shape of W = 64 and 128, K = 32,000 and 256,000 up to 8,192
# rows and lost from 16,384 (chip_smoke.py phase 2g; PERF.md).
SCHEDULES = ("serial", "split")
_SPLIT_MAX_ROWS = 8192
MAX_W = 128
_SIGS = {"butterfly_table": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}


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


def table_schedule(G: int, nb: int, W: int) -> str:
    """K1's schedule for G groups of nb W-blocks: ``"split"`` at W = 64
    and 128 for up to ``_SPLIT_MAX_ROWS`` rows of more than one block,
    else ``"serial"`` (below W = 64 the only one)."""
    return "split" if W >= 64 and nb > 1 and G * W <= _SPLIT_MAX_ROWS else "serial"


def butterfly_table_cuda(weights: torch.Tensor, W: int, layout: str = "rows"
                         ) -> torch.Tensor:
    """The butterfly table of (B, K) float32 or bfloat16 CUDA weights, B
    and K multiples of W, as float32 in ``layout`` (K1)."""
    return _butterfly_table(weights, W, layout)


def _butterfly_table(weights: torch.Tensor, W: int, layout: str = "rows",
                     schedule=None) -> torch.Tensor:
    """:func:`butterfly_table_cuda` in the schedule ``schedule``
    (``"serial"`` or ``"split"``, the latter at W = 64 and 128 only); None
    picks it with :func:`table_schedule`.  Both give the same table;
    forcing is for holding and timing them against each other."""
    check_table_w(W)
    _check_layout(layout)
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES} or None, got {schedule!r}")
    if schedule == "split" and W < 64:
        raise ValueError(f"the split schedule takes W = 64 or 128, got {W}")
    if not weights.is_cuda:
        raise ValueError(f"weights must be a CUDA tensor, got {weights.device}")
    if weights.dtype not in _DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got {weights.dtype}")
    if weights.dim() != 2 or not weights.is_contiguous():
        raise ValueError("weights must be a contiguous 2-D tensor")
    B, K = weights.shape
    G, nb = _shape(B, K, W)
    if schedule is None:
        schedule = table_schedule(G, nb, W)
    out = torch.empty((B, K) if layout == "rows" else (G, nb, W, W),
                      dtype=torch.float32, device=weights.device)
    if _fake.is_fake(weights):
        _fake.traced("butterfly_table", B * K * (weights.element_size() + 4))
        return out
    lib = _build.bind("butterfly_table", _SIGS)
    _build.launch(lib, "butterfly_table", LAUNCHES, weights.data_ptr(),
                  out.data_ptr(), G, nb, W, LAYOUTS.index(layout),
                  _DTYPES[weights.dtype], int(schedule == "split"))
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
