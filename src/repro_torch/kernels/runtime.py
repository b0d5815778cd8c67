"""Device and implementation policy shared by the port's kernel packages.

Every kernel entry point resolves its ``impl=`` argument through
:func:`resolve_impl`, so exactly one place decides which code runs:

* ``impl=None``    — the hand-written CUDA kernel for CUDA tensors, the
  plain PyTorch version for CPU tensors.  The choice follows the tensor's
  device only; nothing moves between devices and nothing falls back.
* ``impl="cuda"``  — the CUDA kernel; raises for CPU tensors.
* ``impl="torch"`` — the plain PyTorch version on either device (the
  tests and ``chip_smoke.py`` use it to hold the kernels against it).

The tile defaults of the reference (``default_tb``/``default_tk``) and its
autotune ``default_w`` live here too, so that ``W=None`` resolves to the
block width the reference picks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

IMPLS = ("cuda", "torch")


def resolve_impl(impl: Optional[str], like: torch.Tensor) -> str:
    """The single policy behind every kernel's ``impl=None`` default."""
    if impl is None:
        return "cuda" if like.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and not like.is_cuda:
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got a tensor on {like.device}"
        )
    return impl


def resolve_device(device) -> torch.device:
    """Entry points run on ``cuda`` unless the caller asks for another
    device; a CUDA request without a card raises (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def default_tb(B: int) -> int:
    """Row tile of the reference's tiled draw kernels (8 fp32 sublanes,
    16 for large batches); kept for parity with its tile bookkeeping."""
    return 8 if B < 1024 else 16


def default_tk(K: int, W: int) -> int:
    """Category tile of the reference's pass A: a multiple of W near 512,
    clamped to the padded row length."""
    Kp = -(-K // W) * W
    tk = max(W, (512 // W) * W)
    return min(tk, Kp)


def default_w(K: int) -> int:
    """W ~ sqrt(K) rounded to a power of two in [8, 128] — the reference
    autotune's choice when a sweep passes ``W=None`` (K=240 gives 16)."""
    if K <= 64:
        return 8
    w = 2 ** int(round(math.log2(math.sqrt(K))))
    return max(8, min(128, w))


def check_w(W: int) -> int:
    """The CUDA draw kernels take W a power of two in [8, 128]."""
    if W < 8 or W > 128 or (W & (W - 1)) != 0:
        raise ValueError(f"W must be a power of two in [8, 128], got {W}")
    return W
