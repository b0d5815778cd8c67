"""Public entry point of the sparse LDA MH sweep.

:func:`mh_sweep` resolves ``impl`` through
:func:`repro_torch.kernels.runtime.resolve_impl`: the Hopper kernel S1
for CUDA tensors, the plain PyTorch version ``ref.mh_sweep_torch`` for
CPU tensors, ``impl="torch"`` for the plain version anywhere.  Both give
the same topics and accept counts.  Inputs may come in any integer /
float dtype; they are made contiguous int32 / float32 / bool here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.sparse_mh.kernel import mh_sweep as _mh_sweep_cuda
from repro_torch.kernels.sparse_mh.ref import mh_sweep_torch


def mh_sweep(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed, row0, alpha, *,
             steps: int, cap: int, mode: str, chunk: int = 256,
             impl: Optional[str] = None):
    """``steps`` MH cycles over every token of (M, L) documents: ``(z,
    word_accepts, doc_accepts, proposals)``, the counts as 0-d tensors on
    the inputs' device (``proposals`` = live tokens x steps).  ``chunk``
    (documents per step of the plain version's loop) does not change the
    result; the kernel takes every document in one launch."""
    impl = runtime.resolve_impl(impl, theta)
    dev = theta.device

    def ints(x):
        return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()

    def floats(x):
        return torch.as_tensor(x, device=dev).to(torch.float32).contiguous()

    z, docs, ids, cnt, tbl_b = (ints(x) for x in (z, docs, ids, cnt, tbl_b))
    theta, phi, tbl_a = (floats(x) for x in (theta, phi, tbl_a))
    live = torch.as_tensor(mask, device=dev)
    if live.dtype != torch.bool:
        live = live > 0
    if ids.shape[1] != cap:
        raise ValueError(f"ids has {ids.shape[1]} columns, cap is {cap}")
    if impl == "torch":
        return mh_sweep_torch(z, docs, live, theta, phi, ids, cnt, tbl_a, tbl_b, seed,
                              row0, alpha, steps=steps, cap=cap, mode=mode, chunk=chunk)
    z_new, wa, da, n = _mh_sweep_cuda(z, docs, live.contiguous(), theta, phi, ids, cnt,
                                      tbl_a, tbl_b, seed, row0, alpha, steps=steps,
                                      mode=mode)
    return z_new, wa, da, n * steps
