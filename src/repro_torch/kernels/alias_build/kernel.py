"""Closed-form alias table assembly: the wrapper of the Hopper kernel K13
and its plain PyTorch version.

``alias_assemble`` (``csrc/alias_build.cu``) replaces the reference's
``_assemble_kernel`` in ``repro/kernels/alias_build/kernel.py``;
:func:`alias_assemble_torch` is the reference's shared ``_assemble``
math on full rows (its XLA twin), with a direct gather for
``PL(i) = cs[i-1]``.

The invariant behind it (the reference's DESIGN.md §11): during the pack
sweep every completed bucket holds weight 1, so with lights then heavies
in partitioned order and their merged sweep rank, each entry's
(prob, alias position) is rank arithmetic on the inclusive prefix ``cs``
and the light mass ``csL``.  The wrapper takes CUDA tensors only, checks
device, dtype, shape and contiguity, allocates the outputs and the ``cs``
scratch row with ``torch.empty``, launches on the current stream and
counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"alias_assemble": 0}
_SIGS = {"alias_assemble": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def reset_launches() -> None:
    LAUNCHES["alias_assemble"] = 0


def _sweep_vals(s_sorted: torch.Tensor, nL: torch.Tensor):
    """Per-position sweep quantities of lights-then-heavies scaled weights:
    the position iota, light mask, inclusive prefix ``cs``, total light
    weight ``csL``, light keys ``b`` and heavy keys ``A``."""
    B, Kp = s_sorted.shape
    pos = torch.arange(Kp, dtype=torch.int32, device=s_sorted.device).expand(B, Kp)
    light = pos < nL[:, None]
    cs = torch.cumsum(s_sorted, dim=-1)
    posf = pos.to(torch.float32)
    csL = torch.where(light, s_sorted, torch.zeros((), dtype=s_sorted.dtype,
                                                   device=s_sorted.device)).sum(dim=-1)
    b = posf - (cs - s_sorted) + 1.0
    A = (cs - posf) + (nL.to(torch.float32) - csL)[:, None]
    return pos, light, cs, csL, b, A


def alias_assemble_torch(s_sorted, nL, rank) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`alias_assemble`: ``(prob, apos)`` in
    partitioned position space (``apos`` an alias *position*)."""
    B, Kp = s_sorted.shape
    pos, light, cs, csL, _b, _A = _sweep_vals(s_sorted, nL)
    nLcol = nL[:, None].to(torch.int32)
    rank = rank.to(torch.int32)
    # lights: the serving heavy is the first with A > b (rank arithmetic)
    q = torch.clamp(nLcol + (rank - pos), max=Kp - 1)
    # heavies: lights drained when heavy j empties, then conservation
    j = pos - nLcol
    i = torch.minimum(torch.clamp(rank - j, min=0), nLcol)
    PLi = torch.where(i > 0, torch.gather(cs, 1, torch.clamp(i - 1, min=0).long()),
                      torch.zeros((), dtype=cs.dtype, device=cs.device))
    r = PLi + (cs - csL[:, None]) - (i + j).to(torch.float32)
    prob = torch.where(light, torch.clamp(s_sorted, max=1.0), torch.clamp(r, 0.0, 1.0))
    apos = torch.where(light, q, torch.clamp(pos + 1, max=Kp - 1))
    return prob, apos.to(torch.int32)


def _check(name: str, t: torch.Tensor, dtype, shape, like: torch.Tensor) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def alias_assemble(s_sorted, nL, rank) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: (B, Kp) float32 partitioned scaled weights, (B,) int32 light
    counts and (B, Kp) int32 merged ranks -> (prob (B, Kp) float32,
    apos (B, Kp) int32).  Any Kp is taken."""
    if not s_sorted.is_cuda:
        raise ValueError(f"s_sorted must be a CUDA tensor, got {s_sorted.device}")
    if s_sorted.dim() != 2:
        raise ValueError("s_sorted must be 2-D")
    B, Kp = s_sorted.shape
    _check("s_sorted", s_sorted, torch.float32, (B, Kp), s_sorted)
    _check("nL", nL, torch.int32, (B,), s_sorted)
    _check("rank", rank, torch.int32, (B, Kp), s_sorted)
    prob = torch.empty((B, Kp), dtype=torch.float32, device=s_sorted.device)
    apos = torch.empty((B, Kp), dtype=torch.int32, device=s_sorted.device)
    cs = torch.empty((B, Kp), dtype=torch.float32, device=s_sorted.device)
    lib = _build.bind("alias_build", _SIGS)
    _build.launch(lib, "alias_assemble", LAUNCHES, s_sorted.data_ptr(), nL.data_ptr(),
                  rank.data_ptr(), prob.data_ptr(), apos.data_ptr(), cs.data_ptr(),
                  B, Kp)
    return prob, apos
