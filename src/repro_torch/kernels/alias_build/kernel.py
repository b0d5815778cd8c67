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
and the light mass ``csL``.

K13 has three layouts (:data:`LAYOUTS`) that make the same fp32 adds in
the same order, so they agree bit for bit (``ref.assemble_{block,group,
split}_order_torch`` model them): ``"block"``, one block of 256 threads
per row walking 1,024-column chunks with a ``cs`` scratch row; ``"group"``
(Kp a power of two up to 1,024), Kp / 4 lanes per row, several rows per
block, ``cs`` in shared memory; ``"split"`` (Kp a multiple of 1,024 above
it), a row's eight warp slots walked by eight warps, the carries chained
per row, the heavy entries rebuilt from them.  :func:`alias_layout`
picks one from the shape; the private :func:`_alias_assemble` takes
``layout=`` to force one.  The wrapper takes CUDA tensors only, checks
device, dtype, shape and contiguity, allocates the outputs and the
layout's scratch with ``torch.empty``, launches on the current stream and
counts the launch in :data:`LAUNCHES` (a split call, three kernels back
to back, counts once).  Handed fake tensors (a dry-run trace) it
allocates the same and runs its fake rule in place of the launch
(:mod:`repro_torch.kernels.fake`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fake as _fake

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"alias_assemble": 0}
_SIGS = {"alias_assemble": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}

LAYOUTS = ("block", "group", "split")
CHUNK = 1024            # columns a block-layout chunk (kThreads * kItems)
GROUP_MAX_KP = CHUNK    # the group layout takes one chunk a row
# the narrowest rows the split is taken for: on the H100 it beat the block
# layout from 16 chunks a row (Kp = 16,384) at every B measured (64 to
# 32,768 rows), and lost at 4 chunks (Kp = 4,096) at every B (PERF.md)
SPLIT_MIN_KP = 16 * CHUNK
_T_STRIDE = 16          # floats a chunk's carry terms take (kTStride)
_WARPS = 8              # warp slots a row (kWarps)


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


def fitting_layouts(B: int, Kp: int) -> tuple:
    """The layouts of :data:`LAYOUTS` that take B rows of Kp columns: block
    any; group a power of two Kp from 4 to 1,024; split Kp a multiple of
    1,024 above it and at most 65,535 rows (the grid's y limit)."""
    group = 4 <= Kp <= GROUP_MAX_KP and Kp & (Kp - 1) == 0
    split = Kp > CHUNK and Kp % CHUNK == 0 and B <= 65535
    return tuple(lay for lay, ok in zip(LAYOUTS, (True, group, split)) if ok)


def alias_layout(B: int, Kp: int) -> str:
    """K13's layout for B rows of Kp columns: ``"group"`` where it fits,
    ``"split"`` where it fits from SPLIT_MIN_KP on, else ``"block"``."""
    fits = fitting_layouts(B, Kp)
    if "group" in fits:
        return "group"
    if "split" in fits and Kp >= SPLIT_MIN_KP:
        return "split"
    return "block"


def _split_work_floats(B: int, Kp: int) -> int:
    """Floats of the split layout's scratch (alias_build.cu's SplitWork):
    a shfl_up term per thread slot and chunk, the carry terms and the
    carry per chunk, a light sum per warp slot."""
    nc = Kp // CHUNK
    return B * (Kp // 4 + (_T_STRIDE + 1) * nc + _WARPS)


def alias_assemble(s_sorted, nL, rank) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13: (B, Kp) float32 partitioned scaled weights, (B,) int32 light
    counts and (B, Kp) int32 merged ranks -> (prob (B, Kp) float32,
    apos (B, Kp) int32), in the layout :func:`alias_layout` picks.  Any
    Kp is taken."""
    return _alias_assemble(s_sorted, nL, rank)


def _alias_assemble(s_sorted, nL, rank, layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`alias_assemble` in the layout ``layout`` (one of
    :data:`LAYOUTS`; None picks it with :func:`alias_layout`, and takes
    ``"block"`` where s_sorted or rank is not 16-byte aligned).  Every
    layout gives the same prob and apos bit for bit."""
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS} or None, got {layout!r}")
    if not s_sorted.is_cuda:
        raise ValueError(f"s_sorted must be a CUDA tensor, got {s_sorted.device}")
    if s_sorted.dim() != 2:
        raise ValueError("s_sorted must be 2-D")
    B, Kp = s_sorted.shape
    _check("s_sorted", s_sorted, torch.float32, (B, Kp), s_sorted)
    _check("nL", nL, torch.int32, (B,), s_sorted)
    _check("rank", rank, torch.int32, (B, Kp), s_sorted)
    fake = _fake.is_fake(s_sorted)
    # a fake tensor has no address; the build's own padded copies are fresh
    # allocations, which are aligned
    aligned = fake or (s_sorted.data_ptr() % 16 == 0 and rank.data_ptr() % 16 == 0)
    if layout is None:
        layout = alias_layout(B, Kp) if aligned else "block"
    elif layout != "block" and not aligned:
        raise ValueError(f"the {layout} layout needs 16-byte aligned s_sorted and rank")
    if layout not in fitting_layouts(B, Kp):
        raise ValueError(f"the {layout} layout does not take ({B}, {Kp}) rows "
                         f"(fitting_layouts: {fitting_layouts(B, Kp)})")
    dev = s_sorted.device
    prob = torch.empty((B, Kp), dtype=torch.float32, device=dev)
    apos = torch.empty((B, Kp), dtype=torch.int32, device=dev)
    work = None  # the group layout keeps cs in shared memory
    if layout == "block":  # the cs scratch row
        work = torch.empty((B, Kp), dtype=torch.float32, device=dev)
    elif layout == "split":
        work = torch.empty(_split_work_floats(B, Kp), dtype=torch.float32, device=dev)
    if fake:
        _fake.traced("alias_assemble", s_sorted.numel() * 16 + B * 4)
        return prob, apos
    lib = _build.bind("alias_build", _SIGS)
    _build.launch(lib, "alias_assemble", LAUNCHES, s_sorted.data_ptr(), nL.data_ptr(),
                  rank.data_ptr(), prob.data_ptr(), apos.data_ptr(),
                  None if work is None else work.data_ptr(), B, Kp, LAYOUTS.index(layout))
    return prob, apos
