"""On-device alias table construction (the split-based PSA build), the
counterpart of ``repro.kernels.alias_build.ops``.

:func:`build_alias_tables_device` partitions each row into lights then
heavies (:func:`_partition`: cumsum-indexed, no sort), takes each
position's rank in the merged sweep order (:func:`_merged_rank`: one
fixed-trip batched bisection, no sort) — both plain PyTorch, as they are
XLA ops in the reference — and assembles (prob, alias position) with the
Hopper kernel K13 for CUDA tensors or its plain version for CPU tensors
(``runtime.resolve_impl``).  As in the reference's kernel route, the
columns are padded to the next power of two Kp with s = 1
pseudo-heavies, which leave every real rank unchanged; the port's kernel
runs one block per row, so no rows are padded.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.alias import AliasTable
from repro_torch.kernels import runtime
from repro_torch.kernels.alias_build.kernel import (
    _sweep_vals,
    alias_assemble,
    alias_assemble_torch,
)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _partition(weights: torch.Tensor):
    """Scale each row to mean 1 and stable-partition it into lights
    (s <= 1, index order) then heavies (s > 1, index order).  Zero-total
    rows scale to all ones.  Returns ``(s_sorted, order, inv, nL)``:
    ``order`` maps sorted position -> original index, ``inv`` back."""
    w = weights.to(torch.float32)
    B, K = w.shape
    tot = w.sum(dim=-1, keepdim=True)
    ok = tot > 0
    s = torch.where(ok, w * (K / torch.where(ok, tot, torch.ones_like(tot))), 1.0)
    heavy = s > 1.0
    cH = torch.cumsum(heavy.to(torch.int32), dim=-1).to(torch.int32)
    iota1 = torch.arange(1, K + 1, dtype=torch.int32, device=w.device)[None, :]
    cL = iota1 - cH
    nL = cL[:, -1].contiguous()
    inv = torch.where(heavy, nL[:, None] + cH - 1, cL - 1)
    order = torch.empty((B, K), dtype=torch.int32, device=w.device)
    order.scatter_(1, inv.long(), torch.arange(K, dtype=torch.int32,
                                               device=w.device).expand(B, K))
    s_sorted = torch.gather(s, 1, order.long())
    return s_sorted, order, inv, nL


def _merged_rank(s_sorted: torch.Tensor, nL: torch.Tensor) -> torch.Tensor:
    """Each position's rank in the merged sweep order of the light keys b
    and heavy keys A (ties: A first): ``rank(light i) = i + #{A <= b_i}``,
    ``rank(heavy j) = j + #{b < A_j}``, both counts from one fixed-trip
    clamped bisection over the +/-inf-masked halves side by side."""
    B, Kp = s_sorted.shape
    pos, light, _cs, _csL, b, A = _sweep_vals(s_sorted, nL)
    nLcol = nL[:, None].to(torch.int64)
    inf = torch.tensor(float("inf"), device=s_sorted.device)
    A_asc = torch.where(light, -inf, A)      # -inf prefix, then rising A
    b_asc = torch.where(light, b, inf)       # rising b, then +inf tail
    halves = torch.cat([A_asc, b_asc], dim=-1)
    q = torch.where(light, b, A)
    base = torch.where(light, 0, Kp).to(torch.int64)
    lo = base
    hi = base + Kp
    for _ in range(max(1, Kp.bit_length())):
        mid = torch.minimum((lo + hi) >> 1, base + Kp - 1)
        am = torch.gather(halves, 1, mid)
        go = torch.where(light, am <= q, am < q)
        open_ = lo < hi
        lo = torch.where(open_ & go, mid + 1, lo)
        hi = torch.where(open_ & ~go, mid, hi)
    cnt = lo - base
    posl = pos.to(torch.int64)
    rank = torch.where(light, posl + (cnt - nLcol), (posl - nLcol) + cnt)
    return rank.to(torch.int32)


def build_alias_tables_device(weights, impl: Optional[str] = None) -> AliasTable:
    """(B, K) (or (K,)) non-negative weights -> ``AliasTable`` with
    ``prob`` (B, K) float32 in [0, 1] and ``alias`` (B, K) int32, built on
    the weights' device: pick column k uniformly, keep k if
    ``u < prob[k]``, else take ``alias[k]``."""
    w = torch.as_tensor(weights)
    squeeze = w.dim() == 1
    if squeeze:
        w = w[None, :]
    if w.dim() != 2:
        raise ValueError(f"expected (B, K) weights, got shape {tuple(w.shape)}")
    B, K = w.shape
    impl = runtime.resolve_impl(impl, w)
    s_sorted, order, inv, nL = _partition(w)
    Kp = _next_pow2(K)
    # s = 1 pseudo-heavies after every real entry leave the real ranks as
    # they are; their outputs are sliced away below
    sp = torch.nn.functional.pad(s_sorted, (0, Kp - K), value=1.0).contiguous()
    rank = _merged_rank(sp, nL).contiguous()
    if impl == "cuda":
        prob_s, apos = alias_assemble(sp, nL, rank)
    else:
        prob_s, apos = alias_assemble_torch(sp, nL, rank)
    prob_s, apos = prob_s[:, :K], apos[:, :K]
    # position space -> original category ids, undoing the partition
    apos = torch.clamp(apos, max=K - 1).long()
    alias_s = torch.gather(order, 1, apos)
    prob = torch.gather(prob_s, 1, inv.long())
    alias = torch.gather(alias_s, 1, inv.long()).to(torch.int32)
    if squeeze:
        prob, alias = prob[0], alias[0]
    return AliasTable(prob=prob, alias=alias)
