"""Sequential oracle for the split-based alias build (a copy of
``repro.kernels.alias_build.ref``): the one-pair-at-a-time pack sweep in
the order the closed-form rank arithmetic models, in float64, and the
per-category mass a (prob, alias) table induces.

And K13's three layouts as exact-order models of the card's fp32 adds
(:func:`assemble_block_order_torch`, :func:`assemble_group_order_torch`,
:func:`assemble_split_order_torch`): each forms ``cs`` and ``csL`` the
way its kernel does in ``csrc/alias_build.cu``, so the three give the
same (prob, apos) bit for bit.  Sums are float32 loops and ``where``s,
never ``torch.cumsum``, which on the CPU accumulates float32 in double.
"""

from __future__ import annotations

import numpy as np
import torch


def build_alias_tables_ref(weights):
    """(B, K) weights -> (prob, alias) numpy arrays via the sequential
    pack sweep (float64 accumulation)."""
    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        w = w[None, :]
    B, K = w.shape
    prob = np.ones((B, K), np.float64)
    alias = np.tile(np.arange(K, dtype=np.int32), (B, 1))
    for r in range(B):
        tot = w[r].sum()
        if tot <= 0:
            continue
        s = w[r] * (K / tot)
        lights = [k for k in range(K) if s[k] <= 1.0]
        heavies = [k for k in range(K) if s[k] > 1.0]
        nH = len(heavies)
        if nH == 0:
            continue
        j = 0
        res = s[heavies[0]]
        for li in lights:
            # cascade-finalize heavies whose residual dropped to <= 1
            while res <= 1.0 and j < nH:
                prob[r, heavies[j]] = res
                alias[r, heavies[j]] = heavies[min(j + 1, nH - 1)]
                if j + 1 < nH:
                    res = s[heavies[j + 1]] - (1.0 - res)
                j += 1
            if j >= nH:
                # rounding tail: deficit unfunded, keep own mass
                prob[r, li] = s[li]
                alias[r, li] = heavies[nH - 1]
                continue
            prob[r, li] = s[li]
            alias[r, li] = heavies[j]
            res -= 1.0 - s[li]
        while j < nH:
            prob[r, heavies[j]] = min(res, 1.0)
            alias[r, heavies[j]] = heavies[min(j + 1, nH - 1)]
            if j + 1 < nH:
                res = s[heavies[j + 1]] - (1.0 - min(res, 1.0))
            j += 1
    return prob, alias


def table_mass(prob, alias):
    """mass[c] = (prob[c] + sum_{alias[k] = c} (1 - prob[k])) / K: what the
    two-uniform draw gives category c; it must equal w / sum(w)."""
    prob = np.asarray(prob, np.float64)
    alias = np.asarray(alias)
    if prob.ndim == 1:
        prob, alias = prob[None, :], alias[None, :]
    B, K = prob.shape
    mass = prob.copy()
    for r in range(B):
        np.add.at(mass[r], alias[r], 1.0 - prob[r])
    return mass / K


def prob_tolerance(Kp: int) -> float:
    """Bound on |prob| differences between two implementations of the
    assembly on the same inputs: prob is a difference of prefix sums of
    magnitude up to Kp (``PL(i) + (cs - csL) - (i + j)``), and another
    summation order (XLA's scan, torch.cumsum, K13's chunked block scan)
    moves each sum by a few units in the last place of Kp; 32 such units,
    64 * Kp * 2**-24, bound it."""
    return 64 * Kp * 2.0 ** -24


# ---------------------------------------------------------------------------
# K13's layouts, add for add
# ---------------------------------------------------------------------------

_THREADS, _ITEMS = 256, 4
_CHUNK = _THREADS * _ITEMS  # columns a block-layout chunk


def _lane_sums(v: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 4): a thread's running sum of its four values from
    0.f, x[i] = x[i-1] + v[i]."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32)
    xs = []
    for i in range(_ITEMS):
        acc = acc + v[..., i]
        xs.append(acc)
    return torch.stack(xs, -1)


def _warp_scan(acc: torch.Tensor, width: int):
    """The shfl_up scan over the last dim in aligned segments of ``width``
    (<= 32) lanes: at each offset o < width, lane l adds lane l - o where
    l's place in its segment is >= o.  Returns (inclusive scan, the scan of
    lane l - 1: the shfl_up term, unused at a segment's first lane)."""
    seg = torch.arange(acc.shape[-1]) % width
    incl = acc
    for o in (1, 2, 4, 8, 16):
        if o < width:
            shifted = torch.cat([incl[..., :o], incl[..., :-o]], -1)
            incl = torch.where(seg >= o, incl + shifted, incl)
    return incl, torch.cat([incl[..., :1], incl[..., :-1]], -1)


def _xor_tree(light: torch.Tensor, width: int) -> torch.Tensor:
    """lane l += lane l ^ o for o = 16, 8, .., 1 with o < width: every lane
    of an aligned segment of ``width`` lanes ends with its segment's sum."""
    idx = torch.arange(light.shape[-1])
    for o in (16, 8, 4, 2, 1):
        if o < width:
            light = light + light[..., idx ^ o]
    return light


def _chain(start: torch.Tensor, terms: torch.Tensor) -> list:
    """[start, start + t0, (start + t0) + t1, ...]: the partial sums of a
    left-to-right chain over the last dim of ``terms``."""
    out = [start]
    for i in range(terms.shape[-1]):
        out.append(out[-1] + terms[..., i])
    return out


def _light_chains(v: torch.Tensor, k: torch.Tensor, nL: torch.Tensor) -> torch.Tensor:
    """(B, nc, slots, 4) values at columns k -> (B, slots): each slot's sum
    of its lights (k < nL), chunk by chunk and value by value in order."""
    light = torch.zeros(v.shape[0], v.shape[2], dtype=torch.float32)
    isl = k[None] < nL[:, None, None, None]
    for c in range(v.shape[1]):
        for i in range(_ITEMS):
            light = torch.where(isl[:, c, :, i], light + v[:, c, :, i], light)
    return light


def _assemble_with(s, nL, rank, cs, cs_at_gather, csL):
    """(prob, apos) from the row's cs at each position and at i - 1 (the
    heavies' gather, ``cs_at_gather(idx)``), as the kernels assemble."""
    B, Kp = s.shape
    pos = torch.arange(Kp, dtype=torch.int32).expand(B, Kp)
    nLc = nL[:, None].to(torch.int32)
    rank = rank.to(torch.int32)
    light = pos < nLc
    q = torch.clamp(nLc + (rank - pos), max=Kp - 1)
    j = pos - nLc
    i = torch.minimum(torch.clamp(rank - j, min=0), nLc)
    PLi = torch.where(i > 0, cs_at_gather(torch.clamp(i - 1, min=0).long()),
                      torch.zeros((), dtype=torch.float32))
    r = (PLi + (cs - csL[:, None])) - (i + j).to(torch.float32)
    prob = torch.where(light, torch.clamp(s, max=1.0), torch.clamp(r, 0.0, 1.0))
    apos = torch.where(light, q, torch.clamp(pos + 1, max=Kp - 1))
    return prob, apos.to(torch.int32)


def _inputs(s, nL, rank):
    return (torch.as_tensor(s, dtype=torch.float32), torch.as_tensor(nL).to(torch.int32),
            torch.as_tensor(rank).to(torch.int32))


def assemble_block_order_torch(s_sorted, nL, rank):
    """(prob, apos) as K13's block layout (one block of 256 threads a row)
    forms them: chunks of 1,024 columns (the last one padded with 0), four
    values a thread summed in order, the shfl_up warp scan, the warps'
    totals added to the carry in order, the shfl_up term for a warp's
    lanes after the first; the carry into the next chunk is the last
    thread's prefix plus its sum.  csL: each thread slot's lights in order
    across the chunks, an xor tree per warp, the warps' sums in order."""
    s, nL, rank = _inputs(s_sorted, nL, rank)
    B, Kp = s.shape
    nc = -(-Kp // _CHUNK)
    v = torch.nn.functional.pad(s, (0, nc * _CHUNK - Kp)).view(B, nc, _THREADS, _ITEMS)
    k = torch.arange(nc * _CHUNK).view(nc, _THREADS, _ITEMS)
    x = _lane_sums(v)
    acc = x[..., -1]
    incl, up = _warp_scan(acc, 32)
    wsum = incl[..., 31::32]
    lane = torch.arange(_THREADS) % 32
    carry = torch.zeros(B, dtype=torch.float32)
    cs = torch.empty(B, nc, _THREADS, _ITEMS, dtype=torch.float32)
    for c in range(nc):
        before = torch.stack(_chain(carry, wsum[:, c])[:8], -1).repeat_interleave(32, -1)
        before = torch.where(lane > 0, before + up[:, c], before)
        cs[:, c] = before[..., None] + x[:, c]
        carry = before[:, -1] + acc[:, c, -1]
    lw = _xor_tree(_light_chains(v, k, nL), 32)[:, ::32]
    csL = _chain(torch.zeros(B, dtype=torch.float32), lw)[-1]
    cs = cs.view(B, -1)[:, :Kp]
    return _assemble_with(s, nL, rank, cs, lambda idx: torch.gather(cs, 1, idx), csL)


def assemble_group_order_torch(s_sorted, nL, rank):
    """(prob, apos) as K13's group layout forms them (Kp a power of two
    from 4 to 1,024): L = Kp / 4 lanes a row, four values a lane summed in
    order, the shfl_up scan and the light xor tree over segments of
    min(L, 32) lanes, the group's warp totals added to 0 in order (L >=
    32); csL = 0 + the group's light sum (L < 32) or + each of its warps'
    sums in order."""
    s, nL, rank = _inputs(s_sorted, nL, rank)
    B, Kp = s.shape
    if not (4 <= Kp <= _CHUNK and Kp & (Kp - 1) == 0):
        raise ValueError(f"the group layout takes a power of two Kp in [4, {_CHUNK}], got {Kp}")
    L = Kp // _ITEMS
    width = min(L, 32)
    v = s.view(B, 1, L, _ITEMS)
    k = torch.arange(Kp).view(1, L, _ITEMS)
    x = _lane_sums(v[:, 0])
    incl, up = _warp_scan(x[..., -1], width)
    zero = torch.zeros(B, dtype=torch.float32)
    if L >= 32:
        before = torch.stack(_chain(zero, incl[..., 31::32])[:L // 32], -1)
        before = before.repeat_interleave(32, -1)
    else:
        before = zero[:, None].expand(B, L)
    before = torch.where(torch.arange(L) % width > 0, before + up, before)
    cs = (before[..., None] + x).reshape(B, Kp)
    light = _xor_tree(_light_chains(v, k, nL), width)
    csL = _chain(zero, light[:, ::32] if L >= 32 else light[:, :1])[-1]
    return _assemble_with(s, nL, rank, cs, lambda idx: torch.gather(cs, 1, idx), csL)


def assemble_split_order_torch(s_sorted, nL, rank):
    """(prob, apos) as K13's split layout forms them (Kp a multiple of
    1,024 above it): the walk gives per chunk each warp slot's scan total
    (slots 0..6) and the last slot's shfl_up term and sum, each slot's
    shfl_up term, and each warp slot's light sum (its slots' chains in
    chunk order, an xor tree); the chain adds the carries in the block
    layout's order; cs at a position is rebuilt as carry + the earlier
    warps' totals + the slot's shfl_up term (not at a warp's first lane) +
    the slot's sum up to it; csL = 0 + the warp slots' sums in order."""
    s, nL, rank = _inputs(s_sorted, nL, rank)
    B, Kp = s.shape
    if not (Kp > _CHUNK and Kp % _CHUNK == 0):
        raise ValueError(f"the split layout takes Kp a multiple of {_CHUNK} above it, got {Kp}")
    nc = Kp // _CHUNK
    v = s.view(B, nc, _THREADS, _ITEMS)
    k = torch.arange(Kp).view(nc, _THREADS, _ITEMS)
    # the walk
    x = _lane_sums(v)
    acc = x[..., -1]
    incl, U = _warp_scan(acc, 32)
    T = torch.cat([incl[..., 31:224:32], U[..., -1:], acc[..., -1:]], -1)  # (B, nc, 9)
    lw = _xor_tree(_light_chains(v, k, nL), 32)[:, ::32]
    # the chain
    carry = torch.empty(B, nc, dtype=torch.float32)
    cur = torch.zeros(B, dtype=torch.float32)
    for c in range(nc):
        carry[:, c] = cur
        cur = _chain(cur, T[:, c])[-1]
    csL = _chain(torch.zeros(B, dtype=torch.float32), lw)[-1]

    # the heavies' rebuild of cs at any positions p (B, n)
    def rebuild(p):
        c, t, e = p // _CHUNK, (p % _CHUNK) // _ITEMS, p % _ITEMS
        before = torch.gather(carry, 1, c)
        Tp = T[torch.arange(B)[:, None], c]  # (B, n, 9)
        for i in range(7):
            before = torch.where(i < t // 32, before + Tp[..., i], before)
        Up = U.reshape(B, -1)
        before = torch.where(t % 32 > 0, before + torch.gather(Up, 1, c * _THREADS + t), before)
        base = p - e
        xs = torch.zeros((), dtype=torch.float32) + torch.gather(s, 1, base)
        for m in range(1, _ITEMS):
            xs = torch.where(m <= e, xs + torch.gather(s, 1, base + m), xs)
        return before + xs

    cs = rebuild(torch.arange(Kp).expand(B, Kp))
    return _assemble_with(s, nL, rank, cs, rebuild, csL)
