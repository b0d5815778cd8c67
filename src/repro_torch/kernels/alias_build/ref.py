"""Sequential oracle for the split-based alias build (a copy of
``repro.kernels.alias_build.ref``): the one-pair-at-a-time pack sweep in
the order the closed-form rank arithmetic models, in float64, and the
per-category mass a (prob, alias) table induces."""

from __future__ import annotations

import numpy as np


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
