"""Walker/Vose alias method (paper §6 related work), the counterpart of
``repro.core.alias``.

Vose's build pairs the entries of two worklists, smalls (scaled weight
< 1) and larges, both in index order; a large whose leftover drops below
1 moves to the end of the small list.  The reference writes it as a
``lax.while_loop`` per row in float32 (:func:`build_alias_tables`) and as
a row-vectorized numpy loop in float64 (:func:`build_alias_tables_host`).
Here both are one row-vectorized loop, advancing every unfinished row by
one (small, large) pair per step, in the reference's pairing order and in
its dtype, so the tables equal the reference's: ``alias`` and ``prob``
alike.  The scale ``K / total`` is one division of two tensors, as the
reference's.  K steps per row are sequential by nature (about
10 small PyTorch ops each).

Draws are O(1): one uniform picks a column, a second keeps it or takes
its alias.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import fake as _fake


class AliasTable(NamedTuple):
    prob: torch.Tensor   # (..., K) acceptance probability of the home column
    alias: torch.Tensor  # (..., K) fallback index


def _vose(scaled: torch.Tensor, ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pairing sweep on (B, K) scaled weights (mean 1 per row); rows
    with ``ok`` False keep prob 1 and alias = own index."""
    B, K = scaled.shape
    dev = scaled.device
    s = scaled.clone()
    prob = torch.ones_like(s)
    alias = torch.arange(K, dtype=torch.int32, device=dev).repeat(B, 1)
    small_mask = s < 1.0
    # worklists in index order: smalls first / larges first (stable sorts);
    # the small list has room for the larges demoted onto it
    small = torch.argsort((~small_mask).to(torch.int8), dim=1, stable=True)
    small = torch.cat([small, torch.zeros_like(small)], dim=1)
    large = torch.argsort(small_mask.to(torch.int8), dim=1, stable=True)
    n_small = small_mask.sum(dim=1)
    n_large = K - n_small
    si = torch.zeros(B, dtype=torch.int64, device=dev)
    li = torch.zeros_like(si)
    rows = torch.arange(B, device=dev)
    while True:
        active = (si < n_small) & (li < n_large) & ok
        r = rows[active]
        if r.numel() == 0:
            break
        sidx = small[r, si[r]]
        lidx = large[r, li[r]]
        ps = s[r, sidx]
        prob[r, sidx] = ps
        alias[r, sidx] = lidx.to(torch.int32)
        leftover = s[r, lidx] - (1.0 - ps)
        s[r, lidx] = leftover
        demote = leftover < 1.0
        rd = r[demote]
        small[rd, n_small[rd]] = lidx[demote]
        n_small[r] += demote
        li[r] += demote
        si[r] += 1
    return prob, alias


def build_alias_tables(weights) -> AliasTable:
    """Vose's build over a (B, K) batch in float32, with the arithmetic of
    the reference's ``lax.while_loop`` builder: scaled = w * (K / sum(w))
    (a zero row scales to NaN, has no smalls and keeps prob 1)."""
    w = torch.as_tensor(weights).to(torch.float32)
    K = w.shape[-1]
    tot = w.sum(dim=-1, keepdim=True)
    # a tensor over a tensor rounds once, as the reference's K / sum(w);
    # a Python scalar over a tensor is reciprocal-then-multiply in PyTorch
    scaled = w * (torch.tensor(float(K), dtype=tot.dtype, device=tot.device) / tot)
    ok = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
    prob, alias = _vose(scaled, ok)
    return AliasTable(prob=prob, alias=alias)


def build_alias_table(weights) -> AliasTable:
    """Vose's build for one distribution (1-D weights)."""
    t = build_alias_tables(torch.as_tensor(weights)[None, :])
    return AliasTable(prob=t.prob[0], alias=t.alias[0])


def build_alias_tables_host(weights) -> AliasTable:
    """The reference's host builder: the same pairing in float64 on the
    CPU (zero-total rows scale to all ones), prob returned as float32 on
    the weights' device."""
    w0 = torch.as_tensor(weights)
    if w0.dim() != 2:
        raise ValueError(f"expected (B, K) weights, got shape {tuple(w0.shape)}")
    _fake.require_real(w0, "the host alias build (Vose's pairing)")
    w = w0.detach().cpu().to(torch.float64)
    K = w.shape[1]
    tot = w.sum(dim=1, keepdim=True)
    ok = tot > 0
    Kt = torch.tensor(float(K), dtype=tot.dtype)
    s = torch.where(ok, w * (Kt / torch.where(ok, tot, torch.ones_like(tot))), 1.0)
    prob, alias = _vose(s, ok[:, 0])
    return AliasTable(prob=prob.to(torch.float32).to(w0.device), alias=alias.to(w0.device))


def draw_alias(table: AliasTable, generator: Optional[torch.Generator] = None,
               shape=()) -> torch.Tensor:
    """O(1) draws from one prebuilt table."""
    K = table.prob.shape[0]
    dev = table.prob.device
    k = torch.randint(0, K, shape, generator=generator, device=dev)
    u = torch.rand(shape, generator=generator, device=dev)
    return torch.where(u < table.prob[k], k, table.alias[k].long()).to(torch.int32)


def draw_alias_batch(tables: AliasTable, generator: Optional[torch.Generator] = None,
                     u=None) -> torch.Tensor:
    """One draw per row of a (B, K) batch of tables.  The column and the
    coin come from ``generator``, or from ``u = (u_col, u_coin)``, two (B,)
    uniforms: column ``min(floor(u_col * K), K - 1)``, kept iff
    ``u_coin < prob``."""
    B, K = tables.prob.shape
    dev = tables.prob.device
    if u is None:
        k = torch.randint(0, K, (B,), generator=generator, device=dev)
        coin = torch.rand((B,), generator=generator, device=dev)
    else:
        u_col, coin = (torch.as_tensor(x, device=dev).to(torch.float32) for x in u)
        k = torch.clamp((u_col * K).to(torch.int64), max=K - 1)
    home = torch.gather(tables.prob, 1, k[:, None])[:, 0]
    ali = torch.gather(tables.alias, 1, k[:, None])[:, 0]
    return torch.where(coin < home, k, ali.long()).to(torch.int32)
