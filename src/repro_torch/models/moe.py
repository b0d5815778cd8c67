"""Mixture-of-Experts FFN: grouped top-k routing with capacity, two
dispatch modes, the counterpart of ``repro.models.moe``.

Tokens are routed in *groups* of ``group_tokens`` (Switch/GShard style):
capacity C = ceil(cf * group * k / E) is per group, so the dispatch and
combine intermediates scale as O(T * group * k * cf), bounded in sequence
length.

``einsum`` (the configs' default, GShard): one-hot dispatch/combine
tensors contracted with dense einsums.  ``gather``: position-in-expert by
the same cumsum, then an indexed write to dispatch and a gather to
combine.  Both keep the same tokens and drop the same ones: priority is
the flattened (token, choice) order within a group.

Routing is deterministic top-k, not sampling.

On a mesh (DTensor input) whose ``model`` degree divides the experts, the
``einsum`` dispatch runs per shard (:func:`_moe_per_shard`): each rank
routes its own tokens and fills only its own experts' slots, the experts
split over ``model`` as the ``experts`` rule splits their weights.  A
group that spans the ranks' rows (a decode step's) is ranked in the order
every rank's choices give, and its experts run with their weights in
place.  The ``gather`` dispatch, and experts that ``model`` does not
divide, run the code above on DTensors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.dist.sharding import (activation_layout, from_local_block, local_block,
                                      mesh_of, model_dim, named_sharding, shard_offset)
from repro_torch.models.layers import _act, einsum, reshape
from repro_torch.models.params import ParamSpec


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m: MoEConfig = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.expert_d_ff
    return {
        "router": ParamSpec((d, e), ("embed", None), scale=0.02),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }


def _group(T: int, m: MoEConfig) -> Tuple[int, int]:
    g = min(m.group_tokens, T)
    while T % g:
        g //= 2
    return T // g, g


def _capacity(g: int, m: MoEConfig) -> int:
    return max(int(np.ceil(m.capacity_factor * g * m.top_k / m.num_experts)), 1)


def _route(params, xg, m: MoEConfig):
    """xg (G, g, D) -> gates (G, g, k), ids (G, g, k), aux loss (0-d)."""
    gates, ids, logits, probs = _router(params["router"], xg, m)
    return gates, ids, _aux_loss(_router_stats(logits, probs, ids), m)


def _router_stats(logits, probs, ids):
    """The means over the groups' tokens that the aux loss takes: each
    expert's share of first choices, its mean probability (E each) and the
    mean squared log-sum-exp of the logits (1)."""
    E = probs.shape[-1]
    assign1 = (ids[..., 0, None] == torch.arange(E, device=ids.device)).to(torch.float32)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return torch.cat([assign1.mean((0, 1)), probs.mean((0, 1)), zloss[None]])


def _aux_loss(stats, m: MoEConfig):
    """The load-balancing loss plus the router z-loss from
    :func:`_router_stats`."""
    E = (stats.shape[0] - 1) // 2
    aux = E * torch.sum(stats[:E] * stats[E:2 * E])
    return aux + m.router_z_loss * stats[-1]


def _router(router, xg, m: MoEConfig):
    """xg (G, g, D) -> gates (G, g, k) (the top-k probabilities,
    renormalised), ids (G, g, k), the router's float32 logits and
    probabilities (G, g, E)."""
    logits = einsum("Gtd,de->Gte", xg.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, ids, logits, probs


def _positions(ids, E: int, k: int):
    """Rank of each (token, choice) within its expert, per group.
    ids (G, g, k) -> pos (G, g, k) float32, assign (G, g, k, E) float32."""
    G, g, _ = ids.shape
    assign = (ids[..., None] == torch.arange(E, device=ids.device)).to(torch.float32)
    flat = assign.reshape(G, g * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, k, E)
    pos = torch.sum(pos * assign, dim=-1)
    return pos, assign


def _expert_ffn(params, xd, act: str):
    """xd (E, N, D) -> (E, N, D)."""
    gate = _act(act)(einsum("end,edf->enf", xd, params["w_gate"]))
    up = einsum("end,edf->enf", xd, params["w_up"])
    return einsum("enf,efd->end", gate * up, params["w_down"])


def _moe_einsum(params, xg, m: MoEConfig, act: str):
    """GShard-style one-hot dispatch.  xg (G, g, D)."""
    gates, ids, aux = _route(params, xg, m)
    y = _dispatch(params, xg, gates, ids, m.num_experts, 0, _capacity(xg.shape[1], m), act)
    return y.to(xg.dtype), aux


def _one_hot(idx, n: int):
    """float32 one-hot of a float32 index tensor over ``n``: an index at or
    past ``n`` gives all zeros, as ``jax.nn.one_hot``'s."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _dispatch(weights, xg, gates, ids, E: int, e0: int, C: int, act: str):
    """The one-hot dispatch of xg (G, g, D) into the slots of experts e0
    ... e0 + E - 1 (their stacked ``weights``), capacity C, the experts run
    on their slots and the combine; another expert's choice dispatches
    nothing.  Returns the combine (G, g, D), float32."""
    G, g, D = xg.shape
    pos, assign = _positions(ids - e0, E, ids.shape[-1])
    pos_oh = _one_hot(pos, C) * (pos < C).to(torch.float32)[..., None]
    dispatch = einsum("Gtke,Gtkc->Gtec", assign, pos_oh)            # (G,g,E,C)
    # combine weights each slot (e, c) by the gate of the (t, k) claiming it
    combine = einsum("Gtke,Gtkc,Gtk->Gtec", assign, pos_oh, gates)
    xd = einsum("Gtd,Gtec->Gecd", xg.to(torch.float32), dispatch)
    ex_in = xd.permute(1, 0, 2, 3).reshape(E, G * C, D).to(xg.dtype)
    out = _expert_ffn(weights, ex_in, act)
    out = out.reshape(E, G, C, D).permute(1, 0, 2, 3)                # (G,E,C,D)
    return einsum("Gecd,Gtec->Gtd", out.to(torch.float32), combine)


def _moe_gather(params, xg, m: MoEConfig, act: str):
    """Indexed dispatch and gather combine: no one-hot contractions."""
    G, g, D = xg.shape
    E, k, C = m.num_experts, m.top_k, _capacity(g, m)
    gates, ids, aux = _route(params, xg, m)
    pos, _ = _positions(ids, E, k)
    pos = pos.long()
    keep = pos < C
    slot = torch.where(keep, ids * C + pos, torch.full_like(pos, E * C))   # (G,g,k)
    flat = slot.reshape(G, g * k)
    gi = torch.arange(G, device=xg.device)[:, None].expand(G, g * k)
    # row t * k + j of the flattened choices carries token t; every dropped
    # choice lands on the spare row E * C, which no expert reads
    xd = torch.zeros((G, E * C + 1, D), dtype=xg.dtype, device=xg.device)
    xd = xd.index_put((gi, flat), xg.repeat_interleave(k, dim=1))
    ex_in = xd[:, : E * C, :].reshape(G, E, C, D).permute(1, 0, 2, 3).reshape(E, G * C, D)
    out = _expert_ffn(params, ex_in, act)
    out = out.reshape(E, G, C, D).permute(1, 0, 2, 3).reshape(G, E * C, D)
    out = torch.cat([out, torch.zeros((G, 1, D), dtype=out.dtype, device=out.device)], dim=1)
    w = (gates * keep).to(out.dtype)                                  # (G,g,k)
    gathered = out[gi, flat].reshape(G, g, k, D)
    y = einsum("Gtkd,Gtk->Gtd", gathered.to(torch.float32), w.to(torch.float32))
    return y.to(xg.dtype), aux


def moe_block(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    dispatch_mode: str = "einsum",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y (B,S,D), aux_loss 0-d)."""
    B, S, D = x.shape
    G, g = _group(B * S, cfg.moe)
    mesh = mesh_of(x, *params.values())
    if dispatch_mode == "einsum" and mesh is not None:
        md = model_dim(mesh)
        if md is not None and cfg.moe.num_experts % mesh.size(md) == 0:
            return _moe_per_shard(params, x, cfg, mesh, md)
    xg = reshape(x, (G, g, D))
    fn = _moe_einsum if dispatch_mode == "einsum" else _moe_gather
    y, aux = fn(params, xg, cfg.moe, cfg.act)
    return reshape(y, (B, S, D)), aux


def _moe_per_shard(params, x, cfg: ModelConfig, mesh, md: int):
    """The ``einsum`` dispatch on local tensors, the experts split over
    ``model`` (mesh dim ``md``).  Each rank takes its rows with every
    position (``x`` gathered over ``model``), routes its own tokens and
    fills only its own E/N experts' slots: where its rows hold whole
    groups, each group on its own (:func:`_local_groups`), else, as in a
    decode step whose one group is the whole batch, in the groups' order
    that every rank's choices give (:func:`_spanning_groups`).  The
    combine's outputs are partial sums over ``model`` in float32,
    reduce-scattered to the positions over ``model`` where they divide,
    else all-reduced.  The aux loss takes its means over every token: each
    rank adds its share of its tokens' means, one all-reduce of 2E + 1
    floats.

    Gradients: ``x``'s and the router's come back as partial sums over
    ``model`` (a rank's experts' part; the router's also over the data
    axes that split the rows), the experts' split over ``model``.  The
    values match the unsharded path within float32 rounding (the combine
    sums its experts in another order), not bit for bit."""
    from torch.distributed.tensor import Partial, Replicate

    m = cfg.moe
    B, S, D = x.shape
    G, g = _group(B * S, m)
    E, n = m.num_experts, mesh.size(md)
    rows, out = activation_layout(x.shape, mesh)
    split = [p.is_shard() for p in rows]           # the data dims that split the rows
    ways = math.prod(mesh.size(d) for d, s in enumerate(split) if s)
    summed = [Partial() if d == md or s else Replicate() for d, s in enumerate(split)]
    part = [Partial() if d == md else p for d, p in enumerate(rows)]
    xl = local_block(x, mesh, rows, part)
    router = local_block(params["router"], mesh, [Replicate()] * mesh.ndim, summed)
    T = xl.shape[0] * S                            # this rank's tokens
    spans = T % g != 0
    xg = xl.reshape(1, T, D) if spans else xl.reshape(T // g, g, D)
    gates, ids, logits, probs = _router(router, xg, m)
    # each rank adds its tokens' means with the weight that makes the sum
    # over the ranks that hold partial sums the mean over every token
    stats = from_local_block(_router_stats(logits, probs, ids) / (n * ways), mesh, summed,
                             (2 * E + 1,))
    aux = _aux_loss(stats.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(), m)
    e0 = mesh.get_coordinate()[md] * (E // n)
    if spans:
        y = _spanning_groups(params, xg[0], gates[0], ids[0], cfg, mesh, md, split, G, g, e0)
    else:
        y = _local_groups(params, xg, gates, ids, cfg, mesh, md, summed, e0)
    y = from_local_block(y.reshape(xl.shape), mesh, part, (B, S, D)).redistribute(mesh, out)
    return y.to(x.dtype), from_local_block(aux, mesh, [Replicate()] * mesh.ndim, ())


_EXPERT_WEIGHTS = (("w_gate", 1), ("w_up", 1), ("w_down", 2))   # and each one's embed dim


def _local_groups(params, xg, gates, ids, cfg: ModelConfig, mesh, md: int, summed, e0: int):
    """The dispatch of the groups a rank's rows hold whole, xg (G_l, g, D),
    into its own E/N experts (:func:`_dispatch`), each expert shard
    gathered along ``embed`` only (FSDP).  Returns the combine (G_l, g,
    D), float32 partial sums over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    m = cfg.moe
    El = m.num_experts // mesh.size(md)
    experts = [Shard(0) if d == md else Replicate() for d in range(mesh.ndim)]
    grad = [Shard(0) if d == md else q for d, q in enumerate(summed)]
    weights = {w: local_block(params[w], mesh, experts, grad) for w, _ in _EXPERT_WEIGHTS}
    return _dispatch(weights, xg, gates, ids, El, e0, _capacity(xg.shape[1], m), cfg.act)


def _spanning_groups(params, xt, gates, ids, cfg: ModelConfig, mesh, md: int, split,
                     G: int, g: int, e0: int):
    """The dispatch where a rank's rows hold part of a group (a decode
    step: one group of the whole batch), xt (T_l, D), gates and ids (T_l,
    k): every rank's choices are gathered over the data axes that split
    the rows (integers, (T, k)), so each rank ranks its own tokens' choices
    in their groups' order; it dispatches its own tokens into its experts'
    slots of every group, (T_l, E/N, G C), runs the experts on the slots'
    sums over those axes with the weights in place
    (:func:`_stationary_ffn`) and combines its own tokens.  Returns (T_l,
    D), float32 partial sums over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    m = cfg.moe
    Tl, D = xt.shape
    k, El, C = m.top_k, m.num_experts // mesh.size(md), _capacity(g, m)
    rows = [Shard(0) if s else Replicate() for s in split]
    every = from_local_block(ids, mesh, rows, (G * g, k)).full_tensor().reshape(G, g, k)
    t0, _ = shard_offset(G * g, 0, mesh, rows)
    own = slice(t0, t0 + Tl)
    pos, assign = _positions(every - e0, El, k)
    pos, assign = pos.reshape(G * g, k)[own], assign.reshape(G * g, k, El)[own]
    group = torch.arange(t0, t0 + Tl, device=xt.device) // g
    slot = _one_hot(pos + C * group[:, None], G * C) * (pos < C).to(torch.float32)[..., None]
    dispatch = einsum("tke,tks->tes", assign, slot)                 # (T_l,E/N,G C)
    combine = einsum("tke,tks,tk->tes", assign, slot, gates)
    xd = einsum("td,tes->esd", xt.to(torch.float32), dispatch)
    y = _stationary_ffn(params, xd, cfg.act, mesh, md, split, xt.dtype)
    return einsum("esd,tes->td", y.to(torch.float32), combine)


def _stationary_ffn(params, xd, act: str, mesh, md: int, split, dtype):
    """The experts on slots that the ranks along the data dims ``split``
    fill in part, ``xd`` (E/N, slots, D) float32, this rank's partial sums,
    with the weights where the ``embed`` rule puts them: the slots are
    reduce-scattered to this rank's columns of D (all-reduced along a dim
    that does not split D), each rank contracts its columns, the gate and
    up products are all-reduced in float32 and the down product's columns
    all-gathered.  So a rank does its share of its experts' work and moves
    activations, not weights.  Returns (E/N, slots, D), whole on every
    rank; the weights' gradients come back split as the weights are."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    El, N, D = xd.shape
    E, F = El * mesh.size(md), params["w_gate"].shape[-1]
    rule = named_sharding((E, D, F), ("experts", "embed", "mlp"), mesh).placements
    stay = [s and rule[d].is_shard(1) for d, s in enumerate(split)]

    def pl(at_stay, at_split):
        """Placements: the experts over ``model``, ``at_stay`` on the dims
        that split the rows and D, ``at_split`` on those that split the
        rows only, replicated elsewhere."""
        return [Shard(0) if d == md else at_stay if stay[d] else at_split if split[d]
                else Replicate() for d in range(mesh.ndim)]

    def whole(t, at_stay, shape):
        """A partial (or column-split) product made whole on every rank, in
        ``dtype``."""
        t = from_local_block(t, mesh, pl(at_stay, Replicate()), shape)
        return local_block(t, mesh, pl(Replicate(), Replicate()),
                           pl(Partial(), Partial())).to(dtype)

    xs = local_block(from_local_block(xd, mesh, pl(Partial(), Partial()), (E, N, D)), mesh,
                     pl(Shard(2), Replicate()), pl(Shard(2), Partial())).to(dtype)
    w = {name: local_block(params[name], mesh, pl(Shard(dim), Replicate()),
                           pl(Shard(dim), Partial())) for name, dim in _EXPERT_WEIGHTS}
    gate, up = (whole(einsum("end,edf->enf", xs, w[name]).to(torch.float32), Partial(),
                      (E, N, F)) for name in ("w_gate", "w_up"))
    y = einsum("enf,efd->end", _act(act)(gate) * up, w["w_down"])
    return whole(y, Shard(2), (E, N, D))
