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
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import _act, einsum
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
    logits = einsum("Gtd,de->Gte", xg.to(torch.float32), params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    E = probs.shape[-1]
    assign1 = (ids[..., 0, None] == torch.arange(E, device=ids.device)).to(torch.float32)
    aux = E * torch.sum(assign1.mean((0, 1)) * probs.mean((0, 1)))
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, ids, aux + m.router_z_loss * zloss


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
    G, g, D = xg.shape
    E, k, C = m.num_experts, m.top_k, _capacity(g, m)
    gates, ids, aux = _route(params, xg, m)
    pos, assign = _positions(ids, E, k)
    keep = (pos < C).to(torch.float32)
    # one_hot of a position at or past C is all zeros, as jax.nn.one_hot's
    pos_oh = (pos.long()[..., None] == torch.arange(C, device=pos.device)).to(torch.float32)
    pos_oh = pos_oh * keep[..., None]
    dispatch = einsum("Gtke,Gtkc->Gtec", assign, pos_oh)            # (G,g,E,C)
    # combine weights each slot (e, c) by the gate of the (t, k) claiming it
    combine = einsum("Gtke,Gtkc,Gtk->Gtec", assign, pos_oh, gates)
    xd = einsum("Gtd,Gtec->Gecd", xg.to(torch.float32), dispatch)
    ex_in = xd.permute(1, 0, 2, 3).reshape(E, G * C, D).to(xg.dtype)
    out = _expert_ffn(params, ex_in, act)
    out = out.reshape(E, G, C, D).permute(1, 0, 2, 3)                # (G,E,C,D)
    y = einsum("Gecd,Gtec->Gtd", out.to(torch.float32), combine)
    return y.to(xg.dtype), aux


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
    xg = x.reshape(G, g, D)
    fn = _moe_einsum if dispatch_mode == "einsum" else _moe_gather
    y, aux = fn(params, xg, cfg.moe, cfg.act)
    return y.reshape(B, S, D), aux
