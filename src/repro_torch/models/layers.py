"""Shared neural layers: norms, RoPE, MLPs, embeddings, the counterpart of
``repro.models.layers``.

All layers are pure functions over ParamSpec-declared params; norms and
softmax accumulate in float32.  Operands of mixed dtypes are promoted as
JAX promotes them (bfloat16 with float32 gives float32): :func:`einsum`
casts both sides first, where ``torch.einsum`` would refuse.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import gather_dim
from repro_torch.models.params import ParamSpec


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's promotion of mixed operand dtypes."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o if o.dtype == dt else o.to(dt) for o in ops))


def remat_layer(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint`` (recomputed in the backward
    pass) for ``remat`` "full" or "dots" while gradients are recorded,
    else ``fn``: the stacks' counterpart of the reference's
    ``jax.checkpoint`` around each layer."""
    if remat in ("full", "dots") and torch.is_grad_enabled():
        return partial(checkpoint, fn, use_reentrant=False)
    return fn


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def head_rmsnorm_spec(head_dim: int) -> Dict[str, ParamSpec]:
    """qk-norm (Qwen3): per-head RMSNorm over head_dim."""
    return {"scale": ParamSpec((head_dim,), ("head",), init="ones")}


head_rmsnorm = rmsnorm   # the same arithmetic over the last (head_dim) axis


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) or (B, S, D); positions: (S,) shared across batch,
    or (B, S) per-row (continuous batching: every slot decodes at its own
    sequence position)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)              # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., S, D/2)
    if x.dim() == 4:                                                 # add heads axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int) -> Dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def mlp(params, x, act: str = "silu"):
    g = _act(act)(einsum("...d,df->...f", x, params["w_gate"]))
    u = einsum("...d,df->...f", x, params["w_up"])
    return einsum("...f,fd->...d", g * u, params["w_down"])


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d_model: int) -> Dict[str, ParamSpec]:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens, scale: bool = False):
    """Rows of the table.  A vocab-sharded DTensor table is gathered along
    the vocab first: DTensor's lookup on a vocab shard gives a masked
    partial whose mask a later op with a cached sharding decision applies
    to a tensor of another shape (ROADMAP.md, deliberate differences)."""
    table = gather_dim(params["table"], 0)
    x = table[tokens.long()]
    if scale:
        # sqrt(float32(D)) cast to the table's dtype, then the multiply (a
        # host float holding that value exactly)
        s = torch.sqrt(torch.tensor(float(table.shape[-1]), dtype=torch.float32))
        x = x * float(s.to(x.dtype))
    return x


def unembed_spec(vocab: int, d_model: int) -> Dict[str, ParamSpec]:
    return {"table": ParamSpec((d_model, vocab), ("embed", "vocab"))}


def unembed(params, x, tied_table=None, softcap: float = 0.0):
    """Project to vocab logits (kept in compute dtype).  ``tied_table``
    (V, D) overrides; the softcap is computed in float32 and cast back."""
    if tied_table is not None:
        logits = einsum("...d,vd->...v", x, tied_table)
    else:
        logits = einsum("...d,dv->...v", x, params["table"])
    if softcap > 0:
        logits = (torch.tanh(logits.to(torch.float32) / softcap) * softcap).to(logits.dtype)
    return logits


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x
