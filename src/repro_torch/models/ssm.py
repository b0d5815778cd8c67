"""Mamba-2 SSD (state-space duality) blocks, the counterpart of
``repro.models.ssm``: the chunked form for train and prefill, and the
O(1)-state recurrent decode step.

Chunked SSD (Dao & Gu 2024): the sequence is split into chunks of Q;
within a chunk the dual quadratic (attention-like) form runs as einsums,
and the states are carried across chunks by a Python loop over the
chunks (the reference scans).  Decode keeps an (H, P, N) state and a
(width-1, channels) conv tail per layer, and writes both into the cache it
is given, in place.

The intra-chunk decay is ``exp`` of the masked log-decay differences:
the upper triangle is masked before the ``exp`` (to 0 after it), where the
reference masks after it.  The values are the same; the reference's
gradient is NaN wherever the masked ``exp`` overflows (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.dist.sharding import for_cache, per_shard
from repro_torch.models.layers import einsum, reshape, rmsnorm
from repro_torch.models.params import ParamSpec


def ssm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner = s.num_heads * s.head_dim
    gn = s.n_groups * s.state_dim
    return {
        "wz": ParamSpec((d, d_inner), ("embed", "mlp")),
        "wx": ParamSpec((d, d_inner), ("embed", "mlp")),
        "wb": ParamSpec((d, gn), ("embed", None)),
        "wc": ParamSpec((d, gn), ("embed", None)),
        "wdt": ParamSpec((d, s.num_heads), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((s.conv_width, d_inner), (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((s.conv_width, gn), (None, None), scale=0.5),
        "conv_c": ParamSpec((s.conv_width, gn), (None, None), scale=0.5),
        "a_log": ParamSpec((s.num_heads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((s.num_heads,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((s.num_heads,), ("ssm_heads",), init="zeros"),
        "out_norm": {"scale": ParamSpec((d_inner,), ("mlp",), init="ones")},
        "wout": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv.  x (B,S,C), w (width,C).
    state (B,width-1,C) or None (zero history).  Returns (y, new_state)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xs = torch.cat([state, x], dim=1)  # (B, S+width-1, C)
    y = sum(xs[:, i: i + x.shape[1], :] * w[i] for i in range(width))
    new_state = xs[:, -(width - 1):, :]
    return F.silu(y), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _project(params, x, cfg: ModelConfig):
    z = einsum("bsd,de->bse", x, params["wz"])
    xin = einsum("bsd,de->bse", x, params["wx"])
    b = einsum("bsd,de->bse", x, params["wb"])
    c = einsum("bsd,de->bse", x, params["wc"])
    dt_raw = einsum("bsd,dh->bsh", x, params["wdt"])
    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"].to(torch.float32))
    return z, xin, b, c, dt


def _heads(x, H, P):
    return reshape(x, (x.shape[0], x.shape[1], H, P))


def ssd_chunked(xh, bh, ch, dt, a_log, chunk: int):
    """Chunked SSD scan.

    xh (B,S,H,P) (weighted by dt inside); bh, ch (B,S,H,N); dt (B,S,H)
    float32; a_log (H,).  Returns y (B,S,H,P) float32 and the final state
    (B,H,P,N) float32.  DTensor operands run per shard (each rank its
    rows and heads; ``dist.sharding.per_shard``): DTensor has no rule for
    the ``flip`` of ``cumsum``'s backward on the card's PyTorch."""
    B, S, H, P = xh.shape
    N = bh.shape[-1]
    if any(hasattr(t, "full_tensor") for t in (xh, bh, ch, dt, a_log)):
        heads = ("batch", None, "heads", None)
        return per_shard(lambda *a: ssd_chunked(*a, chunk), (xh, bh, ch, dt, a_log),
                         (heads, heads, heads, ("batch", None, "heads"), ("heads",)),
                         [((B, S, H, P), heads), ((B, H, P, N), ("batch", "heads", None, None))])
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    A = -torch.exp(a_log.to(torch.float32))                  # (H,) negative
    loga = dt * A                                            # (B,S,H)
    lg = loga.reshape(B, nc, Q, H)
    cum = torch.cumsum(lg, dim=2)                            # (B,nc,Q,H)
    cum_last = cum[:, :, -1, :]                              # (B,nc,H)
    x_c = (xh * dt[..., None].to(xh.dtype)).reshape(B, nc, Q, H, P)
    b_c = bh.reshape(B, nc, Q, H, N)
    c_c = ch.reshape(B, nc, Q, H, N)

    # intra-chunk (dual quadratic form); t >= s kept, the rest exp(-inf) = 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H) t,s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff, float("-inf")))
    cb = einsum("bcqhn,bcshn->bcqsh", c_c, b_c).to(torch.float32)
    y_intra = einsum("bcqsh,bcshp->bcqhp", cb * decay, x_c.to(torch.float32))

    # chunk states: S_c = sum_s exp(cum_last - cum_s) * x_s B_s^T
    decay_to_end = torch.exp(cum_last[:, :, None, :] - cum)  # (B,nc,Q,H)
    s_c = einsum(
        "bcshn,bcshp->bchpn",
        b_c.to(torch.float32) * decay_to_end[..., None],
        x_c.to(torch.float32),
    )

    # carry across chunks
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(cum_last[:, c])[..., None, None] + s_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                     # (B,nc,H,P,N)

    # inter-chunk: y_t += (C_t * exp(cum_t)) . h_prev
    y_inter = einsum(
        "bcqhn,bchpn->bcqhp",
        c_c.to(torch.float32) * torch.exp(cum)[..., None],
        h_prev,
    )
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, h


def _repeat_groups(x, G, N, rep):
    return torch.repeat_interleave(_heads(x, G, N), rep, dim=2)


def ssm_block(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence SSD (train/prefill).  Returns (y, cache_out)."""
    s: SSMConfig = cfg.ssm
    H, P, N, G = s.num_heads, s.head_dim, s.state_dim, s.n_groups
    B, S0, _ = x.shape
    # front-pad to a chunk multiple: zero inputs leave the state untouched
    # (h = 0 decays to 0), so states and the final decode cache stay exact
    pad = (-S0) % min(s.chunk, max(S0, 1))
    if pad:
        x = F.pad(x, (0, 0, pad, 0))
    B, S, _ = x.shape
    z, xin, b, c, dt = _project(params, x, cfg)
    xin, conv_x_state = _causal_conv(xin, params["conv_x"], None)
    b, conv_b_state = _causal_conv(b, params["conv_b"], None)
    c, conv_c_state = _causal_conv(c, params["conv_c"], None)
    xh = _heads(xin, H, P)
    rep = H // G
    bh = _repeat_groups(b, G, N, rep)
    ch = _repeat_groups(c, G, N, rep)
    y, h_final = ssd_chunked(xh, bh, ch, dt, params["a_log"], s.chunk)
    y = y + params["d_skip"].to(torch.float32)[None, None, :, None] * xh.to(torch.float32)
    y = reshape(y, (B, S, H * P)).to(x.dtype)
    y = rmsnorm(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, params["wout"])
    if pad:
        out = out[:, pad:]
    cache_out = {
        "h": h_final.to(torch.float32),
        "conv_x": conv_x_state,
        "conv_b": conv_b_state,
        "conv_c": conv_c_state,
    }
    return out, cache_out


def ssm_decode_step(
    params, x: torch.Tensor, cache: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  x (B,1,D).  The new state and conv tails
    are written into ``cache`` in place (cast to its dtypes)."""
    s: SSMConfig = cfg.ssm
    H, P, N, G = s.num_heads, s.head_dim, s.state_dim, s.n_groups
    B = x.shape[0]
    z, xin, b, c, dt = _project(params, x, cfg)
    xin, conv_x_state = _causal_conv(xin, params["conv_x"], cache["conv_x"])
    b, conv_b_state = _causal_conv(b, params["conv_b"], cache["conv_b"])
    c, conv_c_state = _causal_conv(c, params["conv_c"], cache["conv_c"])
    xh = _heads(xin, H, P)[:, 0]                              # (B,H,P)
    rep = H // G
    bh = _repeat_groups(b, G, N, rep)[:, 0]                   # (B,H,N)
    ch = _repeat_groups(c, G, N, rep)[:, 0]
    dt0 = dt[:, 0]                                            # (B,H)
    A = -torch.exp(params["a_log"].to(torch.float32))
    da = torch.exp(dt0 * A)                                   # (B,H)
    h = cache["h"].to(torch.float32) * da[..., None, None] + einsum(
        "bhp,bhn->bhpn", xh.to(torch.float32) * dt0[..., None], bh.to(torch.float32))
    y = einsum("bhn,bhpn->bhp", ch.to(torch.float32), h)
    y = y + params["d_skip"].to(torch.float32)[None, :, None] * xh.to(torch.float32)
    y = reshape(y, (B, 1, H * P)).to(x.dtype)
    y = rmsnorm(params["out_norm"], y * F.silu(z), cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, params["wout"])
    for name, new in (("h", h), ("conv_x", conv_x_state), ("conv_b", conv_b_state),
                      ("conv_c", conv_c_state)):
        cache[name].copy_(for_cache(cache[name], new))
    return out, cache


def ssm_cache_spec(cfg: ModelConfig, batch: int) -> Dict[str, ParamSpec]:
    s: SSMConfig = cfg.ssm
    d_inner = s.num_heads * s.head_dim
    gn = s.n_groups * s.state_dim
    w = s.conv_width - 1
    return {
        "h": ParamSpec((batch, s.num_heads, s.head_dim, s.state_dim),
                       ("batch", "ssm_heads", None, None), init="zeros"),
        "conv_x": ParamSpec((batch, w, d_inner), ("batch", None, "mlp"), init="zeros"),
        "conv_b": ParamSpec((batch, w, gn), ("batch", None, None), init="zeros"),
        "conv_c": ParamSpec((batch, w, gn), ("batch", None, None), init="zeros"),
    }
