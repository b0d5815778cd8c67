"""Optimizers, the counterpart of ``repro.train.optimizer``: AdamW (float32
state), 8-bit AdamW (blockwise-quantized moments) and Adafactor (factored
second moment).

All share one interface:
    opt = make_optimizer(name, lr=..., **kw)
    state = opt.init(params)            # or opt.state_specs(param_specs)
    params, state = opt.update(grads, params, state, step)

Parameters, gradients and states are trees of tensors (nested dicts, one
state dict per parameter leaf), as the reference's are pytrees, so a
checkpoint reads them the same way.  ``update`` returns new tensors.

The arithmetic rounds as the reference's does op by op: the schedule and
the bias corrections are float32 scalars, every division divides by a
tensor (PyTorch divides by a host scalar through its reciprocal on the
card, which rounds twice) and square roots are correctly rounded, so the
moments, and the 8-bit codes and scales, equal the reference's run op by
op for equal gradients.  (Under ``jit`` XLA contracts multiply-adds and
turns a division by a constant into a product with its reciprocal, so the
reference's own jitted step differs from itself op by op in the last
bit.)
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.params import tree_map

QBLOCK = 256  # 8-bit moment quantization block size


class Optimizer(NamedTuple):
    init: Callable
    update: Callable                 # (grads, params, state, step) -> (params, state)
    state_specs: Callable            # (param_specs) -> tree of meta tensors


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _schedule(step, lr, warmup=2000, total=100_000, min_ratio=0.1) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_ratio``: a 0-d float32
    tensor on the CPU."""
    step = _f32(int(step))
    warm = torch.clamp_max(step / _f32(max(warmup, 1)), 1.0)
    prog = torch.clamp((step - warmup) / _f32(max(total - warmup, 1)), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return lr * warm * (min_ratio + (1 - min_ratio) * cos)


def _leafwise(fn, grads, params, state):
    """``fn(g, p, s) -> (new_p, new_s)`` at every parameter leaf (``state``
    holds one dict per parameter leaf); returns (params, state) trees."""
    if isinstance(params, dict):
        out = {k: _leafwise(fn, grads[k], params[k], state[k]) for k in sorted(params)}
        return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}
    return fn(grads, params, state)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  PyTorch's vectorized sqrt on
    the CPU is not (one ulp off on ~0.6% of inputs on an AVX-512 host), so
    there it rounds the float64 root; the card's sqrt is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a float32 host scalar ``b``, divided once (a 0-d
    tensor on ``a``'s device, made by a fill: no host copy)."""
    return a / a.new_full((), b)


# ---------------------------------------------------------------------------
# 8-bit blockwise quantization of moments
# ---------------------------------------------------------------------------


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    return F.pad(flat, (0, (-flat.numel()) % QBLOCK)).reshape(-1, QBLOCK)


def _q8(x: torch.Tensor):
    """Quantize to int8 with per-block absmax scales.  x flattened."""
    return _per_block_shard(_q8_whole, x)


def _q8_whole(x: torch.Tensor):
    blocks = _blocks(x.reshape(-1))
    scale = _div(torch.amax(torch.abs(blocks), dim=1, keepdim=True), 127.0)
    q = torch.round(blocks / torch.clamp_min(scale, 1e-20)).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return _from_block_shard(_dq8_whole, q, scale, shape)


def _dq8_whole(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[: int(np.prod(shape))].reshape(shape)


def _q8_sqrt(v: torch.Tensor):
    """Unsigned 8-bit quantization of the *square root* of a non-negative
    tensor.  Storing sqrt(v) halves the dynamic range, so small second
    moments don't collapse to zero (which would explode m/sqrt(v)
    updates)."""
    return _per_block_shard(_q8_sqrt_whole, v)


def _q8_sqrt_whole(v: torch.Tensor):
    blocks = _blocks(_sqrt(torch.clamp_min(v, 0.0)).reshape(-1))
    scale = _div(torch.amax(blocks, dim=1, keepdim=True), 255.0)
    q = torch.round(blocks / torch.clamp_min(scale, 1e-20)).to(torch.uint8)
    return q, scale.to(torch.float32)


def _dq8_sqrt(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return _from_block_shard(_dq8_sqrt_whole, q, scale, shape)


def _dq8_sqrt_whole(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return torch.square(flat[: int(np.prod(shape))].reshape(shape))


# ---------------------------------------------------------------------------
# 8-bit moments of DTensor leaves
# ---------------------------------------------------------------------------
#
# The blocks follow the global row-major flatten of a leaf, as the
# reference's do.  The ``qblocks`` rule splits a state's blocks over the
# data axes; a leaf whose rows split over the same mesh dims into whole
# blocks a rank (arctic's (32000, 7168) table: 2,000 rows, 56,000 blocks
# a data rank) is quantized on each rank's rows, with no other
# communication than placing the leaf so.  The card's PyTorch cannot
# flatten a leaf whose sharded dim is not its first.


def _block_rows(shape, mesh):
    """The state's sharding of a leaf of ``shape`` (the ``qblocks`` rule)
    and the placements that give each rank the rows whose flatten is its
    blocks (``Shard(0)`` over the mesh dims that split the blocks), or
    None where no such split exists."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import is_sharded, named_sharding

    n = int(np.prod(shape))
    state = named_sharding((-(-n // QBLOCK), QBLOCK), ("qblocks", None), mesh)
    ways = int(np.prod([mesh.size(m) for m, p in enumerate(state.placements) if p.is_shard(0)]))
    rows = None
    if is_sharded(state) and len(shape) and shape[0] % ways == 0 and n % (QBLOCK * ways) == 0:
        rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in state.placements)
    return state, rows, ways


def _placed_as(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t`` placed as the parameter ``p``: a DTensor redistributed to
    ``p``'s placements (a gradient that DTensor's backward left partial is
    reduce-scattered), or made a tensor where ``p`` is one.  The 8-bit
    moments come back by rows or whole, so without this the update's
    ops would pick placements of their own, a partial one among them,
    that the weight decay's parameter cannot take on the card's
    PyTorch."""
    if not hasattr(t, "full_tensor"):
        return t
    if not hasattr(p, "full_tensor"):
        return t.full_tensor()
    if tuple(t.placements) == tuple(p.placements):
        return t
    return t.redistribute(p.device_mesh, p.placements)


def _as_dtensor(t: torch.Tensor, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _per_block_shard(fn, x: torch.Tensor):
    """``fn(x) -> (codes, scales)``; a DTensor ``x`` quantized on each
    rank's rows (:func:`_block_rows`) into codes and scales placed as the
    ``qblocks`` rule places the state.  Where no rank's rows are whole
    blocks the leaf is gathered whole first (an all-gather the dry-run
    counts) and each rank keeps its blocks."""
    if not hasattr(x, "full_tensor"):
        return fn(x)
    from repro_torch.dist.sharding import local_shard

    mesh = x.device_mesh
    state, rows, _ = _block_rows(tuple(x.shape), mesh)
    if rows is not None:
        q, s = fn(x.redistribute(mesh, rows).to_local())
    else:   # no split of the flatten into whole blocks a rank: gathered whole
        q, s = fn(x.full_tensor())
        q, s = local_shard(q, state), local_shard(s, state)
    nb = -(-x.numel() // QBLOCK)
    return (_as_dtensor(q, mesh, state.placements, (nb, QBLOCK)),
            _as_dtensor(s, mesh, state.placements, (nb, 1)))


def _from_block_shard(fn, q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """``fn(q, scale, shape)``; DTensor codes placed as the ``qblocks``
    rule places them give each rank's rows of the leaf (placed as
    :func:`_block_rows` gives them), or, where no rank's blocks are whole
    rows, the leaf whole on every rank (the codes gathered)."""
    if not hasattr(q, "full_tensor"):
        return fn(q, scale, shape)
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    shape = tuple(shape)
    state, rows, ways = _block_rows(shape, mesh)
    if rows is not None and tuple(q.placements) == tuple(scale.placements) == state.placements:
        local = (shape[0] // ways,) + shape[1:]
        return _as_dtensor(fn(q.to_local(), scale.to_local(), local), mesh, rows, shape)
    whole = fn(q.full_tensor(), scale.full_tensor(), shape)
    return _as_dtensor(whole, mesh, [Replicate()] * mesh.ndim, shape)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# AdamW family
# ---------------------------------------------------------------------------


def make_adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    warmup: int = 2000,
    total_steps: int = 100_000,
    bits8: bool = False,
) -> Optimizer:
    def init_leaf(p):
        zero = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if bits8:
            mq, ms = _q8(zero)
            vq, vs = _q8_sqrt(zero)
            return {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
        return {"m": zero, "v": zero.clone()}

    def init(params):
        return tree_map(init_leaf, params)

    def update(grads, params, state, step):
        lr_t = float(_schedule(step, lr, warmup, total_steps))
        t = _f32(int(step)) + 1
        bc1 = float(1 - b1 ** t)
        bc2 = float(1 - b2 ** t)

        def upd(g, p, s):
            g = g.to(torch.float32)
            if bits8:
                m = _dq8(s["m_q"], s["m_s"], g.shape)
                v = _dq8_sqrt(s["v_q"], s["v_s"], g.shape)
                g, m, v = (_placed_as(t, p) for t in (g, m, v))
            else:
                m, v = s["m"], s["v"]
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            upd_ = _div(m, bc1) / (_sqrt(_div(v, bc2)) + eps)
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                upd_ = upd_ + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr_t * upd_).to(p.dtype)
            if bits8:
                mq, ms = _q8(m)
                vq, vs = _q8_sqrt(v)
                return new_p, {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
            return new_p, {"m": m, "v": v}

        return _leafwise(upd, grads, params, state)

    def state_specs(param_specs):
        def leaf(sp):
            nb = -(-int(np.prod(sp.shape)) // QBLOCK)
            if bits8:
                return {"m_q": _meta((nb, QBLOCK), torch.int8),
                        "m_s": _meta((nb, 1), torch.float32),
                        "v_q": _meta((nb, QBLOCK), torch.uint8),
                        "v_s": _meta((nb, 1), torch.float32)}
            return {"m": _meta(sp.shape, torch.float32), "v": _meta(sp.shape, torch.float32)}

        return tree_map(leaf, param_specs)

    return Optimizer(init=init, update=update, state_specs=state_specs)


def make_adafactor(
    lr: float = 1e-3,
    decay: float = 0.8,
    eps: float = 1e-30,
    weight_decay: float = 0.0,
    warmup: int = 2000,
    total_steps: int = 100_000,
) -> Optimizer:
    """Factored second moment (Shazeer & Stern 2018), no first moment."""

    def init_leaf(p):
        if p.dim() >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                  device=p.device),
            }
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def init(params):
        return tree_map(init_leaf, params)

    def update(grads, params, state, step):
        lr_t = float(_schedule(step, lr, warmup, total_steps))
        beta_t = 1 - (_f32(int(step)) + 1) ** (-decay)
        beta, one_m_beta = float(beta_t), float(1 - beta_t)

        def upd(g, p, s):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + one_m_beta * g2.mean(dim=-1)
                vc = beta * s["vc"] + one_m_beta * g2.mean(dim=-2)
                denom = (
                    vr[..., None]
                    / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)[..., None]
                ) * vc[..., None, :]
                upd_ = g / _sqrt(torch.clamp_min(denom, eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + one_m_beta * g2
                upd_ = g / _sqrt(torch.clamp_min(v, eps))
                new_s = {"v": v}
            # update clipping (RMS <= 1)
            rms = _sqrt(torch.mean(upd_ ** 2))
            upd_ = upd_ / torch.clamp_min(rms, 1.0)
            if weight_decay and p.dim() >= 2:
                upd_ = upd_ + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * upd_).to(p.dtype), new_s

        return _leafwise(upd, grads, params, state)

    def state_specs(param_specs):
        def leaf(sp):
            if len(sp.shape) >= 2:
                return {"vr": _meta(sp.shape[:-1], torch.float32),
                        "vc": _meta(sp.shape[:-2] + sp.shape[-1:], torch.float32)}
            return {"v": _meta(sp.shape, torch.float32)}

        return tree_map(leaf, param_specs)

    return Optimizer(init=init, update=update, state_specs=state_specs)


def make_optimizer(name: str = "adamw", **kw) -> Optimizer:
    if name == "adamw":
        return make_adamw(**kw)
    if name == "adamw8bit":
        return make_adamw(bits8=True, **kw)
    if name == "adafactor":
        return make_adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
