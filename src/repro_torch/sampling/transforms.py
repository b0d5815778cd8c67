"""Composable logit transforms for truncated decode sampling, in PyTorch.

The counterpart of ``repro.sampling.transforms``: top-k, nucleus (top-p)
and min-p restated as one per-row weight threshold tau, so that no route
sorts the vocabulary.

  * ``TopK(k)``   keeps the k largest weights: the largest tau with
    ``#{w >= tau} >= k``, found by bisection on the value axis.
  * ``TopP(p)``   keeps the smallest set of largest weights whose mass
    reaches p: the largest tau with ``sum(w[w >= tau]) >= p * total``.
  * ``MinP(p)``   keeps weights >= p * max(w).
  * ``Temperature(t)`` rescales logits before the softmax.

Parameters are a scalar or a per-row (B,) tensor.  Chains compose
sequentially (each stage sees the previous stage's survivors); threshold
sets nest, so a chain reduces to one per-row tau.

The bisection (:func:`_bisect`) runs, as the reference's, 32 steps over
the bit patterns of the nonnegative float32 weights, which order like the
floats, so it lands exactly on the boundary weight.  PyTorch on the CPU
has no uint32 ``+``, ``>>`` or ``//``: the bits are taken with
``view(torch.int32)`` (nonnegative floats have nonnegative int32 patterns
in the same order) and the arithmetic runs in int64.

:func:`thresholds_from_params` is the step the two-pass truncated route
(``kernels.butterfly_sample``) runs in plain PyTorch before its masked
kernels; the fused Hopper kernel (K9) runs the same bisection inside.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

SEARCH_ITERS = 32


@dataclasses.dataclass(frozen=True)
class Temperature:
    """Divide logits by ``t`` before the softmax (scalar or (B,))."""

    t: Any = 1.0


@dataclasses.dataclass(frozen=True)
class TopK:
    """Keep the ``k`` largest weights per row (ties at the boundary value
    are kept).  ``k <= 0`` disables.  Scalar or (B,)."""

    k: Any = 0


@dataclasses.dataclass(frozen=True)
class TopP:
    """Keep the smallest prefix of descending weights whose mass reaches
    ``p`` (the boundary token included).  ``p >= 1`` disables."""

    p: Any = 1.0


@dataclasses.dataclass(frozen=True)
class MinP:
    """Keep weights at least ``p`` times the row's largest.  ``p <= 0``
    disables."""

    p: Any = 0.0


TRUNCATIONS = (TopK, TopP, MinP)
_SIG_LETTER = {Temperature: "t", TopK: "k", TopP: "p", MinP: "m"}


def _static_scalar(v) -> bool:
    return isinstance(v, (int, float, bool))


def chain(temperature: Any = None, top_k: Any = None, top_p: Any = None,
          min_p: Any = None) -> Tuple:
    """The canonical chain (temperature, top-k, top-p, min-p).  ``None``
    omits a stage, and so does a statically disabling scalar (``top_k=0``,
    ``top_p>=1``, ``min_p<=0``, ``temperature=1``); tensors are kept."""
    out = []
    if temperature is not None and not (_static_scalar(temperature) and temperature == 1):
        out.append(Temperature(temperature))
    if top_k is not None and not (_static_scalar(top_k) and top_k <= 0):
        out.append(TopK(top_k))
    if top_p is not None and not (_static_scalar(top_p) and top_p >= 1.0):
        out.append(TopP(top_p))
    if min_p is not None and not (_static_scalar(min_p) and min_p <= 0.0):
        out.append(MinP(min_p))
    return tuple(out)


def signature(transforms: Optional[Sequence]) -> str:
    """The chain's transform types in order ("kpm", "tp", ...): it joins
    the plan memo key; parameter values stay out of it."""
    if not transforms:
        return ""
    return "".join(_SIG_LETTER[type(t)] for t in transforms)


def validate(transforms: Sequence) -> None:
    for t in transforms:
        if type(t) not in _SIG_LETTER:
            raise ValueError(
                f"unknown transform {t!r}; options: Temperature, TopK, "
                "TopP, MinP (see repro_torch.sampling.transforms)"
            )


def _row(v, B: int, device=None) -> torch.Tensor:
    """A scalar-or-(B,) parameter as a float32 (B,) tensor."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.dim() == 0:
        return v.expand(B)
    if tuple(v.shape) != (B,):
        raise ValueError(
            f"per-row transform parameter must be scalar or ({B},), got "
            f"shape {tuple(v.shape)}"
        )
    return v


def _f2b(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bit pattern as int64 (monotone for x >= 0)."""
    return x.contiguous().view(torch.int32).to(torch.int64)


def _b2f(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).view(torch.float32)


def _bisect(lo, hi, keep_fn, iters: int) -> torch.Tensor:
    """Value-axis bisection over float bit space: ``keep_fn(tau)`` is True
    at ``lo`` and switches to False by ``hi``; returns the largest float32
    still True (exact after 32 steps)."""
    lo_b, hi_b = _f2b(lo), _f2b(hi)
    for _ in range(iters):
        mid_b = lo_b + (hi_b - lo_b) // 2
        keep = keep_fn(_b2f(mid_b))
        lo_b, hi_b = torch.where(keep, mid_b, lo_b), torch.where(keep, hi_b, mid_b)
    return _b2f(lo_b)


def _above_max(wf: torch.Tensor) -> torch.Tensor:
    """One bit above the row maximum: the open upper end of the bracket."""
    return _b2f(_f2b(wf.max(dim=-1).values) + 1)


def _topk_tau(wf, k, tau0, iters: int):
    hi = _above_max(wf)

    def keeps(tau):
        return (wf >= tau[:, None]).sum(dim=-1).to(torch.float32) >= k

    tau = _bisect(tau0, hi, keeps, iters)
    return torch.where(k > 0, torch.maximum(tau, tau0), tau0)


def _masked_sum(wf, tau):
    return torch.where(wf >= tau[:, None], wf, torch.zeros((), dtype=wf.dtype,
                                                           device=wf.device)).sum(dim=-1)


def _topp_tau(wf, p, tau0, iters: int):
    hi = _above_max(wf)
    target = p * _masked_sum(wf, tau0)

    def keeps(tau):
        return _masked_sum(wf, tau) >= target

    tau = _bisect(tau0, hi, keeps, iters)
    return torch.where(p < 1.0, torch.maximum(tau, tau0), tau0)


def _minp_tau(wf, p, tau0):
    rowmax = wf.max(dim=-1).values
    return torch.where(p > 0.0, torch.maximum(tau0, p * rowmax), tau0)


def _float_rows(weights) -> torch.Tensor:
    return torch.as_tensor(weights).to(torch.float32)


def thresholds(weights, transforms: Sequence, iters: int = SEARCH_ITERS) -> torch.Tensor:
    """One float32 threshold per row: token j of row b survives iff
    ``weights[b, j] >= tau[b]``.  Stages compose sequentially."""
    validate(transforms)
    wf = _float_rows(weights)
    B = wf.shape[0]
    tau = torch.zeros((B,), dtype=torch.float32, device=wf.device)
    for t in transforms:
        if isinstance(t, TopK):
            tau = _topk_tau(wf, _row(t.k, B, wf.device), tau, iters)
        elif isinstance(t, TopP):
            tau = _topp_tau(wf, _row(t.p, B, wf.device), tau, iters)
        elif isinstance(t, MinP):
            tau = _minp_tau(wf, _row(t.p, B, wf.device), tau)
        elif isinstance(t, Temperature):
            raise ValueError(
                "Temperature acts on logits, not weights — fold it via "
                "apply_to_logits(transforms, logits) or the temperature= "
                "argument"
            )
    return tau


def apply(weights, transforms: Sequence, iters: int = SEARCH_ITERS) -> torch.Tensor:
    """Masked weights (truncated tokens zeroed), in the weights' dtype."""
    transforms = tuple(t for t in transforms if not isinstance(t, Temperature))
    weights = torch.as_tensor(weights)
    if not transforms:
        return weights
    tau = thresholds(weights, transforms, iters=iters)
    keep = weights.to(torch.float32) >= tau[:, None]
    return torch.where(keep, weights, torch.zeros_like(weights))


def _is_one(v) -> bool:
    return isinstance(v, (int, float)) and v == 1


def temperature_of(transforms: Optional[Sequence], temperature: Any = 1.0):
    """The ``temperature=`` argument times every Temperature in the chain."""
    t = temperature
    for tr in transforms or ():
        if isinstance(tr, Temperature) and not _is_one(tr.t):
            t = t * torch.as_tensor(tr.t)
    return t


def truncations_of(transforms: Optional[Sequence]) -> Tuple:
    return tuple(t for t in transforms or () if not isinstance(t, Temperature))


def apply_to_logits(transforms: Optional[Sequence], logits, temperature: Any = 1.0,
                    iters: int = SEARCH_ITERS) -> torch.Tensor:
    """Logits -> truncated weights: the temperature-scaled stable softmax
    (Temperature stages folded in), then the truncation chain's mask."""
    from repro_torch.sampling.distribution import logits_to_weights

    w = logits_to_weights(logits, temperature_of(transforms, temperature))
    return apply(w, truncations_of(transforms), iters=iters)


def canonical_params(transforms: Optional[Sequence], B: int, device=None
                     ) -> Optional[torch.Tensor]:
    """The (B, 3) float32 ``[k, p, min_p]`` block the truncated draws take,
    or ``None`` when the chain is not top-k -> top-p -> min-p order (at
    most one of each)."""
    trunc = truncations_of(transforms)
    order = {TopK: 0, TopP: 1, MinP: 2}
    seen = [order[type(t)] for t in trunc if type(t) in order]
    if len(seen) != len(trunc) or seen != sorted(set(seen)):
        return None
    k = p = m = None
    for t in trunc:
        if isinstance(t, TopK):
            k = t.k
        elif isinstance(t, TopP):
            p = t.p
        elif isinstance(t, MinP):
            m = t.p
    return torch.stack([
        _row(0 if k is None else k, B, device),
        _row(1.0 if p is None else p, B, device),
        _row(0.0 if m is None else m, B, device),
    ], dim=1)


def thresholds_from_params(weights, params, iters: int = SEARCH_ITERS) -> torch.Tensor:
    """Per-row tau from a (B, 3) ``[k, p, min_p]`` block: top-k, then
    top-p on its survivors, then min-p; disabled stages pass through."""
    wf = _float_rows(weights)
    B = wf.shape[0]
    params = torch.as_tensor(params, dtype=torch.float32, device=wf.device)
    tau = torch.zeros((B,), dtype=torch.float32, device=wf.device)
    tau = _topk_tau(wf, params[:, 0], tau, iters)
    tau = _topp_tau(wf, params[:, 1], tau, iters)
    return _minp_tau(wf, params[:, 2], tau)
