"""Public entry points of the draw on given weights.

Counterparts of ``repro.kernels.butterfly_sample.ops``:

* :func:`butterfly_sample` — the end-to-end draw: on CUDA one launch of
  the fused kernel (K4) while its shared memory fits, else pass A (K2)
  and pass B (K3);
* :func:`build_block_sums` — pass A alone (K2): the ``(weights,
  running)`` pair that is the ``kernel`` variant's reusable state;
* :func:`butterfly_sample_from_sums` — pass B alone (K3) on a prebuilt
  pair, with (B,) or (S, B) uniforms (all S*B walks in one launch);
* :func:`butterfly_sample_from_sums_rng` — pass B with counter-RNG
  uniforms derived outside the kernel, as the reference's
  ``sample_from_block_sums_rng_pallas`` does.

Every entry point resolves ``impl`` through
:func:`repro_torch.kernels.runtime.resolve_impl`: the Hopper kernels for
CUDA tensors, the plain PyTorch versions for CPU tensors, ``impl="torch"``
for the plain versions anywhere.  Results are int32 in [0, K).

The reference returns its weights padded to a multiple of its column
tile; the port's kernels pad K virtually, so :func:`build_block_sums`
returns the weights as given (contiguous) and ``running`` has
ceil(K / W) columns.  Either form is accepted by the draws.  The seeded
fused draw (``butterfly_sample_rng``, K5) and the truncated draws (K9-K12)
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import rng as _rng
from repro_torch.kernels import runtime
from repro_torch.kernels.butterfly_sample.kernel import (
    blocksums,
    blocksums_torch,
    fused_draw,
    fused_draw_torch,
    fused_fits,
    num_blocks,
    walk,
    walk_torch,
)

ROUTES = ("fused", "two_pass")


def _weights(x) -> torch.Tensor:
    w = torch.as_tensor(x)
    if w.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        w = w.to(torch.float32)
    return w.contiguous()


def _floats(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.float32).contiguous()


def _running(w, W: int, nb: int, impl: str) -> torch.Tensor:
    return blocksums(w, W, nb) if impl == "cuda" else blocksums_torch(w, W, nb)


def _walk(w, running, u, rows, W: int, impl: str) -> torch.Tensor:
    return walk(w, running, u, rows, W) if impl == "cuda" \
        else walk_torch(w, running, u, rows, W)


def butterfly_sample(weights, u, W: int = 32, impl: Optional[str] = None,
                     route: Optional[str] = None) -> torch.Tensor:
    """One index per row of (B, K) ``weights`` from (B,) uniforms.

    ``route=None`` takes the fused kernel (K4) while its shared memory
    fits (``fused_fits``) and pass A then pass B (K2, K3) beyond;
    ``"fused"`` or ``"two_pass"`` forces one.  Both give the same
    indices."""
    runtime.check_w(W)
    w = _weights(weights)
    u = _floats(u, w)
    K = w.shape[1]
    nb = num_blocks(K, W)
    if route is None:
        route = "fused" if fused_fits(nb, W) else "two_pass"
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    impl = runtime.resolve_impl(impl, w)
    if route == "fused":
        idx = fused_draw(w, u, W) if impl == "cuda" else fused_draw_torch(w, u, W)
    else:
        rows = torch.arange(w.shape[0], dtype=torch.int32, device=w.device)
        idx = _walk(w, _running(w, W, nb, impl), u, rows, W, impl)
    return idx.clamp_(max=K - 1)


def build_block_sums(weights, W: int = 32, impl: Optional[str] = None):
    """Pass A alone (K2 on CUDA): (B, K) weights -> (weights, running),
    ``running`` the (B, ceil(K/W)) float32 running block sums."""
    runtime.check_w(W)
    w = _weights(weights)
    impl = runtime.resolve_impl(impl, w)
    return w, _running(w, W, num_blocks(w.shape[1], W), impl)


def butterfly_sample_from_sums(wp, running, u, K: int, W: int = 32,
                               impl: Optional[str] = None) -> torch.Tensor:
    """Pass B alone (K3 on CUDA): draw from a prebuilt ``(wp, running)``
    pair.  ``u`` is (B,) for one draw per row or (S, B) for S draws per
    row, all S*B walks in one launch.  ``K`` is the unpadded category
    count; ``wp`` may be padded past it (the reference's state)."""
    runtime.check_w(W)
    wp = _weights(wp)
    running = torch.as_tensor(running, device=wp.device).to(torch.float32).contiguous()
    u = _floats(u, wp)
    multi = u.dim() == 2
    S = u.shape[0] if multi else 1
    B = u.shape[-1]
    rows = torch.arange(B, dtype=torch.int32, device=wp.device).repeat(S)
    impl = runtime.resolve_impl(impl, wp)
    idx = _walk(wp, running, u.reshape(-1), rows, W, impl).clamp_(max=K - 1)
    return idx.view(S, B) if multi else idx


def butterfly_sample_from_sums_rng(wp, running, seed, B: int, K: int, S: int = 1,
                                   row_offset=0, W: int = 32,
                                   impl: Optional[str] = None) -> torch.Tensor:
    """:func:`butterfly_sample_from_sums` with counter-RNG uniforms: draw
    s of row b uses u = uniform(fold(seed, TAG_U), (row_offset + b, s)).
    Returns (B,) when S == 1, else (S, B)."""
    dev = torch.as_tensor(wp).device
    seed2 = _rng.fold(_rng.seed_from_key(seed), _rng.TAG_U, 0).to(dev)
    if S == 1:
        u = _rng.row_uniforms(seed2, row_offset, B)
    else:
        u = _rng.multi_row_uniforms(seed2, row_offset, B, S)
    return butterfly_sample_from_sums(wp, running, u, K=K, W=W, impl=impl)
