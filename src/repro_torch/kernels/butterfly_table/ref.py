"""Oracles for the butterfly table.

* :func:`butterfly_table_ref` — the paper's closed form (entry (i, j) of a
  W x W block holds ``u_v^w`` with ``m = i ^ (i+1), k = m >> 1,
  u = (i & ~m) + (j & m), v = j & ~k, w = v + k``; row W-1 carries the
  running per-sample prefix), in the reference's (B, K) layout.
* :func:`table_serial_order_torch` and :func:`table_split_order_torch` —
  K1's two schedules at W = 64 and 128 as exact-order models of the
  card's arithmetic, in the (G, nb, W, W) layout: the serial one carries
  each sample's running prefix block by block, the split one builds runs
  of blocks with no carry and then adds the running row in the same
  order.  Both make the same fp32 adds in the same order, so they agree
  bit for bit whatever P is.  The running row is a float32 loop, not
  ``torch.cumsum``, which on the CPU accumulates float32 in double.
"""

from __future__ import annotations

import torch

from repro_torch.core import butterfly as _bfly
from repro_torch.kernels.butterfly_sample.ref import H100_SMS

# The split schedule's sizing, as butterfly_table.cu's constant of the same
# role sets it; the models and tests read it from here.
SPLIT_THREADS_PER_SM = 384  # resident pass-1 threads per SM (kSplitThreadsPerSM)


def butterfly_table_ref(weights, W: int = 32) -> torch.Tensor:
    w = torch.as_tensor(weights).float()
    B, K = w.shape
    if B % W or K % W:
        raise ValueError(f"(B={B}, K={K}) must be multiples of W={W}")
    return _bfly.closed_form_table(w, W).transpose(1, 2).reshape(B, K)


def table_split_blocks(G: int, nb: int, W: int, sms: int = H100_SMS) -> int:
    """P, the pass-1 blocks per group of K1's split schedule, as
    ``butterfly_table.cu``'s ``split_run`` sizes it on a card of ``sms``
    SMs: ceil(SPLIT_THREADS_PER_SM / W * sms / G) blocks fill the card
    once, at most one per W-block; then run = ceil(nb / P) blocks each
    and P = ceil(nb / run)."""
    P = min(-(-(SPLIT_THREADS_PER_SM // W) * sms // G), nb)
    run = -(-nb // max(P, 1))
    return -(-nb // run)


def _blocks_f32(w, W: int) -> torch.Tensor:
    w = torch.as_tensor(w)
    B, K = w.shape
    if B % W or K % W:
        raise ValueError(f"(B={B}, K={K}) must be multiples of W={W}")
    return _bfly._blocks(w.to(torch.float32), W)


def table_serial_order_torch(w, W: int) -> torch.Tensor:
    """(G, nb, W, W) float32 table as the serial schedule builds it: block
    c's rounds, then carry = carry + (row W-1) and row W-1 = carry, for c
    = 0 .. nb-1 in order."""
    blocks = _blocks_f32(w, W)
    G, nb = blocks.shape[:2]
    out = torch.empty_like(blocks)
    carry = torch.zeros((G, W), dtype=torch.float32)
    for c in range(nb):
        a = _bfly.butterfly_rounds(blocks[:, c], W)
        carry = carry + a[:, W - 1]
        a[:, W - 1] = carry
        out[:, c] = a
    return out


def table_split_order_torch(w, W: int, P: int) -> torch.Tensor:
    """(G, nb, W, W) float32 table as the split schedule builds it with P
    pass-1 blocks per group: block p runs the rounds of blocks [p * run,
    (p + 1) * run), run = ceil(nb / P), with no carry (row W-1 holds each
    block's own totals); then pass 2 adds carry = carry + total[c] for c =
    0 .. nb-1 in order, one float32 add at a time, into row W-1."""
    blocks = _blocks_f32(w, W)
    G, nb = blocks.shape[:2]
    run = -(-nb // P)
    out = torch.empty_like(blocks)
    for c0 in range(0, nb, run):
        out[:, c0:c0 + run] = _bfly.butterfly_rounds(blocks[:, c0:c0 + run], W)
    carry = torch.zeros((G, W), dtype=torch.float32)
    for c in range(nb):
        carry = carry + out[:, c, W - 1]
        out[:, c, W - 1] = carry
    return out
