"""Counter-based draw RNG (Threefry-2x32), bit-exact with the reference.

The uniform for (row, draw) is a pure function of a (2,) seed pair and
two counter words::

    u = uniform(seed, counter0=global_row, counter1=draw_index)

so multi-draw and sharded callers need no per-draw keys (see the
reference ``repro.kernels.rng`` for the design).  The cipher is the one
behind JAX's default PRNG; this module reproduces its bits exactly.

PyTorch on the CPU has no uint32 ``+``, ``<<`` or ``>>``, so every word
is held in an int64 tensor and masked back to 32 bits after each add and
shift.  Seeds and outputs are int64 tensors whose values lie in
[0, 2**32).  :func:`fold` of a host seed by integer tags runs the same
rounds on Python integers, so the seeded draws fold their seed on the
host once per call without ~150 small tensor operations.  Host seeds are
host data: under a fake trace (the dry-run) they stay real tensors.

:func:`philox4x32` is the plain version of the Philox-4x32-10 cipher that
the seeded fused draw (K5) runs with ``hw=True`` in place of the TPU's
hardware generator (``kernels/csrc/threefry.cuh``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels.fake import is_fake

_MASK = 0xFFFFFFFF
# Threefry-2x32 constants (Salmon et al. 2011; identical to JAX's PRNG).
_KS_PARITY = 0x1BD11BDA
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))

# domain tags: independent streams derived from one seed via fold()
TAG_U = 1          # u-driven variants' per-(row, draw) uniform
TAG_GUMBEL = 2     # per-(row, category) Gumbel noise
TAG_ALIAS_J = 3    # alias draw: column pick
TAG_ALIAS_A = 4    # alias draw: accept coordinate
TAG_SPARSE_MH = 5  # sparse LDA MH-alias sweep: per-(token, use) uniforms
# the distributed sweep's streams (repro_torch.lda.distributed; the port's
# own: the reference splits a JAX key there)
TAG_LDA_Z = 6      # the z-draw's seed of a sweep
TAG_LDA_THETA = 7  # the theta resample of a sweep, folded again by rank
TAG_LDA_PHI = 8    # the phi resample of a sweep, the same on every rank
TAG_STREAM_Z0 = 9  # the streaming sparse sweep's first topics, per shard

# Philox-4x32-10 constants (Salmon et al. 2011; Random123's philox4x32)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _host(x):
    """Compute on the host's real tensors while a fake mode is active,
    unless ``x`` is itself a trace's fake tensor: a host seed is data."""
    if is_fake(x):
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    return unset_fake_temporarily()


def _u32(x, device=None) -> torch.Tensor:
    """An int64 tensor holding x's values reduced modulo 2**32."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds).

    Inputs are integers or integer tensors (broadcast together); returns
    the two output words as int64 tensors with values in [0, 2**32), or
    as Python integers when all four inputs are Python integers."""
    if all(type(a) is int for a in (k0, k1, x0, x1)):
        k0, k1, x0, x1 = (a & _MASK for a in (k0, k1, x0, x1))
    else:
        dev = next(
            (a.device for a in (k0, k1, x0, x1) if isinstance(a, torch.Tensor)), None
        )
        k0, k1, x0, x1 = (_u32(a, dev) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def seed_from_key(key) -> torch.Tensor:
    """(2,) seed pair from a raw uint32 key pair (or a single word, which
    is taken as ``(0, word)`` like the reference)."""
    with _host(key):
        arr = _u32(key).reshape(-1)
        if arr.shape[0] == 1:
            arr = torch.cat([torch.zeros_like(arr), arr])
        return arr[-2:]


def generator_seed(g: torch.Generator) -> torch.Tensor:
    """The (2,) host seed of a ``torch.Generator``: its initial seed as two
    32-bit words (what the port's LDA sweeps derive their streams from,
    where the reference splits a JAX key)."""
    s = int(g.initial_seed()) & 0xFFFFFFFFFFFFFFFF
    return seed_from_key([s >> 32, s & _MASK])


def seeded_generator(seed: torch.Tensor, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with a (2,) seed (s0, s1)
    as ``s0 << 32 | s1``."""
    s0, s1 = seed_words(seed)
    return torch.Generator(device=device).manual_seed((s0 << 32) | s1)


def fold(seed: torch.Tensor, a, b=0) -> torch.Tensor:
    """An independent (2,) seed derived from (seed, a, b); on the seed's
    device (a host seed folded by integers stays on the host)."""
    host = not (isinstance(seed, torch.Tensor) and (seed.is_cuda or is_fake(seed)))
    if host and type(a) is int and type(b) is int:
        with _host(seed):
            return torch.tensor(threefry2x32(*_u32(seed).tolist(), a, b),
                                dtype=torch.int64)
    seed = _u32(seed)
    s0, s1 = threefry2x32(seed[0], seed[1], a, b)
    return torch.stack([s0.reshape(()), s1.reshape(())])


def seed_words(seed) -> tuple:
    """A (2,) seed as two host integers (the seeded kernels' arguments)."""
    with _host(seed):
        s0, s1 = _u32(seed).reshape(-1).tolist()
    return s0, s1


def bits_to_uniform(bits) -> torch.Tensor:
    """uint32 bits -> float32 uniforms in [0, 1) (top 24 bits)."""
    return (_u32(bits) >> 8).to(torch.float32) * (2.0 ** -24)


def uniform(seed: torch.Tensor, counter0, counter1=0) -> torch.Tensor:
    """Uniforms in [0, 1), one per broadcast element of the counters."""
    seed = _u32(seed)
    c0 = _u32(counter0, seed.device)
    c1 = _u32(counter1, seed.device)
    c0, c1 = torch.broadcast_tensors(c0, c1)
    b0, _ = threefry2x32(seed[0], seed[1], c0, c1)
    return bits_to_uniform(b0)


def row_uniforms(seed: torch.Tensor, row0, n: int, draw=0) -> torch.Tensor:
    """(n,) uniforms for global rows [row0, row0 + n) at one draw index."""
    seed = _u32(seed)
    rows = int(row0) + torch.arange(n, dtype=torch.int64, device=seed.device)
    return uniform(seed, rows, draw)


def multi_row_uniforms(seed: torch.Tensor, row0, n: int, S: int) -> torch.Tensor:
    """(S, n) uniforms: draw s of global row r is counter (r, s)."""
    seed = _u32(seed)
    rows = int(row0) + torch.arange(n, dtype=torch.int64, device=seed.device)
    draws = torch.arange(S, dtype=torch.int64, device=seed.device)
    return uniform(seed, rows[None, :], draws[:, None])


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of the 64-bit product m * x (m a 32-bit constant, x
    int64 words in [0, 2**32)), from 16-bit halves of x: int64 cannot
    hold the product itself."""
    p_lo = m * (x & 0xFFFF)                      # < 2**48
    p_hi = m * (x >> 16)                         # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)         # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK


def philox4x32(k0, k1, c0, c1=0, c2=0, c3=0):
    """The Philox-4x32-10 block cipher: key (k0, k1), counter (c0, c1, c2,
    c3), integers or integer tensors broadcast together; the four output
    words as int64 tensors with values in [0, 2**32)."""
    dev = next((a.device for a in (k0, k1, c0, c1, c2, c3)
                if isinstance(a, torch.Tensor)), None)
    k0, k1 = (int(_u32(k)) for k in (k0, k1))
    c = torch.broadcast_tensors(*(_u32(a, dev) for a in (c0, c1, c2, c3)))
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _MASK
            k1 = (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = (hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0)
    return c


def philox_row_uniforms(seed: torch.Tensor, row0, n: int) -> torch.Tensor:
    """(n,) uniforms for global rows [row0, row0 + n) from word 0 of
    Philox(seed, (row, 0, 0, 0)): the stream of the seeded fused draw
    with ``hw=True``."""
    seed = _u32(seed)
    rows = int(row0) + torch.arange(n, dtype=torch.int64, device=seed.device)
    return bits_to_uniform(philox4x32(seed[0], seed[1], rows)[0])
