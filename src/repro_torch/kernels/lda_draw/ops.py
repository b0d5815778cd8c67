"""Public entry points of the factored LDA z-draw.

Every entry point resolves ``impl`` through
:func:`repro_torch.kernels.runtime.resolve_impl`: the Hopper kernels for
CUDA tensors, the plain PyTorch versions for CPU tensors, ``impl="torch"``
for the plain versions anywhere.  Neither route forms the (B, K) weight
tensor.  Indices and uniforms may come in any integer / float dtype; they
are made contiguous int32 / float32 here.  Results are int32 in [0, K).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import rng as _rng
from repro_torch.kernels import runtime
from repro_torch.kernels.lda_draw.kernel import (
    lda_blocksums,
    lda_blocksums_torch,
    lda_draw_docs,
    lda_walk,
    lda_walk_torch,
    num_blocks,
)


def _ids(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.int32).contiguous()


def _floats(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.float32).contiguous()


def lda_draw(theta, phi, words, u, W: int = 32, impl: Optional[str] = None):
    """z[b] ~ Categorical(theta[b, :] * phi[words[b], :]): one theta row
    per sample (the reference's legacy signature)."""
    runtime.check_w(W)
    doc_ids = torch.arange(theta.shape[0], dtype=torch.int32, device=theta.device)
    return lda_draw_docs(
        theta.contiguous(), phi.contiguous(), doc_ids, _ids(words, theta),
        _floats(u, theta), W, impl=impl,
    )


def lda_draw_factored(theta, phi, doc_ids, words, u, W: int = 32,
                      impl: Optional[str] = None):
    """Fused factored draw: z[b] ~ Categorical(theta[doc_ids[b]] *
    phi[words[b]]).  On CUDA one launch of the fused kernel (K8) while its
    shared memory fits in either layout, else pass A (K6) and pass B
    (K7)."""
    runtime.check_w(W)
    return lda_draw_docs(
        theta.contiguous(), phi.contiguous(), _ids(doc_ids, theta),
        _ids(words, theta), _floats(u, theta), W, impl=impl,
    )


def lda_draw_factored_rng(theta, phi, doc_ids, words, seed, row_offset=0,
                          W: int = 32, impl: Optional[str] = None):
    """:func:`lda_draw_factored` with u[b] = uniform(fold(seed, TAG_U),
    row_offset + b) from the counter RNG."""
    B = words.shape[0]
    seed2 = _rng.fold(_rng.seed_from_key(seed), _rng.TAG_U, 0)
    u = _rng.row_uniforms(seed2.to(theta.device), row_offset, B)
    return lda_draw_factored(theta, phi, doc_ids, words, u, W=W, impl=impl)


def lda_build_running(theta, phi, doc_ids, words, W: int = 32,
                      impl: Optional[str] = None):
    """Factored pass A (K6): (theta, phi, (B, nb) running block sums) —
    the ``lda_kernel`` table build.

    The reference returns theta and phi padded to a multiple of W; the
    port's kernels pad K virtually (columns past a row's width read as
    zero), so the factors come back as given and phi is never copied."""
    runtime.check_w(W)
    theta = theta.contiguous()
    phi = phi.contiguous()
    doc_ids = _ids(doc_ids, theta)
    words = _ids(words, theta)
    nb = num_blocks(theta.shape[1], W)
    if runtime.resolve_impl(impl, theta) == "cuda":
        running = lda_blocksums(theta, phi, doc_ids, words, W, nb)
    else:
        running = lda_blocksums_torch(theta, phi, doc_ids, words, W, nb)
    return theta, phi, running


def lda_draw_from_running(thetap, phip, running, u, doc_ids, words, K: int,
                          W: int = 32, impl: Optional[str] = None):
    """Factored pass B (K7): draw from prebuilt running block sums,
    reading only each draw's selected W-block of theta and phi.

    ``u`` is (B,) for one draw per sample or (S, B) for S draws, all S*B
    walks in one launch."""
    runtime.check_w(W)
    u = _floats(u, thetap)
    multi = u.dim() == 2
    S = u.shape[0] if multi else 1
    B = u.shape[-1]
    uf = u.reshape(-1)
    rows = torch.arange(B, dtype=torch.int32, device=thetap.device).repeat(S)
    docs_t = _ids(doc_ids, thetap)[rows.long()]
    words_t = _ids(words, thetap)[rows.long()]
    running = running.contiguous()
    if runtime.resolve_impl(impl, thetap) == "cuda":
        idx = lda_walk(thetap.contiguous(), phip.contiguous(), running, uf, rows,
                       docs_t, words_t, W)
    else:
        idx = lda_walk_torch(thetap, phip, running, uf, rows, docs_t, words_t, W)
    idx = idx.clamp_(max=K - 1)
    return idx.view(S, B) if multi else idx


def lda_draw_from_running_rng(thetap, phip, running, seed, doc_ids, words, K: int,
                              S: int = 1, row_offset=0, W: int = 32,
                              impl: Optional[str] = None):
    """:func:`lda_draw_from_running` with counter-RNG uniforms: draw s of
    sample b uses counter (row_offset + b, s)."""
    B = words.shape[0]
    seed2 = _rng.fold(_rng.seed_from_key(seed), _rng.TAG_U, 0).to(thetap.device)
    if S == 1:
        u = _rng.row_uniforms(seed2, row_offset, B)
    else:
        u = _rng.multi_row_uniforms(seed2, row_offset, B, S)
    return lda_draw_from_running(
        thetap, phip, running, u, doc_ids, words, K=K, W=W, impl=impl
    )
