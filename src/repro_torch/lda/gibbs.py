"""Uncollapsed LDA Gibbs sampler (paper §2, Algorithm 1/4/7), in PyTorch.

One sweep =
  1. DRAW Z  — for every word position (m, i), draw a topic from the K
     relative probabilities ``theta[m,k] * phi[w[m,i],k]``: the paper's hot
     loop.  ``method="auto"`` (the default) resolves once per sweep, through
     ``repro_torch.autotune`` over the *factored* u-driven candidate set,
     for the chunk's (chunk*maxN, K) workload on the state's device.
     ``method="lda_kernel"`` draws straight from the factors — on CUDA the
     fused Hopper kernel, one launch per chunk of documents — and the
     (chunk*maxN, K) weight tensor never exists.
     ``prefix`` / ``butterfly`` / ``fenwick`` / ``two_level`` / ``kernel``
     form one chunk's weights at a time and draw through their tables.
     On CUDA, ``butterfly`` builds the paper's Alg. 8 table with the
     Hopper kernel K1 (one launch per chunk) and searches it in PyTorch;
     ``kernel`` is the two-pass draw on given weights, pass A (K2) then
     pass B (K3), one launch each per chunk.
  2. UPDATE THETA — theta[m,:] ~ Dirichlet(alpha + doc-topic counts).
  3. UPDATE PHI   — phi[:,k]  ~ Dirichlet(beta + word-topic counts).

Randomness comes from the state's ``torch.Generator`` (the reference's
``jax.random`` key): one (C*N,) uniform vector per chunk, then the theta
and phi gamma draws.  The two frameworks give different numbers from one
seed; tests feed the reference's uniforms to :func:`_draw_chunk`.

In place: :func:`gibbs_step` writes the new topics into ``state.z``, where
the reference donates that buffer — after a sweep the old state's ``z``
must not be read again (rebind the returned state).

``gumbel``, ``alias``, ``alias_device`` and ``radix_forest`` build the
chunk's weights into their ``Categorical`` state; ``gumbel`` and the
alias methods draw from the state's generator (Gumbel noise, alias
columns and coins), the others from one (C*N,) uniform vector per chunk.
``dists=`` (a dict chunk start -> ``Categorical``) holds each chunk's
distribution across sweeps and refreshes it from the new theta and phi
(``refresh_from_factors`` for ``lda_kernel``, ``refreshed`` otherwise);
on the same uniforms it draws what the fresh build draws.

``sparse=True`` (or ``"auto"``, arbitrated by the tuner) runs the sweep
through ``repro_torch.lda.sparse``: the MH-alias z-draw over sparse
doc-topic counts (the Hopper kernel S1 on the card).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import sampling, tracing
from repro_torch.kernels import runtime
from repro_torch.lda.corpus import Corpus
from repro_torch.sampling import distribution as _dist

METHODS = ("auto", "lda_kernel", "prefix", "butterfly", "fenwick", "two_level",
           "kernel", "gumbel", "alias", "alias_device", "radix_forest")


class LDAState(NamedTuple):
    theta: torch.Tensor     # (M, K) document-topic distributions (rows sum to 1)
    phi: torch.Tensor       # (V, K) word-topic distributions (columns sum to 1)
    z: torch.Tensor         # (M, maxN) int32 latent topic assignments
    key: torch.Generator    # the sweep's random stream
    step: int


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options: {METHODS}")


def _chunk_plan(B: int, K: int, method: str, W: Optional[int], dtype,
                backend: str) -> sampling.SamplerPlan:
    """The plan of a (B, K) chunk draw over the *factored* candidate set:
    the sweep's weights always arrive as a theta-phi product, so ``auto``
    may pick ``lda_kernel``.  Only ``gumbel`` and ``alias`` resolve as
    keyed; ``auto`` resolves over the u-driven set."""
    return sampling.plan((B, K), method=method, W=W, dtype=dtype,
                         has_key=method in ("gumbel", "alias"), factored=True,
                         backend=backend)


def _generator(key, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"generator on {key.device}, state on {device}")
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _dirichlet(g: torch.Generator, conc: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch._standard_gamma(conc, generator=g)
    return x / x.sum(dim=dim, keepdim=True)


def init_state(key, corpus: Corpus, K: int, device=None) -> LDAState:
    """Random start: Dirichlet(1) theta rows and phi columns, uniform z.
    ``key`` is an int seed or a ``torch.Generator`` on ``device``
    (default ``cuda``)."""
    dev = runtime.resolve_device(device)
    M, maxN = corpus.docs.shape
    V = corpus.vocab_size
    g = _generator(key, dev)
    theta = _dirichlet(g, torch.ones((M, K), device=dev), dim=1)
    phi = _dirichlet(g, torch.ones((K, V), device=dev), dim=1).T.contiguous()
    z = torch.randint(0, K, (M, maxN), generator=g, device=dev, dtype=torch.int32)
    return LDAState(theta=theta, phi=phi, z=z, key=g, step=0)


def state_from_numpy(theta, phi, z, step, seed, device=None) -> LDAState:
    """The port's state from a reference ``LDAState``'s arrays (as numpy);
    the random stream restarts from ``seed``."""
    dev = runtime.resolve_device(device)
    return LDAState(
        theta=torch.as_tensor(np.array(theta, np.float32), device=dev),
        phi=torch.as_tensor(np.array(phi, np.float32), device=dev),
        z=torch.as_tensor(np.array(z, np.int32), device=dev),
        key=_generator(seed, dev),
        step=int(step),
    )


def state_to_numpy(state: LDAState) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(theta, phi, z, step) as numpy: the reverse of :func:`state_from_numpy`."""
    return (state.theta.cpu().numpy(), state.phi.cpu().numpy(),
            state.z.cpu().numpy(), int(state.step))


def _chunks(theta: torch.Tensor, docs: torch.Tensor, chunk: int):
    """(start, end, theta_c, docs_c) per chunk of documents; the last chunk
    is padded with zero theta rows and word-0 docs to the full chunk, as in
    the reference's scan (those rows draw from all-zero weights)."""
    M = docs.shape[0]
    chunk = min(chunk, M) if M else chunk
    for start in range(0, M, chunk):
        end = min(start + chunk, M)
        theta_c, docs_c = theta[start:end], docs[start:end]
        pad = chunk - (end - start)
        if pad:
            theta_c = torch.nn.functional.pad(theta_c, (0, 0, 0, pad))
            docs_c = torch.nn.functional.pad(docs_c, (0, 0, 0, pad))
        yield start, end, theta_c, docs_c


def _chunk_dist(theta_c, phi, docs_c, method: str, W: int, dist=None):
    """This chunk's ``Categorical``: ``dist`` refreshed when it fits (same
    method, W and shape), else a fresh build.  The factored ``lda_kernel``
    never forms the (C*N, K) weights; the other methods form this chunk's
    only."""
    C, N = docs_c.shape
    K = theta_c.shape[-1]
    words = docs_c.reshape(-1)
    fits = dist is not None and dist.method == method and dist.W == W \
        and dist.shape == (C * N, K)
    if method in _dist.FACTORED_VARIANTS:
        if fits:
            return dist.refresh_from_factors(theta_c, phi, words)
        doc_ids = torch.arange(C * N, dtype=torch.int32, device=theta_c.device) // N
        return _dist.Categorical._build_factored(theta_c, phi, doc_ids, words, method, W)
    flat = (theta_c[:, None, :] * phi[docs_c.long()]).reshape(C * N, K)
    if fits:
        return dist.refreshed(flat)
    return _dist.Categorical._build(flat, method, W)


def _draw_chunk(theta_c, phi, docs_c, u, method: str, W: Optional[int],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(C, N) topics for one chunk from its (C*N,) uniforms (``u``) or, for
    ``gumbel`` and the alias methods, from ``generator``.  ``lda_kernel``
    draws straight from the factors (K8 on CUDA)."""
    C, N = docs_c.shape
    K = theta_c.shape[-1]
    W = W or runtime.default_w(K)
    if method in _dist.FACTORED_VARIANTS:
        from repro_torch.kernels.lda_draw import lda_draw_factored

        doc_ids = torch.arange(C * N, dtype=torch.int32, device=theta_c.device) // N
        return lda_draw_factored(theta_c, phi, doc_ids, docs_c.reshape(-1), u,
                                 W=W).view(C, N)
    dist = _chunk_dist(theta_c, phi, docs_c, method, W)
    return _dist.draw(dist, generator=generator, u=u).view(C, N)


def draw_z(state: LDAState, docs, method: str = "auto", W: Optional[int] = None,
           chunk: int = 256, dists: Optional[Dict[int, _dist.Categorical]] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked z-draw over all documents: (M, maxN) int32.  ``method`` is
    resolved once for the chunk's workload (:func:`_chunk_plan`).  Uniforms
    come from ``state.key``, one (chunk*maxN,) vector per chunk (``gumbel``
    and the alias methods draw from ``state.key`` directly).  ``dists``
    holds each chunk's ``Categorical`` across calls (see the module note).
    ``out`` receives the topics in place when given."""
    _check_method(method)
    dev = state.theta.device
    docs = torch.as_tensor(docs, device=dev)
    M, maxN = docs.shape
    K = state.theta.shape[-1]
    rows = (min(chunk, M) if M else chunk) * maxN
    with tracing.span("lda.draw_z"):
        with tracing.span("autotune.plan"):
            p = _chunk_plan(rows, K, method, W, state.theta.dtype, dev.type)
        method, Wr = p.method, p.W
        keyed = method in _dist.KEY_VARIANTS
        z = torch.empty((M, maxN), dtype=torch.int32, device=dev) if out is None else out
        tracing.count("lda.chunks", -(-M // min(chunk, M)) if M else 0)
        for start, end, theta_c, docs_c in _chunks(state.theta, docs, chunk):
            u = None if keyed else torch.rand(docs_c.numel(), generator=state.key,
                                              device=dev)
            if dists is None:
                zc = _draw_chunk(theta_c, state.phi, docs_c, u, method, Wr, state.key)
            else:
                dist = _chunk_dist(theta_c, state.phi, docs_c, method, Wr,
                                   dists.get(start))
                dists[start] = dist
                zc = _dist.draw(dist, generator=state.key, u=u).view(docs_c.shape)
            z[start:end] = zc[: end - start]
    return z


def sample_z(state: LDAState, corpus: Corpus, num_samples: int = 4,
             W: Optional[int] = None, chunk: int = 256) -> torch.Tensor:
    """(num_samples, M, maxN) topic draws from the current theta and phi,
    through the factored ``lda_kernel`` tables: per chunk one pass-A build
    (K6 on CUDA) and all num_samples * chunk * maxN walks in one pass-B
    launch (K7).  The state itself is left unchanged."""
    dev = state.theta.device
    docs = torch.as_tensor(corpus.docs, device=dev)
    M, maxN = docs.shape
    K = state.theta.shape[-1]
    W = W or runtime.default_w(K)
    z = torch.empty((num_samples, M, maxN), dtype=torch.int32, device=dev)
    for start, end, theta_c, docs_c in _chunks(state.theta, docs, chunk):
        C, N = docs_c.shape
        doc_ids = torch.arange(C * N, dtype=torch.int32, device=dev) // N
        dist = _dist.Categorical._build_factored(theta_c, state.phi, doc_ids,
                                                 docs_c.reshape(-1), "lda_kernel", W)
        u = torch.rand((num_samples, C * N), generator=state.key, device=dev)
        idx = dist.draw(u=u)
        z[:, start:end] = idx.view(num_samples, C, N)[:, : end - start]
    return z


def _counts(z, docs, mask, K: int, V: int):
    """(doc_topic (M, K), word_topic (V, K)) float32 counts of the masked
    assignments, by index_add_ — no (M, maxN, K) one-hot."""
    M, N = z.shape
    zl = z.long()
    w = mask.reshape(-1).to(torch.float32)
    rows = torch.arange(M, device=z.device)[:, None] * K + zl
    doc_topic = torch.zeros(M * K, dtype=torch.float32, device=z.device)
    doc_topic.index_add_(0, rows.reshape(-1), w)
    cells = docs.long() * K + zl
    word_topic = torch.zeros(V * K, dtype=torch.float32, device=z.device)
    word_topic.index_add_(0, cells.reshape(-1), w)
    return doc_topic.view(M, K), word_topic.view(V, K)


def _update_theta(g: torch.Generator, doc_topic, alpha):
    return _dirichlet(g, alpha + doc_topic, dim=-1)


def _update_phi(g: torch.Generator, word_topic, beta):
    return _dirichlet(g, beta + word_topic, dim=0)


def gibbs_step(state: LDAState, corpus: Corpus, alpha: float = 0.1, beta: float = 0.05,
               method: str = "auto", W: Optional[int] = None, chunk: int = 256,
               dists: Optional[Dict[int, _dist.Categorical]] = None,
               sparse=False, sparse_cache=None, mh_steps: int = 2,
               word_proposal: str = "cdf") -> LDAState:
    """One full uncollapsed Gibbs sweep; returns the next state.  The new
    topics are written into ``state.z`` (see the module note).  Pass the
    same dict as ``dists=`` on every call to hold the per-chunk
    distributions across sweeps.  The corpus arrays may be numpy or
    tensors already on the state's device.

    ``sparse=True`` routes the sweep through ``repro_torch.lda.sparse``
    (the MH-alias z-draw, the same state in and out); ``sparse="auto"``
    asks the tuner to arbitrate dense against sparse for this (tokens, K)
    bucket on the state's device.  Pass the same ``sparse_cache=`` (a
    ``sparse.SparseSweepCache``) on every call to carry the sparse counts
    across sweeps; ``mh_steps`` / ``word_proposal`` tune the chain
    (``sparse.gibbs_step_sparse``)."""
    _check_method(method)
    dev = state.theta.device
    with tracing.span("lda.sweep", state.step):
        tracing.count("lda.sweeps")
        if sparse:
            from repro_torch.lda import sparse as _sparse

            use_sparse = True
            if sparse == "auto":
                from repro_torch import autotune

                with tracing.span("sync.total_words"):
                    if torch.is_tensor(corpus.lengths):
                        tracing.count("host_syncs")
                    total = corpus.total_words
                with tracing.span("autotune.plan"):
                    meth, _ = autotune.resolve(int(total), state.theta.shape[-1],
                                               factored=True, sparse=True,
                                               backend=dev.type)
                use_sparse = meth in autotune.SPARSE_METHODS
            if use_sparse:
                return _sparse.gibbs_step_sparse(
                    state, corpus, alpha=alpha, beta=beta, mh_steps=mh_steps,
                    word_proposal=word_proposal, cache=sparse_cache, chunk=chunk)
        docs = torch.as_tensor(corpus.docs, device=dev)
        mask = torch.as_tensor(corpus.mask, device=dev)
        K = state.theta.shape[-1]
        V = state.phi.shape[0]
        z = draw_z(state, docs, method=method, W=W, chunk=chunk, dists=dists,
                   out=state.z)
        with tracing.span("lda.counts"):
            doc_topic, word_topic = _counts(z, docs, mask, K, V)
        with tracing.span("lda.theta"):
            theta = _update_theta(state.key, doc_topic, alpha)
        with tracing.span("lda.phi"):
            phi = _update_phi(state.key, word_topic, beta)
        return LDAState(theta=theta, phi=phi, z=z, key=state.key, step=state.step + 1)


def log_likelihood(theta, phi, docs, mask, chunk: int = 256) -> torch.Tensor:
    """Held-in predictive log likelihood sum_{m,i} log sum_k theta*phi, as
    a float64 scalar; documents go in chunks so no (M, maxN, K) tensor
    forms."""
    dev = theta.device
    docs = torch.as_tensor(docs, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    ll = torch.zeros((), dtype=torch.float64, device=dev)
    for start in range(0, docs.shape[0], chunk):
        th = theta[start:start + chunk]
        p = torch.einsum("mk,mnk->mn", th, phi[docs[start:start + chunk].long()])
        lp = torch.log(p.clamp(min=1e-30))
        ll += torch.where(mask[start:start + chunk], lp, 0.0).sum(dtype=torch.float64)
    return ll


def perplexity(state: LDAState, corpus: Corpus) -> float:
    ll = log_likelihood(state.theta, state.phi, corpus.docs, corpus.mask)
    return float(torch.exp(-ll / corpus.total_words))
