"""Sparsity-aware LDA Gibbs sweep: MH-alias proposals over sparse counts,
the counterpart of ``repro.lda.sparse``.

The dense z-draw pays O(K) per token however few topics a document or
word touches.  This sweep pays O(cap + log K) (the WarpLDA / EZLDA
construction adapted to the uncollapsed sampler, the reference's
DESIGN.md §10):

* **Fixed-width sparse doc-topic counts** (:class:`SparseDocTopics`):
  each document's top-``cap`` (topic, count) list, ``cap`` a power of two
  bucketed with hysteresis (:class:`SparseSweepCache`).
* **MH-within-Gibbs z-draw**: each token alternates a *word proposal*
  ``k' ~ phi[w, :]`` (alias tables, or a descent over per-word partial
  sums), accepted on ``theta[d, k'] / theta[d, k]``, and a *doc proposal*
  ``k' ~ (alpha + n~_dk) / mass`` over the retained counts (a smoothing
  branch of mass ``K * alpha`` plus a doc-sparse branch), accepted on the
  full ratio.  The proposal mass is the *retained* mass, so truncation at
  ``cap`` keeps the chain exact.

The z-draw is ``kernels.sparse_mh.mh_sweep``: the Hopper kernel S1 (one
launch a sweep) for CUDA tensors, its plain PyTorch version for CPU
tensors; both give the reference's topics and accept counts on the same
seed and tables.  Word-proposal tables are built once per sweep from
phi: ``cdf`` (one cumsum), ``alias`` (Vose's build on the host) or
``alias_device`` (the split-based build, K13 on the card), the alias
kinds through the digest-keyed ``autotune.tables`` cache; ``auto``
arbitrates by :func:`resolve_word_proposal`.

The counts after the draw, the next sweep's lists and their largest
support come from one pass a document (the Hopper kernel
``kernels.sparse_counts``) on the card wherever a document fits a block;
elsewhere from ``_counts`` and a stable sort.

Randomness.  The port's state carries a ``torch.Generator``.  A sweep's
(2,) counter seed is derived, as the distributed sweep derives its own,
from the generator's initial seed (``rng.generator_seed``) and the
state's step: ``fold(fold(seed, TAG_LDA_Z, step), TAG_SPARSE_MH)``, so the
single-device, distributed and streaming sweeps draw the same z at the
same seed; theta and phi are resampled from the state's generator as in
the dense sweep.  The reference splits its JAX key instead.

No (tokens, K) tensor forms: every per-token quantity is a scalar gather
or a (chunk, L, cap) compare (``tests/test_torch_lda_sparse.py`` records
the shape of every tensor a sweep makes).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import rng as _rng
from repro_torch.kernels import runtime
from repro_torch.kernels import sparse_counts as _fused
from repro_torch.kernels.sparse_mh import mh_sweep
from repro_torch.lda.corpus import Corpus
from repro_torch.lda.gibbs import (
    LDAState,
    _counts,
    _dirichlet,
    _generator,
    _update_phi,
    _update_theta,
    log_likelihood,
)

WORD_PROPOSALS = ("alias", "alias_device", "cdf", "auto")

DEFAULT_CAP_MIN = 8
DEFAULT_CAP_MAX = 64


class SparseDocTopics(NamedTuple):
    """Fixed-width sparse doc-topic counts: per-doc top-``cap`` topics.

    Slots beyond a doc's nonzero count carry ``cnt == 0``; when a doc's
    support exceeds ``cap`` the largest counts are kept."""

    ids: torch.Tensor  # (M, cap) int32 topic ids
    cnt: torch.Tensor  # (M, cap) int32 counts


def sparse_counts(doc_topic: torch.Tensor, cap: int) -> SparseDocTopics:
    """Top-``cap`` sparse view of dense (M, K) doc-topic counts.  Among
    equal counts the lower topic id comes first, as ``lax.top_k`` orders
    them (a stable descending sort; ``torch.topk`` gives no tie order, and
    the doc proposal maps a slot to its topic id)."""
    cap = min(cap, doc_topic.shape[-1])
    cnt, ids = torch.sort(doc_topic.to(torch.int32), dim=-1, descending=True,
                          stable=True)
    return SparseDocTopics(ids=ids[:, :cap].to(torch.int32).contiguous(),
                           cnt=cnt[:, :cap].contiguous())


# (doc_topic (M, K), word_topic (V, K)) float32 counts by scatter-add: the
# dense sweep's gibbs._counts (index_add_, no one-hot), which the
# reference's sparse module writes anew because its dense count is a one-hot;
# the sparse sweep takes it off the kernel's route
_counts_scatter = _counts


def _support_max(doc_topic) -> torch.Tensor:
    """The largest number of nonzero topics in a document, a 0-d tensor on
    the counts' device (0 where there are no documents)."""
    if not doc_topic.shape[0]:
        return torch.zeros((), dtype=torch.int64, device=doc_topic.device)
    return (doc_topic > 0).sum(dim=1).max()


def _read_nnz_max(nnz: torch.Tensor, M: int) -> int:
    """The largest support ``nnz`` of M documents read on the host: the
    sweep's one forced read (none where there are no documents)."""
    if not M:
        return 0
    with tracing.span("sync.nnz_max"):
        tracing.count("host_syncs")
        return int(nnz)


def _nnz_max(doc_topic) -> int:
    return _read_nnz_max(_support_max(doc_topic), doc_topic.shape[0])


def _phi_cdf(phi) -> torch.Tensor:
    """(V, K) inclusive per-word partial sums of phi rows (unnormalized:
    the descent rescales by the row total)."""
    return torch.cumsum(phi.to(torch.float32), dim=1)


def pow2_capacity(nnz: int, cap_min: int = DEFAULT_CAP_MIN,
                  cap_max: int = DEFAULT_CAP_MAX) -> int:
    """Power-of-two capacity bucket covering ``nnz``, clamped to
    [cap_min, cap_max] (the clamp is safe: truncation keeps MH exact)."""
    n = max(int(nnz), 1)
    want = 1 << (n - 1).bit_length()
    return max(cap_min, min(cap_max, want))


@dataclasses.dataclass
class SparseSweepCache:
    """Caller-held state the sparse sweep carries across sweeps: the
    capacity bucket, the sparse counts entering the next sweep, and the
    bucket / acceptance history.  The last sweep's MH counts stay on the
    device (``last_counts``: word accepts, doc accepts, proposals) until
    :attr:`last_stats` reads them."""

    cap_min: int = DEFAULT_CAP_MIN
    cap_max: int = DEFAULT_CAP_MAX
    cap: Optional[int] = None
    counts: Optional[SparseDocTopics] = None
    nnz_max: int = 0
    caps_history: List[int] = dataclasses.field(default_factory=list)
    last_counts: Optional[tuple] = None

    @property
    def last_stats(self) -> Optional[Dict[str, float]]:
        """The last sweep's accept rates and proposals per kind, read from
        the device on access (None before the first sweep)."""
        return None if self.last_counts is None else _stats_dict(*self.last_counts)

    def update_capacity(self, nnz_max: int) -> int:
        """Hysteretic pow2 bucketing: grow at once when the max support
        outgrows the bucket; shrink only when it falls to a quarter."""
        self.nnz_max = int(nnz_max)
        want = pow2_capacity(self.nnz_max, self.cap_min, self.cap_max)
        if self.cap is None:
            self.cap = want
        elif want > self.cap:
            self.cap = want
        elif self.nnz_max <= self.cap // 4 and want < self.cap:
            self.cap = want
        if not self.caps_history or self.caps_history[-1] != self.cap:
            self.caps_history.append(self.cap)
        return self.cap


# ---------------------------------------------------------------------------
# The MH sweep
# ---------------------------------------------------------------------------


# ``steps`` MH cycles over every token -> (z, word_accepts, doc_accepts,
# proposals): S1 on the card, its plain version on the CPU.  The uniform of
# (token, use) is a function of (seed, (row0 + doc) * L + position,
# 5 * step + use), so shard and chunk layouts draw alike.
_mh_sweep = mh_sweep


def sweep_seed(seed: torch.Tensor, step: int) -> torch.Tensor:
    """The (2,) counter seed of a sweep's z-draw from the run's (2,) seed
    (``rng.generator_seed`` of the state's generator; module note)."""
    seed_z = _rng.fold(seed, _rng.TAG_LDA_Z, int(step))
    return _rng.fold(seed_z, _rng.TAG_SPARSE_MH)


# ---------------------------------------------------------------------------
# Word-proposal tables
# ---------------------------------------------------------------------------


def resolve_word_proposal(mode: str, K: int, V: int, tokens: Optional[int] = None,
                          backend: Optional[str] = None) -> str:
    """Resolve ``word_proposal="auto"`` to a concrete mode by
    draws-per-refresh amortization: ``tokens`` proposals are drawn against
    ``V`` per-word tables before phi refreshes, ``d = tokens / V`` a
    table.  Unknown ``tokens`` resolves to ``cdf``.

    ``backend`` is the device type of the call's tensors (default: the
    process default, ``cuda`` when a card is present).  On ``cpu`` the
    reference's calibrated crossover (device build ~``K log2K 0.055 us``
    a row against the cumsum's ``K 0.013 us``, each alias proposal saving
    ~``0.025 us`` a descent level); elsewhere the cost model's
    effective-bytes terms, as the reference computes them."""
    if mode != "auto":
        return mode
    if not tokens:
        return "cdf"
    from repro_torch.autotune import cost_model as _cm
    from repro_torch.autotune.tuner import default_backend

    backend = backend or default_backend()
    d = max(1, int(tokens) // max(int(V), 1))
    lg = math.log2(max(K, 2))
    if backend == "cpu":
        build_gap_us = K * (lg * 0.055 - 0.013)
        save_us = 0.025 * lg
        return "alias_device" if d * save_us > build_gap_us else "cdf"
    dev = _cm.method_cost_eq("alias_device", K, draws=d, backend=backend)
    c = 4.0  # float32 tables
    cdf = 2.0 * K * c / d + (lg * _cm.SPARSE_DESCENT_LINE * _cm.LINE_EQ)
    return "alias_device" if dev < cdf else "cdf"


def word_proposal_tables(phi, mode: str, dist_key: str = "lda_sparse_phi"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tbl_a, tbl_b) for the word proposal, on phi's device.  ``alias``:
    Vose's (prob, alias) from the host builder; ``alias_device``: the
    split-based build (K13 on the card); both through the table cache keyed
    by phi's content digest, so a frozen phi never rebuilds.  ``cdf``: the
    per-word partial sums and a (1, 1) placeholder.  ``auto`` must be
    resolved first (:func:`resolve_word_proposal`)."""
    if mode in ("alias", "alias_device"):
        from repro_torch.autotune.tables import get_table_cache

        kind = "alias_host" if mode == "alias" else "alias_device"
        table = get_table_cache().get_or_build(dist_key, kind, phi)
        return table.prob, table.alias
    if mode == "cdf":
        return _phi_cdf(phi), torch.zeros((1, 1), dtype=torch.int32, device=phi.device)
    raise ValueError(f"unknown word_proposal {mode!r}; options: {WORD_PROPOSALS}")


# ---------------------------------------------------------------------------
# Public sweep / draw entry points
# ---------------------------------------------------------------------------


def _stats_dict(wa, da, props) -> Dict[str, float]:
    p = max(int(props), 1)
    return {"word_accept_rate": int(wa) / p, "doc_accept_rate": int(da) / p,
            "proposals_per_kind": p}


def _prepare(state: LDAState, docs, mask, cache: SparseSweepCache):
    """The corpus on the state's device, and the cache's counts built from
    ``state.z`` when it holds none."""
    dev = state.theta.device
    docs = torch.as_tensor(docs, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    K, V = state.theta.shape[-1], state.phi.shape[0]
    if cache.counts is None or cache.cap is None:
        with tracing.span("lda.counts"):
            _, _, lists, nnz = _counts_and_lists(state.z, docs, mask, K, V, cache,
                                                 word=False)
        _next_lists(cache, lists, nnz, K)
    return docs, mask


def _list_width(cache: SparseSweepCache, K: int) -> int:
    """The width of the lists built after a draw: the widest capacity the
    cache can pick."""
    return min(max(cache.cap_min, cache.cap_max), K)


def _fused_route(z, K: int) -> bool:
    """Whether the counts and lists of topics ``z`` take the kernel's one
    pass: on the card, where a document fits a block (by shape)."""
    return z.is_cuda and _fused.fits(K, z.shape[1], z.device)


def _counts_and_lists(z, docs, mask, K: int, V: int, cache: SparseSweepCache,
                      word: bool = True):
    """``(doc_topic, word_topic, lists, nnz)`` of topics ``z``: the counts,
    each document's list :func:`_list_width` wide in the order of a stable
    descending sort, and the largest support as a 0-d tensor, nothing read
    on the host.  On the :func:`_fused_route`, one pass a document
    (``kernels.sparse_counts``, counted by ``sparse.fused_counts``;
    ``word=False`` skips its word side); elsewhere ``_counts``,
    :func:`sparse_counts` and :func:`_support_max`."""
    width = _list_width(cache, K)
    if not _fused_route(z, K):
        doc_topic, word_topic = _counts(z, docs, mask, K, V)
        return (doc_topic, word_topic, sparse_counts(doc_topic, width),
                _support_max(doc_topic))
    tracing.count("sparse.fused_counts")
    doc_topic, word_topic, ids, cnt, nnz = _fused.sparse_counts(z, docs, mask, K, V, width,
                                                                word=word)
    return doc_topic, word_topic, SparseDocTopics(ids=ids, cnt=cnt), nnz


def _next_lists(cache: SparseSweepCache, lists: SparseDocTopics, nnz, K: int) -> None:
    """The capacity bucket from the documents' largest support ``nnz`` (the
    sweep's one host read), and the cache's lists cut to that capacity (no
    copy at the lists' full width)."""
    cache.update_capacity(_read_nnz_max(nnz, lists.ids.shape[0]))
    cap = min(cache.cap, K)
    with tracing.span("lda.sparse.sort"):
        cache.counts = SparseDocTopics(ids=lists.ids[:, :cap].contiguous(),
                                       cnt=lists.cnt[:, :cap].contiguous())


def _draw(state: LDAState, docs, mask, cache, mh_steps, word_proposal, alpha, chunk,
          row0):
    K, V = state.theta.shape[-1], state.phi.shape[0]
    tokens = None
    if word_proposal == "auto":
        # the token count only feeds "auto" (counting synchronises the card)
        with tracing.span("sync.tokens"):
            tracing.count("host_syncs")
            tokens = int((mask > 0).sum()) * mh_steps
    mode = resolve_word_proposal(word_proposal, K, V, tokens=tokens,
                                 backend=state.theta.device.type)
    cap = min(cache.cap, K)
    tracing.gauge("sparse.cap", cap)
    with tracing.span("lda.sparse.tables"):
        tbl_a, tbl_b = word_proposal_tables(state.phi, mode)
    with tracing.span("lda.sparse.mh"):
        out = _mh_sweep(state.z, docs, mask, state.theta, state.phi, cache.counts.ids,
                        cache.counts.cnt, tbl_a, tbl_b,
                        sweep_seed(_rng.generator_seed(state.key), state.step),
                        row0, alpha, steps=mh_steps, cap=cap, mode=mode, chunk=chunk)
    for name, n in zip(("sparse.word_accepts", "sparse.doc_accepts", "sparse.proposals"),
                       out[1:]):
        tracing.count(name, n)
    return out


def draw_z_sparse(state: LDAState, docs, mask, mh_steps: int = 2,
                  word_proposal: str = "alias", alpha: float = 0.1,
                  cache: Optional[SparseSweepCache] = None, chunk: int = 256,
                  row0: int = 0, return_stats: bool = False):
    """Standalone sparse z-draw: ``mh_steps`` MH cycles from ``state.z``
    on the state's device (the chain's stationary per-token law is the
    exact conditional).  Draws what :func:`gibbs_step_sparse` draws from
    the same state."""
    if cache is None:
        cache = SparseSweepCache()
    docs, mask = _prepare(state, docs, mask, cache)
    z, wa, da, props = _draw(state, docs, mask, cache, mh_steps, word_proposal, alpha,
                             chunk, row0)
    if return_stats:
        return z, _stats_dict(wa, da, props)
    return z


def gibbs_step_sparse(state: LDAState, corpus: Corpus, alpha: float = 0.1,
                      beta: float = 0.05, mh_steps: int = 2, word_proposal: str = "cdf",
                      cache: Optional[SparseSweepCache] = None, chunk: int = 256,
                      row0: int = 0) -> LDAState:
    """One full sparse Gibbs sweep with the dense ``gibbs_step``'s state in
    and out: MH z-draw, counts and next lists, Dirichlet theta / phi
    resample.
    Pass the same ``cache`` every sweep to carry the sparse counts and the
    capacity bucket (a fresh cache rebuilds them from ``state.z``).

    ``word_proposal`` defaults to ``"cdf"``: training changes phi every
    sweep, so the one-cumsum build beats a serial alias build;
    ``"alias_device"`` rebuilds alias tables on the device each sweep and
    ``"auto"`` lets :func:`resolve_word_proposal` pick."""
    if cache is None:
        cache = SparseSweepCache()
    docs, mask = _prepare(state, corpus.docs, corpus.mask, cache)
    K, V = state.theta.shape[-1], state.phi.shape[0]
    z, wa, da, props = _draw(state, docs, mask, cache, mh_steps, word_proposal, alpha,
                             chunk, row0)
    with tracing.span("lda.counts"):
        doc_topic, word_topic, lists, nnz = _counts_and_lists(z, docs, mask, K, V, cache)
    with tracing.span("lda.theta"):
        theta = _update_theta(state.key, doc_topic, alpha)
    with tracing.span("lda.phi"):
        phi = _update_phi(state.key, word_topic, beta)
    # the next sweep's proposal counts (and the capacity bucket they live in)
    _next_lists(cache, lists, nnz, K)
    # kept on the device: reading them here would wait for the resample
    cache.last_counts = (wa, da, props)
    return LDAState(theta=theta, phi=phi, z=z, key=state.key, step=state.step + 1)


# ---------------------------------------------------------------------------
# Streaming sweep
# ---------------------------------------------------------------------------


class StreamingSparseLDA:
    """Host-streamed sparse Gibbs: corpus shards flow through the sweep one
    at a time, so only phi, one shard and the (V, K) count accumulator are
    on the device.

    Per sweep, per shard: theta from the shard's current counts, the MH
    sweep with global document offsets (``row0 = shard * shard_docs``), the
    word-topic counts accumulated, the z tokens stored back packed on the
    host.  Phi is resampled once at the sweep's end.

    ``key`` is an int seed or a ``torch.Generator`` on ``device`` (default
    ``cuda``); phi's start is drawn from it.  Sweep n derives its streams
    from the generator's seed (``rng.fold``): the z-draw as
    :func:`sweep_seed` at step n, theta ``fold(fold(seed, TAG_LDA_THETA,
    n), shard)`` (``num_shards + shard`` for the likelihood's theta), phi
    ``fold(seed, TAG_LDA_PHI, n)``, and a shard's first topics from numpy
    seeded by ``fold(seed, TAG_STREAM_Z0, n)``.  ``source`` exposes
    ``num_shards``, ``vocab_size`` and ``shard(i) -> (docs, mask)``
    (``corpus.zipf_shard_source``)."""

    def __init__(self, key, source, K: int, alpha: float = 0.1, beta: float = 0.05,
                 mh_steps: int = 1, word_proposal: str = "cdf", cap: int = 32,
                 chunk: int = 512, device=None):
        self.device = runtime.resolve_device(device)
        self.source = source
        self.K = int(K)
        self.V = int(source.vocab_size)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.mh_steps = int(mh_steps)
        self.word_proposal = word_proposal
        self.cap = int(cap)
        self.chunk = int(chunk)
        g = _generator(0 if key is None else key, self.device)
        self.seed = _rng.generator_seed(g)
        self.phi = _dirichlet(g, torch.ones((self.K, self.V), device=self.device),
                              dim=1).T.contiguous()
        self._z_packed: List[Optional[np.ndarray]] = [None] * source.num_shards
        self.sweeps_done = 0
        self.last_ll = None
        self._last_tokens: Optional[int] = None  # feeds "auto" resolution

    def _gen(self, tag: int, *folds: int) -> torch.Generator:
        s = _rng.fold(self.seed, tag, self.sweeps_done)
        for f in folds:
            s = _rng.fold(s, f)
        return _rng.seeded_generator(s, self.device)

    def _shard_z(self, i: int, mask: np.ndarray) -> torch.Tensor:
        z = np.zeros(mask.shape, np.int32)
        packed = self._z_packed[i]
        if packed is None:
            s0, s1 = _rng.seed_words(_rng.fold(self.seed, _rng.TAG_STREAM_Z0,
                                               self.sweeps_done))
            rng = np.random.default_rng(((s0 << 32) | s1) + i)
            z[mask] = rng.integers(0, self.K, size=int(mask.sum()))
        else:
            z[mask] = packed
        return torch.as_tensor(z, device=self.device)

    def sweep(self) -> Dict[str, float]:
        """One full pass over every shard; returns throughput stats."""
        dev = self.device
        t0 = time.perf_counter()
        # "auto" arbitrates from the previous sweep's token count (the first
        # sweep takes the cheap-build cdf descent)
        mode = resolve_word_proposal(
            self.word_proposal, self.K, self.V,
            tokens=None if self._last_tokens is None else self._last_tokens * self.mh_steps,
            backend=dev.type)
        tbl_a, tbl_b = word_proposal_tables(self.phi, mode)
        seed = sweep_seed(self.seed, self.sweeps_done)
        wt = torch.zeros((self.V, self.K), dtype=torch.float32, device=dev)
        ll = torch.zeros((), dtype=torch.float64, device=dev)
        tokens = wa = da = props = 0
        n = self.source.num_shards
        for i in range(n):
            docs_np, mask_np = self.source.shard(i)
            mask_b = np.asarray(mask_np, bool)
            docs = torch.as_tensor(np.asarray(docs_np, np.int32), device=dev)
            mask = torch.as_tensor(mask_b, device=dev)
            z = self._shard_z(i, mask_b)
            doc_topic, _ = _counts(z, docs, mask, self.K, self.V)
            theta = _update_theta(self._gen(_rng.TAG_LDA_THETA, i), doc_topic, self.alpha)
            sp = sparse_counts(doc_topic, self.cap)
            z, a_w, a_d, p = _mh_sweep(
                z, docs, mask, theta, self.phi, sp.ids, sp.cnt, tbl_a, tbl_b, seed,
                i * docs.shape[0], self.alpha, steps=self.mh_steps,
                cap=min(self.cap, self.K), mode=mode, chunk=self.chunk)
            doc_topic, word_topic = _counts(z, docs, mask, self.K, self.V)
            wt += word_topic
            theta2 = _update_theta(self._gen(_rng.TAG_LDA_THETA, n + i), doc_topic,
                                   self.alpha)
            ll += _shard_ll(theta2, self.phi, docs, mask)
            self._z_packed[i] = z.cpu().numpy()[mask_b].astype(np.int32)
            tokens += int(mask_b.sum())
            wa += int(a_w)
            da += int(a_d)
            props += int(p)
        self.phi = _update_phi(self._gen(_rng.TAG_LDA_PHI), wt, self.beta)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.sweeps_done += 1
        self._last_tokens = tokens
        self.last_ll = float(ll)
        return {
            "tokens": tokens,
            "seconds": dt,
            "tokens_per_sec": tokens / max(dt, 1e-9),
            "perplexity": float(np.exp(-self.last_ll / max(tokens, 1))),
            "word_accept_rate": wa / max(props, 1),
            "doc_accept_rate": da / max(props, 1),
        }


def _shard_ll(theta, phi, docs, mask) -> torch.Tensor:
    """A shard's log likelihood sum_{m,i} log sum_k theta*phi (float64),
    chunked by documents (``gibbs.log_likelihood``), so no (tokens, K)
    tensor forms, where the reference takes one einsum."""
    return log_likelihood(theta, phi, docs, mask)


# ---------------------------------------------------------------------------
# Tuner measurement hook (the sparse_mh autotune candidate)
# ---------------------------------------------------------------------------


def _mh_workload(B: int, K: int, device, seed: int = 0, steps: int = 2, cap: int = 32):
    """The call measure mode times for ``sparse_mh``: a ``B``-token MH draw
    at ``K`` topics (16 tokens a document, V = 256, cdf tables: the
    in-training table the arbitration concerns) on synthetic sparse data
    made on ``device`` from ``seed``; the counts and tables are built once,
    outside the timed call."""
    dev = torch.device(device)
    L, V = 16, 256
    M = max(1, B // L)
    cap = min(cap, K)
    g = torch.Generator(device=dev).manual_seed(seed)
    theta = _dirichlet(g, torch.full((M, K), 0.05, device=dev), dim=1)
    phi = _dirichlet(g, torch.full((K, V), 0.1, device=dev), dim=1).T.contiguous()
    docs = torch.randint(0, V, (M, L), generator=g, device=dev, dtype=torch.int32)
    mask = torch.ones((M, L), dtype=torch.bool, device=dev)
    z = torch.randint(0, K, (M, L), generator=g, device=dev, dtype=torch.int32)
    doc_topic, _ = _counts(z, docs, mask, K, V)
    sp = sparse_counts(doc_topic, cap)
    tbl_a, tbl_b = word_proposal_tables(phi, "cdf")
    s = _rng.fold(_rng.seed_from_key(seed), _rng.TAG_SPARSE_MH)
    return lambda: _mh_sweep(z, docs, mask, theta, phi, sp.ids, sp.cnt, tbl_a, tbl_b,
                             s, 0, 0.1, steps=steps, cap=cap, mode="cdf",
                             chunk=min(256, M))


def measure_sparse_mh(B: int, K: int, iters: int = 3, warmup: int = 1, seed: int = 0,
                      device=None) -> Optional[float]:
    """Median microseconds of a ``B``-token sparse MH draw at ``K`` topics
    (:func:`_mh_workload`), as measure-mode autotune times the
    ``sparse_mh`` candidate (``tuner.measure_method``: a build or launch
    failure propagates)."""
    from repro_torch.autotune.tuner import measure_method

    return measure_method("sparse_mh", B, K, 0, iters=iters, warmup=warmup, seed=seed,
                          factored=True, sparse=True, device=device)
