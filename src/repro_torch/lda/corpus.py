"""Synthetic corpus generation + bucketing (the LDA data pipeline).

A numpy-only copy of the reference's ``repro.lda.corpus``: the same seed
gives the same arrays, so the port and the reference can share corpora.

The paper's evaluation corpus (Wikipedia-derived): M=43556 documents,
V=37286 vocabulary, total words ~3.07M (avg doc ~70.5, max 307).  We
synthesize corpora with planted topic structure at any scale.  Ragged
documents are handled by rectangular padding + masks (documents may be
*bucketed* by length to keep padding waste low).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

PAPER_STATS = dict(M=43556, V=37286, total_words=3072662, max_len=307)


def paper_corpus_stats() -> dict:
    return dict(PAPER_STATS)


@dataclasses.dataclass
class Corpus:
    """Rectangular view of a ragged corpus."""

    docs: np.ndarray      # (M, maxN) int32 word ids (0-padded)
    lengths: np.ndarray   # (M,) int32
    mask: np.ndarray      # (M, maxN) bool
    vocab_size: int
    true_phi: np.ndarray | None = None    # (V, K) planted word-topic dists
    true_theta: np.ndarray | None = None  # (M, K) planted doc-topic dists

    @property
    def num_docs(self) -> int:
        return self.docs.shape[0]

    @property
    def total_words(self) -> int:
        return int(self.lengths.sum())

    def buckets(self, edges: Tuple[int, ...] = (32, 64, 128, 307)) -> List["Corpus"]:
        """Split into length buckets, each trimmed to its own max length —
        keeps the (M, maxN, K) z-draw weight tensor dense."""
        out = []
        lo = 0
        for hi in edges:
            sel = (self.lengths > lo) & (self.lengths <= hi)
            if sel.any():
                ls = self.lengths[sel]
                width = int(ls.max())
                out.append(
                    Corpus(
                        docs=self.docs[sel][:, :width],
                        lengths=ls,
                        mask=self.mask[sel][:, :width],
                        vocab_size=self.vocab_size,
                    )
                )
            lo = hi
        return out


def _choice_cdf(p: np.ndarray) -> np.ndarray:
    """The cdf that ``Generator.choice(len(p), p=p)`` builds."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def _choice(rng: np.random.Generator, cdf: np.ndarray, size: int) -> np.ndarray:
    """``rng.choice(len(cdf), size, p=p)`` on a prebuilt cdf: the same
    uniforms, the same search, the same draws."""
    return cdf.searchsorted(rng.random(size), side="right")


def _topic_word_dirichlet(
    rng: np.random.Generator,
    V: int,
    K: int,
    topic_concentration: float,
    zipf_exponent: float | None,
) -> np.ndarray:
    """(V, K) planted word-topic distributions.

    ``zipf_exponent`` None: the symmetric Dirichlet (every word equally
    likely a priori — unrealistically flat; K_w ~ K for every word).
    Otherwise an *asymmetric* Dirichlet whose mean follows the Zipf law
    ``p(rank) ~ rank^-s``: the corpus-wide word marginal is Zipfian (a
    few head words, a long tail) while each topic still concentrates on
    its own subset — the regime where per-word live-topic counts K_w and
    per-doc live-topic counts K_d stay far below K, which is what the
    sparse sweep exploits."""
    if zipf_exponent is None:
        return rng.dirichlet(np.full(V, topic_concentration), size=K).T
    ranks = np.arange(1, V + 1, dtype=np.float64)
    zipf_w = ranks ** -float(zipf_exponent)
    zipf_w /= zipf_w.sum()
    # mean of Dirichlet(alpha_v) is alpha_v / sum(alpha_v) = the Zipf law;
    # total concentration matches the symmetric case so per-topic
    # sparsity stays comparable.  Floor keeps the gamma sampler stable.
    alpha_v = np.maximum(topic_concentration * V * zipf_w, 1e-3)
    return rng.dirichlet(alpha_v, size=K).T


def synthesize_corpus(
    seed: int,
    M: int = 512,
    V: int = 1024,
    K: int = 16,
    avg_len: float = 70.5,
    max_len: int = 307,
    topic_concentration: float = 0.08,
    doc_concentration: float = 0.25,
    zipf_exponent: float | None = None,
) -> Corpus:
    """Generate a corpus with planted topics (for recovery tests).

    ``topic_concentration`` < 1 makes topics concentrated on few words —
    recoverable structure; doc lengths follow the paper's mean/max profile.
    ``doc_concentration`` is the per-doc topic-concentration knob: small
    values (<< 1) give documents that touch only a few topics (realistic;
    K_d << K), large values approach uniform theta rows (K_d ~ K, which
    hides any sparsity win).  ``zipf_exponent`` (e.g. ~1.05, Zipf's law
    for natural text) makes the word-frequency marginal Zipfian — see
    :func:`_topic_word_dirichlet`."""
    rng = np.random.default_rng(seed)
    true_phi = _topic_word_dirichlet(
        rng, V, K, topic_concentration, zipf_exponent
    )                                                                    # (V, K)
    true_theta = rng.dirichlet(np.full(K, doc_concentration), size=M)    # (M, K)
    lengths = np.clip(rng.poisson(avg_len, size=M), 1, max_len).astype(np.int32)
    maxN = int(lengths.max())
    docs = np.zeros((M, maxN), np.int32)
    mask = np.zeros((M, maxN), bool)
    # each topic's word cdf once, as ``rng.choice(V, p=true_phi[:, k])``
    # builds it on every call (the same draws: choice searches its cdf
    # with the same uniforms)
    word_cdf = {}
    for m in range(M):
        n = lengths[m]
        topics = rng.choice(K, size=n, p=true_theta[m])
        # vectorized word draw per topic group
        words = np.empty(n, np.int32)
        for k in np.unique(topics):
            sel = topics == k
            if k not in word_cdf:
                word_cdf[k] = _choice_cdf(true_phi[:, k])
            words[sel] = _choice(rng, word_cdf[k], int(sel.sum()))
        docs[m, :n] = words
        mask[m, :n] = True
    return Corpus(
        docs=docs,
        lengths=lengths,
        mask=mask,
        vocab_size=V,
        true_phi=true_phi,
        true_theta=true_theta,
    )


def scaled_paper_corpus(
    seed: int,
    scale: float = 0.01,
    K: int = 64,
    topic_concentration: float = 0.08,
    doc_concentration: float = 0.25,
    zipf_exponent: float | None = None,
) -> Corpus:
    """The paper's Wikipedia stats, scaled by ``scale`` for CPU benchmarks.

    Forwards the sparsity knobs: ``zipf_exponent`` for a realistic word
    marginal and ``doc_concentration`` for realistic per-doc topic
    sparsity (benchmark corpora should set both)."""
    M = max(8, int(PAPER_STATS["M"] * scale))
    V = max(64, int(PAPER_STATS["V"] * scale))
    return synthesize_corpus(
        seed, M=M, V=V, K=K, avg_len=70.5, max_len=PAPER_STATS["max_len"],
        topic_concentration=topic_concentration,
        doc_concentration=doc_concentration,
        zipf_exponent=zipf_exponent,
    )


@dataclasses.dataclass
class ZipfShardSource:
    """Deterministic on-demand corpus shards for the streaming sweep.

    Shards are generated (not stored): ``shard(i)`` is a pure function of
    (seed, i), so a million-document corpus costs no host memory beyond
    the one shard in flight.  Every shard has the same rectangular width
    (``max_len``) so the compiled sweep never retraces.

    The generator is fully vectorized (one ``multinomial`` over the
    (M, K) theta block for per-doc topic counts, one grouped
    ``searchsorted`` per topic for the word draws) — ~10^6 tokens/sec on
    one CPU core, so corpus generation never bottlenecks the sweep."""

    seed: int
    num_docs: int
    vocab_size: int
    K: int
    shard_docs: int = 4096
    avg_len: float = 64.0
    max_len: int = 256
    topic_concentration: float = 0.08
    doc_concentration: float = 0.25
    zipf_exponent: float | None = 1.05

    def __post_init__(self):
        # one planted phi for the whole corpus (shards share topics)
        rng = np.random.default_rng([self.seed, 0xC0])
        self.true_phi = _topic_word_dirichlet(
            rng, self.vocab_size, self.K,
            self.topic_concentration, self.zipf_exponent,
        )
        self._phi_cdf = np.cumsum(self.true_phi, axis=0)  # (V, K)

    @property
    def num_shards(self) -> int:
        return -(-self.num_docs // self.shard_docs)

    def shard(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """((M_i, max_len) int32 docs, (M_i, max_len) bool mask)."""
        if not 0 <= i < self.num_shards:
            raise IndexError(f"shard {i} out of range [0, {self.num_shards})")
        M = min(self.shard_docs, self.num_docs - i * self.shard_docs)
        K, V = self.K, self.vocab_size
        rng = np.random.default_rng([self.seed, 1 + i])
        lengths = np.clip(
            rng.poisson(self.avg_len, size=M), 1, self.max_len
        ).astype(np.int64)
        theta = rng.dirichlet(np.full(K, self.doc_concentration), size=M)
        # per-doc topic counts in one shot (broadcast multinomial), then
        # tokens laid out doc-major grouped by topic — LDA is exchangeable
        # within a document, so grouped order is statistically identical
        counts = rng.multinomial(lengths, theta)                   # (M, K)
        T = int(lengths.sum())
        doc_of = np.repeat(np.arange(M), lengths)
        topic_of = np.repeat(np.tile(np.arange(K), M), counts.ravel())
        u = rng.random(T)
        words = np.empty(T, np.int32)
        for k in range(K):
            sel = topic_of == k
            if sel.any():
                words[sel] = np.searchsorted(
                    self._phi_cdf[:, k], u[sel]
                ).clip(0, V - 1)
        starts = np.cumsum(lengths) - lengths
        pos = np.arange(T) - starts[doc_of]
        docs = np.zeros((M, self.max_len), np.int32)
        mask = np.zeros((M, self.max_len), bool)
        docs[doc_of, pos] = words
        mask[doc_of, pos] = True
        return docs, mask


def zipf_shard_source(
    seed: int,
    num_docs: int,
    V: int = 4096,
    K: int = 512,
    shard_docs: int = 4096,
    avg_len: float = 64.0,
    max_len: int = 256,
    topic_concentration: float = 0.08,
    doc_concentration: float = 0.25,
    zipf_exponent: float | None = 1.05,
) -> ZipfShardSource:
    """A :class:`ZipfShardSource` for streaming sparse sweeps — Zipfian
    word marginal, sparse per-doc topics,
    generated shard-by-shard so the corpus never resides in memory."""
    return ZipfShardSource(
        seed=seed, num_docs=num_docs, vocab_size=V, K=K,
        shard_docs=shard_docs, avg_len=avg_len, max_len=max_len,
        topic_concentration=topic_concentration,
        doc_concentration=doc_concentration, zipf_exponent=zipf_exponent,
    )
