"""Latent Dirichlet Allocation — the paper's application, end to end.

Uncollapsed Gibbs sampler (paper §2): alternates drawing the latent topic
``z[m,i]`` for every word position (the step the butterfly technique
accelerates) with Dirichlet updates of ``theta`` and ``phi``.
"""

from repro_torch.lda.corpus import Corpus, paper_corpus_stats, synthesize_corpus
from repro_torch.lda.gibbs import (
    LDAState,
    draw_z,
    gibbs_step,
    init_state,
    log_likelihood,
    perplexity,
    sample_z,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.lda.metrics import topic_recovery_score
from repro_torch.lda.sparse import (
    SparseSweepCache,
    StreamingSparseLDA,
    draw_z_sparse,
    gibbs_step_sparse,
    sparse_counts,
)

__all__ = [
    "Corpus",
    "paper_corpus_stats",
    "synthesize_corpus",
    "LDAState",
    "draw_z",
    "gibbs_step",
    "init_state",
    "log_likelihood",
    "perplexity",
    "sample_z",
    "state_from_numpy",
    "state_to_numpy",
    "topic_recovery_score",
    "SparseSweepCache",
    "StreamingSparseLDA",
    "draw_z_sparse",
    "gibbs_step_sparse",
    "sparse_counts",
]
