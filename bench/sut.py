"""The system under test: the port's LDA Gibbs sweep, as a cell drives it.

The program gets the corpus the benchmark made and a ``torch.Generator``
seeded by the benchmark, builds its start with
``repro_torch.lda.gibbs.init_state`` and sweeps with
``repro_torch.lda.gibbs.gibbs_step``, called with the mix's
``gibbs_step`` arguments (``"sparse_cache": true`` passes one
``SparseSweepCache`` held across sweeps).  ``gibbs_step`` is looked up at
every call, so tests can put a broken sweep, or the control, in its place.
"""

from __future__ import annotations

import torch

from bench.corpus import BenchCorpus


class Program:
    def __init__(self, config: dict, mix: dict, corpus: BenchCorpus, state_seed: int,
                 device):
        from repro_torch.lda import corpus as lda_corpus
        from repro_torch.lda import gibbs, sparse

        self.device = torch.device(device)
        self.alpha = float(config["alpha"])
        self.beta = float(config["beta"])
        self.corpus = lda_corpus.Corpus(docs=corpus.docs, lengths=corpus.lengths,
                                        mask=corpus.mask, vocab_size=corpus.vocab_size)
        g = torch.Generator(device=self.device).manual_seed(int(state_seed))
        self.state = gibbs.init_state(g, self.corpus, int(config["K"]), device=self.device)
        self.kwargs = dict(mix["gibbs_step"])
        if self.kwargs.pop("sparse_cache", False):
            self.kwargs["sparse_cache"] = sparse.SparseSweepCache()

    def sweep(self) -> None:
        from repro_torch.lda import gibbs

        self.state = gibbs.gibbs_step(self.state, self.corpus, alpha=self.alpha,
                                      beta=self.beta, **self.kwargs)

    def snapshot(self) -> tuple:
        """(theta, phi, z) copied to the host."""
        s = self.state
        return tuple(x.detach().to("cpu", copy=True) for x in (s.theta, s.phi, s.z))

    def free(self) -> None:
        self.state = None
        self.kwargs = None
