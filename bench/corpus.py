"""A corpus with planted topics, made on the device from a seed.

A vectorised PyTorch rewrite of ``repro_torch.lda.corpus.synthesize_corpus``
(same model, same knobs, no loop over documents), so a corpus of 300,000
documents is made in well under a second on the card:

* planted word-topic rows ``phi_k ~ Dirichlet(a_v)`` with the Zipf mean
  ``a_v = max(topic_concentration * V * zipf_v, 1e-3)`` (float64, as the
  numpy original draws them);
* planted document-topic rows ``theta_m ~ Dirichlet(doc_concentration)``;
* lengths ``Poisson(avg_len)`` clipped to ``[1, max_len]``; every corpus
  is ``max_len`` positions wide, whatever the seed, so every seed gives
  the sweep the same shapes;
* each position's topic by inverse cdf on its document's planted row, its
  word by inverse cdf on the topic's planted row (one search over all
  topics' cdfs laid end to end, topic k's shifted by k).

The same seed on the same device gives the same arrays.  The program
receives only these arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class BenchCorpus:
    docs: torch.Tensor      # (M, L) int32 word ids, 0 past a document's end
    mask: torch.Tensor      # (M, L) bool, True at a document's positions
    lengths: torch.Tensor   # (M,) int32
    vocab_size: int

    @property
    def live_tokens(self) -> int:
        return int(self.lengths.sum())


def _normalised_gamma(g: torch.Generator, conc: torch.Tensor) -> torch.Tensor:
    x = torch._standard_gamma(conc, generator=g)
    return x / x.sum(dim=1, keepdim=True)


def make_corpus(config: dict, seed: int, device) -> BenchCorpus:
    """The corpus of ``config`` (keys ``M``, ``V``, ``K_planted``,
    ``avg_len``, ``max_len``, ``topic_concentration``,
    ``doc_concentration``, ``zipf_exponent``) from ``seed`` on
    ``device``."""
    dev = torch.device(device)
    M, V, K = int(config["M"]), int(config["V"]), int(config["K_planted"])
    L = int(config["max_len"])
    g = torch.Generator(device=dev).manual_seed(int(seed))
    ranks = torch.arange(1, V + 1, dtype=torch.float64, device=dev)
    zipf = ranks ** -float(config["zipf_exponent"])
    zipf /= zipf.sum()
    a_v = torch.clamp(float(config["topic_concentration"]) * V * zipf, min=1e-3)
    phi = _normalised_gamma(g, a_v.expand(K, V).contiguous())          # (K, V) f64
    del a_v, zipf, ranks
    theta = _normalised_gamma(
        g, torch.full((M, K), float(config["doc_concentration"]), device=dev))
    lengths = torch.poisson(torch.full((M,), float(config["avg_len"]), device=dev),
                            generator=g)
    lengths = lengths.clamp_(1, L).to(torch.int32)
    # topics: inverse cdf on each document's planted row
    cdf = torch.cumsum(theta, dim=1)
    del theta
    u = torch.rand((M, L), generator=g, device=dev) * cdf[:, -1:]
    topic = torch.searchsorted(cdf, u, right=True).clamp_(max=K - 1)
    del cdf, u
    # words: inverse cdf on the topic's planted row; topic k's cdf is
    # shifted by k, so all K rows form one sorted array
    wcdf = torch.cumsum(phi, dim=1)
    del phi
    wcdf /= wcdf[:, -1:].clone()
    wcdf += torch.arange(K, dtype=torch.float64, device=dev)[:, None]
    flat = wcdf.reshape(-1)
    q = torch.rand((M, L), generator=g, device=dev, dtype=torch.float64)
    q += topic
    words = torch.searchsorted(flat, q, right=True)
    del flat, wcdf, q
    words -= topic * V
    del topic
    words.clamp_(0, V - 1)
    mask = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    docs = torch.where(mask, words, 0).to(torch.int32)
    return BenchCorpus(docs=docs, mask=mask, lengths=lengths, vocab_size=V)
