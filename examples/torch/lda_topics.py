"""End-to-end LDA on the PyTorch/CUDA port: Gibbs sampling on a synthetic
corpus with planted topics, the z-draws by the paper's butterfly sampler,
with perplexity and topic recovery over the iterations.

    PYTHONPATH=src python examples/torch/lda_topics.py [--iters 60] [--method auto] [--device cpu]

``--method lda_kernel`` draws with the fused factored kernel on the card;
``--sparse`` swaps the z-draw for the sparsity-aware MH-alias sweep
(``repro_torch.lda.sparse``, its kernel on the card): same state,
sublinear per-token cost in K; try it with ``--K 512 --zipf``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.lda import (SparseSweepCache, gibbs_step, init_state, perplexity,
                             synthesize_corpus, topic_recovery_score)
from repro_torch.lda.corpus import Corpus
from repro_torch.lda.metrics import top_words


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--method", default="butterfly",
                    choices=["auto", "butterfly", "fenwick", "two_level", "prefix",
                             "gumbel", "kernel", "lda_kernel"])
    ap.add_argument("--M", type=int, default=256)
    ap.add_argument("--V", type=int, default=500)
    ap.add_argument("--K", type=int, default=12)
    ap.add_argument("--sparse", action="store_true",
                    help="use the sparse MH-alias sweep for the z-draws")
    ap.add_argument("--mh-steps", type=int, default=2)
    ap.add_argument("--zipf", action="store_true",
                    help="Zipfian word marginal (the sparse sweep's regime)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    corpus = synthesize_corpus(seed=0, M=args.M, V=args.V, K=args.K, avg_len=70.5,
                               zipf_exponent=1.05 if args.zipf else None)
    print(f"corpus: {corpus.num_docs} docs, {corpus.total_words} words, "
          f"V={corpus.vocab_size}, planted K={args.K}")
    # the corpus on the state's device, so a sweep copies nothing
    corpus = Corpus(docs=torch.as_tensor(corpus.docs, device=dev), lengths=corpus.lengths,
                    mask=torch.as_tensor(corpus.mask, device=dev),
                    vocab_size=corpus.vocab_size, true_phi=corpus.true_phi)
    state = init_state(0, corpus, args.K, device=dev)
    # per-chunk Categorical distributions, held across sweeps and refreshed
    # each iteration from the new theta/phi (the paper's reuse pattern); the
    # sparse path carries its counts and capacity bucket the same way
    dists = {}
    sparse_cache = SparseSweepCache()
    tokens = corpus.total_words
    print(f"{'iter':>5} {'perplexity':>11} {'recovery':>9} {'s/iter':>7} {'tok/s':>9}")
    t0 = time.perf_counter()
    for it in range(args.iters):
        t_it = time.perf_counter()
        if args.sparse:
            state = gibbs_step(state, corpus, sparse=True, sparse_cache=sparse_cache,
                               mh_steps=args.mh_steps)
        else:
            state = gibbs_step(state, corpus, method=args.method, W=32, dists=dists)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        tps = tokens / max(time.perf_counter() - t_it, 1e-9)
        if it % 10 == 0 or it == args.iters - 1:
            p = perplexity(state, corpus)
            r = topic_recovery_score(state.phi.cpu().numpy(), corpus.true_phi)
            dt = (time.perf_counter() - t0) / (it + 1)
            print(f"{it:5d} {p:11.1f} {r:9.3f} {dt:7.3f} {tps:9.0f}")
    print("\ntop words per topic (first 4 topics):")
    phi = state.phi.cpu().numpy()
    for k in range(min(4, args.K)):
        print(f"  topic {k}: {top_words(phi, k, 8).tolist()}")


if __name__ == "__main__":
    main()
