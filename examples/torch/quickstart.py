"""Quickstart on the PyTorch/CUDA port: draw from 100k distinct discrete
distributions with the butterfly-patterned partial-sums technique
(Steele & Tristan 2015), and check the statistics.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--B 100000]

On the card every method runs its hand-written kernel where it has one
(``kernel``: the block sums and the walk); ``--device cpu`` runs the
plain PyTorch versions.
"""

import argparse

import numpy as np
import torch

from repro_torch import sampling
from repro_torch.core import sample_categorical
from repro_torch.kernels.runtime import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--B", type=int, default=100_000, help="distributions, one a row")
    ap.add_argument("--K", type=int, default=200, help="categories (the paper's K > 200)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    B, K = args.B, args.K
    rng = np.random.default_rng(0)

    # every row is its OWN unnormalized distribution (theta*phi products in
    # LDA, vocab logits in LLM decode, mixture responsibilities, ...)
    weights = torch.tensor(rng.gamma(0.3, size=(B, K)).astype(np.float32), device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(42)

    # -- the distribution-object API (primary) -------------------------------
    # plan once (autotune resolves here, not per draw), build the
    # Categorical once, draw from it as many times as you like
    for method in ("butterfly", "fenwick", "two_level", "prefix", "gumbel", "kernel"):
        p = sampling.plan(weights, method=method, W=32)
        dist = p.build(weights)              # the paper's table, built once
        idx = p.draw(dist, gen())
        print(f"{method:10s} -> drew {idx.shape[0]} samples, "
              f"first five: {idx[:5].tolist()}")

    # -- frozen-distribution variants -----------------------------------------
    # tables built on the device; draws are O(1) (alias_device) or a
    # fixed-depth root-cached descent (radix_forest)
    for method in ("alias_device", "radix_forest"):
        p = sampling.plan(weights, method=method, draws=16)
        dist = p.build(weights)
        idx = p.draw(dist, gen())
        print(f"{method:12s} -> drew {idx.shape[0]} samples, "
              f"first five: {idx[:5].tolist()}")

    # what would autotune pick for this draw-heavy frozen workload?
    auto = sampling.plan(weights, method="auto", draws=16)
    print(f"auto (draws=16) resolved -> method={auto.table_method!r}")

    # multi-draw reuses the SAME tables: 8 draws per row from one build
    p = sampling.plan(weights, method="fenwick", W=32, draws=8)
    dist = p.build(weights)
    multi = p.draw(dist, gen(), num_samples=8)          # (8, B)
    print(f"multi-draw  -> {tuple(multi.shape)} from one build "
          f"(build_count={sampling.build_count()})")

    # -- the one-shot shim gives the same draws ------------------------------
    legacy = sample_categorical(weights, gen(), method="fenwick", W=32)
    assert torch.equal(legacy, p.draw(dist, gen()))

    # sanity: the empirical marginal of row 0 matches its distribution
    reps = weights[:1].expand(50_000, K).contiguous()
    draws = sample_categorical(reps, gen(), method="butterfly", W=32).cpu().numpy()
    emp = np.bincount(draws, minlength=K) / len(draws)
    tgt = (weights[0] / weights[0].sum()).cpu().numpy()
    print(f"max |empirical - target| over {K} categories: {np.abs(emp - tgt).max():.4f}")


if __name__ == "__main__":
    main()
