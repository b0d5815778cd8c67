"""Draws on given weights: Hopper kernels K2, K3, K4 and their plain versions."""
from repro_torch.kernels.butterfly_sample.ops import (
    build_block_sums,
    butterfly_sample,
    butterfly_sample_from_sums,
    butterfly_sample_from_sums_rng,
)

__all__ = [
    "build_block_sums",
    "butterfly_sample",
    "butterfly_sample_from_sums",
    "butterfly_sample_from_sums_rng",
]
