"""Draws on given weights: Hopper kernels K2, K3, K4 and the truncated
draws K9, K11, K12, each with its plain version."""
from repro_torch.kernels.butterfly_sample.ops import (
    build_block_sums,
    butterfly_sample,
    butterfly_sample_from_sums,
    butterfly_sample_from_sums_rng,
    butterfly_sample_rng,
    butterfly_sample_truncated,
    butterfly_sample_truncated_rng,
)

__all__ = [
    "build_block_sums",
    "butterfly_sample",
    "butterfly_sample_from_sums",
    "butterfly_sample_from_sums_rng",
    "butterfly_sample_rng",
    "butterfly_sample_truncated",
    "butterfly_sample_truncated_rng",
]
