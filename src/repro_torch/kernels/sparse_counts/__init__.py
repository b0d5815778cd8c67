"""The sparse sweep's counts and lists in one pass a document: the Hopper
kernel and its plain version."""

from repro_torch.kernels.sparse_counts.ops import fits, sparse_counts

__all__ = ["fits", "sparse_counts"]
