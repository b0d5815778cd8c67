"""The sparse LDA MH sweep: Hopper kernel S1 and its plain version."""

from repro_torch.kernels.sparse_mh.ops import mh_sweep

__all__ = ["mh_sweep"]
