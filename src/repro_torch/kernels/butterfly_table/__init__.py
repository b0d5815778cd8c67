"""The paper's butterfly table (Alg. 8): Hopper kernel K1 and its plain version."""
from repro_torch.kernels.butterfly_table.ops import butterfly_table

__all__ = ["butterfly_table"]
