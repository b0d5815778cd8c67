"""On-device alias table construction (split-based PSA build): Hopper
kernel K13 and its plain version."""

from repro_torch.kernels.alias_build.ops import build_alias_tables_device

__all__ = ["build_alias_tables_device"]
