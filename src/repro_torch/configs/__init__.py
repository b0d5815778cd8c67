"""Run configurations of the port: the ten model architectures (``--arch``
ids resolve through :func:`get_config`), the LDA sweep and the sampler
and serving specs."""

import importlib

from repro_torch.configs.base import (
    ALL_SHAPES,
    LONG_CONTEXT_FAMILIES,
    SHAPES_BY_NAME,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SamplerSpec,
    ServeSpec,
    ShapeConfig,
    SSMConfig,
    shapes_for,
)

_ARCH_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-4b": "qwen3_4b",
    "minicpm3-4b": "minicpm3_4b",
    "llama3-8b": "llama3_8b",
    "gemma2-9b": "gemma2_9b",
    "mamba2-370m": "mamba2_370m",
    "arctic-480b": "arctic_480b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_cells():
    """Every (arch, shape) dry-run cell, honoring the long_500k skip rule."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            cells.append((arch, shape.name))
    return cells


__all__ = [
    "ALL_SHAPES", "ARCH_IDS", "LONG_CONTEXT_FAMILIES", "SHAPES_BY_NAME",
    "MLAConfig", "ModelConfig", "MoEConfig", "SamplerSpec", "ServeSpec",
    "ShapeConfig", "SSMConfig", "all_cells", "get_config", "shapes_for",
]
