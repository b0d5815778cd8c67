"""LM model stack: params specs, layers, attention variants (GQA, MLA,
cross), SSM, MoE, the decoder-only and encoder-decoder backbones and the
family dispatch."""

from repro_torch.models.model import Model, build_model
from repro_torch.models.params import (
    ParamSpec,
    abstract_params,
    init_params,
    logical_axes,
    param_bytes,
    param_count,
    params_from_numpy,
)

__all__ = [
    "Model", "build_model", "ParamSpec", "abstract_params", "init_params",
    "logical_axes", "param_bytes", "param_count", "params_from_numpy",
]
