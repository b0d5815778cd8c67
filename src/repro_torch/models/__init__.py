"""LM model stack: params specs, layers, GQA attention, the decoder-only
backbone and the family dispatch (the dense family; the others come with
ROADMAP.md queue 1, slice 12b)."""

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
