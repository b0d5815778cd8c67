"""Parameter specs: single source of truth for shapes, logical sharding axes
and initialization, the counterpart of ``repro.models.params``.

Modules declare ``ParamSpec`` trees (nested dicts whose leaves are specs);
the same tree materializes real tensors (:func:`init_params`), meta-device
tensors that allocate nothing (:func:`abstract_params`), and per-leaf
logical axes (:func:`logical_axes`).  Trees are walked in sorted key
order, as JAX flattens dicts, so leaf ``i`` is the same leaf in both
packages.

:func:`params_from_numpy` carries a tree of arrays across (the
reference's parameters or caches, as numpy), with the same nested keys and
stacked ``(L, ...)`` layer leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import runtime


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones
    scale: float = 1.0                # stddev multiplier for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, passed leaf by leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order (JAX's dict order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _fan_in(spec: ParamSpec) -> int:
    """Axes-aware fan-in for the einsum contractions these params feed.

    'embed' anywhere but last => the contraction is over d_model (wq/wk/wv,
    w_gate/w_up, unembed, routers — including stacked/expert leading dims).
    'embed' last => the output is d_model; fan-in is everything else except
    batching dims (wo: heads*head_dim; w_down: d_ff).  Fallback: product of
    all but the last dim (minus stacked dims) — never *under*-estimates, so
    inits err small rather than exploding.
    """
    axes = spec.axes
    shape = spec.shape
    batchy = {"layers", "experts"}
    if "embed" in axes[:-1]:
        return shape[axes.index("embed")]
    prod = 1
    for name, size in zip(axes[:-1], shape[:-1]):
        if name in batchy:
            continue
        prod *= size
    return max(prod, 1)


def _leaf_init(g: torch.Generator, spec: ParamSpec, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    # fan-in scaled normal: std = scale / sqrt(fan_in), drawn in float32
    std = spec.scale / np.sqrt(_fan_in(spec))
    if spec.axes and spec.axes[0] == "layers":
        # a stacked leaf one layer at a time (a stacked expert leaf one
        # expert at a time): the float32 draw of the largest leaf would
        # otherwise need twice its final size
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        per = 2 if spec.axes[1:2] == ("experts",) else 1
        for idx in np.ndindex(*spec.shape[:per]):
            out[idx] = (torch.randn(spec.shape[per:], generator=g, device=device) * std).to(dtype)
        return out
    return (torch.randn(spec.shape, generator=g, device=device) * std).to(dtype)


def init_params(generator: Union[int, torch.Generator], specs, dtype=torch.float32,
                device=None):
    """Materialize a spec tree into tensors, leaf by leaf in sorted key
    order from one ``torch.Generator`` (or a seed, for a generator on
    ``device``).  ``device=None`` is the card; pass ``"cpu"`` for the CPU.
    The values are the port's own: to run the reference's weights, carry
    them across with :func:`params_from_numpy`."""
    dev = runtime.resolve_device(device)
    g = generator
    if not isinstance(g, torch.Generator):
        g = torch.Generator(device=dev).manual_seed(int(g))
    return tree_map(lambda s: _leaf_init(g, s, dtype, dev), specs)


def abstract_params(specs, dtype=torch.bfloat16):
    """Meta-device tensors of the spec tree's shapes (no allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def logical_axes(specs):
    """Tree of logical-axis tuples, mirroring the params tree."""
    return tree_map(lambda s: s.axes, specs)


def param_count(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for s in tree_leaves(specs)))


def param_bytes(specs, dtype=torch.bfloat16) -> int:
    return param_count(specs) * torch.empty((), dtype=dtype).element_size()


def stack_layer_specs(spec: ParamSpec, num_layers: int) -> ParamSpec:
    """Add a leading stacked-layers dimension to a spec."""
    return ParamSpec(
        shape=(num_layers,) + spec.shape,
        axes=("layers",) + spec.axes,
        init=spec.init,
        scale=spec.scale,
    )


def stack_specs_tree(specs, num_layers: int):
    return tree_map(lambda s: stack_layer_specs(s, num_layers), specs)


def _from_array(x, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: no numpy bridge
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(arr))   # a writable copy: caches are written in place
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device=None, dtype=None):
    """A tree of arrays (the reference's parameters or caches, as numpy:
    the same nested keys, stacked ``(L, ...)`` layer leaves) as the port's
    tensors on ``device`` (``None``: the card), cast to ``dtype`` when it
    is given."""
    dev = runtime.resolve_device(device)
    return tree_map(lambda x: _from_array(x, dev, dtype), tree)
