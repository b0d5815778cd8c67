"""Rule-based sharding engine: logical axis names -> mesh axes, the
counterpart of ``repro.dist.sharding``.

Every parameter/cache/activation tensor carries *logical* axis names
(``ParamSpec.axes``: ``vocab``, ``embed``, ``heads``, ``batch``,
``kv_seq``, ...).  This module owns the single mapping from those names to
mesh axes, so the launchers, the mesh fitting and the model code agree on
placement.

The engine is the reference's, rule for rule:

- ``DEFAULT_RULES`` is an ordered list of ``(logical_name, candidates)``
  pairs.  Each candidate is a *group* of mesh-axis names (``("pod",
  "data")`` acts as one fused axis).  Order is priority: earlier rules
  claim mesh axes first.
- Resolution is divisibility-aware: a logical dim takes a candidate group
  only when its size divides by the group's total mesh extent; otherwise
  the next candidate is tried, and replication is the fallback.
- No mesh axis is assigned twice within one spec.

:func:`spec_for_shape` returns a :class:`PartitionSpec`: one entry per
tensor dim, each ``None``, a mesh-axis name, or a tuple of names (the
reference's ``PartitionSpec`` entries).  Rules resolve against a mesh
*description*, anything with ``axis_names`` and a ``shape`` mapping
(:class:`MeshDesc`), so the byte accounting never needs a process group.

On a :class:`~torch.distributed.device_mesh.DeviceMesh` a spec becomes
DTensor placements, one per *mesh* dim: ``Shard(d)`` where the spec puts
that mesh axis on tensor dim ``d``, ``Replicate()`` otherwise
(:func:`placements_for_spec`).  A fused group such as ``("pod", "data")``
shards one tensor dim over both mesh dims; a DTensor splits such a dim in
mesh-dim order, the first mesh dim major, as JAX splits it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# Axis groups.  DATA is every data-parallel degree fused (pod x data on a
# multi-pod mesh, just data on a single pod); MODEL is the tensor-parallel
# axis.  A group resolves against a concrete mesh by dropping the axis
# names that mesh doesn't have.
DATA = ("pod", "data")
MODEL = ("model",)

Rule = Tuple[str, Tuple[Tuple[str, ...], ...]]

# Priority-ordered, as the reference's: ``batch`` must beat ``kv_seq`` to
# the data axes, and ``embed`` must claim data before ``kv_seq``.
DEFAULT_RULES: List[Rule] = [
    ("batch",    (DATA,)),           # rows over every data degree
    ("vocab",    (MODEL,)),          # Megatron-style vocab parallelism
    ("embed",    (DATA,)),           # FSDP: d_model over data axes
    ("experts",  (MODEL,)),          # expert parallelism
    ("heads",    (MODEL,)),          # tensor parallelism over q heads
    ("kv_heads", (MODEL,)),
    ("mlp",      (MODEL,)),          # d_ff, when heads/experts didn't claim it
    ("q_lora",   (MODEL,)),          # MLA latent ranks
    ("kv_lora",  (MODEL,)),
    ("kv_seq",   (DATA, MODEL)),     # cache length: leftovers, greedily
    ("seq",      (MODEL,)),          # input token axis (train/prefill)
    ("act_seq",  (MODEL,)),          # saved-activation sequence sharding
    ("act_kv",   (MODEL,)),          # flash-decoding score/cache seq axis
    ("qblocks",  (DATA,)),           # 8-bit optimizer moment blocks (ZeRO)
]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh-axis name, or a tuple of
    names (the reference's ``jax.sharding.PartitionSpec`` entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class MeshDesc:
    """A mesh *description*, ``axis_names`` plus a ``shape`` mapping, that
    the rules engine and the mesh fitting resolve against without a
    process group."""

    def __init__(self, shape: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)

    def __repr__(self):
        return f"MeshDesc({self.shape})"


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:   # a DeviceMesh
        names = mesh.mesh_dim_names
    return tuple(names or ())


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshDesc` or a DeviceMesh."""
    if isinstance(mesh, MeshDesc):
        return dict(mesh.shape)
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return {n: int(s) for n, s in zip(_axis_names(mesh), mesh.shape)}


def _mesh_extent(shape: Dict[str, int], group: Tuple[str, ...]) -> Tuple[Tuple[str, ...], int]:
    """Resolve a candidate group against a mesh: keep only the axes the
    mesh has, return (resolved_axes, product_of_sizes)."""
    axes = tuple(a for a in group if a in shape)
    return axes, math.prod(int(shape[a]) for a in axes)


def _normalize(entry: Optional[Tuple[str, ...]]):
    """Spec entries: () -> None, 1-tuple -> str, else tuple."""
    if not entry:
        return None
    if len(entry) == 1:
        return entry[0]
    return tuple(entry)


def spec_for_shape(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
                   rules: Optional[List[Rule]] = None) -> PartitionSpec:
    """Map one tensor's logical axes to a :class:`PartitionSpec` on ``mesh``.

    Rules are processed in priority order; for a rule's logical name that
    appears in ``axes``, each candidate group is tried in turn (it must
    resolve to unused mesh axes and divide the dim size evenly) and the
    first hit is assigned.  Unmatched or indivisible dims replicate.
    ``rules`` may prepend overrides (duplicate names: first wins)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    rules = DEFAULT_RULES if rules is None else rules
    axes = tuple(axes)
    mshape = mesh_shape(mesh)
    assignment: List[Optional[Tuple[str, ...]]] = [None] * len(shape)
    used: set = set()
    seen_names: set = set()
    for name, candidates in rules:
        if name in seen_names or name not in axes:
            continue
        seen_names.add(name)
        dim = axes.index(name)
        size = int(shape[dim])
        for group in candidates:
            resolved, extent = _mesh_extent(mshape, group)
            if not resolved or extent <= 1:
                continue
            if any(a in used for a in resolved):
                continue
            if size % extent != 0:
                continue
            assignment[dim] = resolved
            used.update(resolved)
            break
    return PartitionSpec(*(_normalize(e) for e in assignment))


def override_rules(overrides: Dict[str, object], rules: Optional[List[Rule]] = None) -> List[Rule]:
    """A copy of ``rules`` with named entries replaced.

    ``override_rules({"embed": None})`` forces replication of ``embed``; a
    string or tuple value becomes that rule's single candidate group; a
    name the rules lack is prepended."""

    def cands(val):
        if val is None:
            return ()
        if isinstance(val, str):
            return ((val,),)
        return (tuple(val),)

    out: List[Rule] = [(name, cands(overrides[name]) if name in overrides else c)
                       for name, c in (DEFAULT_RULES if rules is None else rules)]
    have = {n for n, _ in out}
    for name, val in overrides.items():
        if name not in have:
            out.insert(0, (name, cands(val)))
    return out


def placements_for_spec(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of a spec on a mesh: one per mesh dim,
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim ``d``,
    ``Replicate()`` otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            where[a] = d
    return tuple(Shard(where[n]) if n in where else Replicate() for n in _axis_names(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a DeviceMesh and its DTensor placements (the counterpart
    of ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec
    placements: Tuple


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
                   rules: Optional[List[Rule]] = None) -> NamedSharding:
    """The :class:`NamedSharding` of one tensor on a DeviceMesh."""
    spec = spec_for_shape(shape, axes, mesh, rules)
    return NamedSharding(mesh, spec, placements_for_spec(spec, mesh))


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map(fn, tree, *rest):
    """``fn`` over dict leaves, in sorted key order (the port's trees)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_shardings(tree, axes_tree, mesh, rules: Optional[List[Rule]] = None):
    """Mirror ``tree`` (tensors, or anything with ``.shape``) with
    :class:`NamedSharding` leaves.  ``axes_tree`` matches ``tree`` with
    logical-axes tuples at the leaves (``models.logical_axes`` output, or
    :func:`optimizer_state_axes`)."""
    return _map(lambda x, ax: named_sharding(tuple(x.shape), ax, mesh, rules), tree, axes_tree)


def local_shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole: the slice its
    coordinates select along each sharded dim (mesh dims in order, so a
    fused group splits first-dim major)."""
    mesh = sharding.mesh
    coords = mesh.get_coordinate()
    for md, p in enumerate(sharding.placements):
        if p.is_shard():
            n = int(mesh.size(md))
            size = x.shape[p.dim] // n
            x = x.narrow(p.dim, coords[md] * size, size)
    return x


def is_sharded(sharding: Optional[NamedSharding]) -> bool:
    """Does the sharding split its tensor over some mesh dim?"""
    return sharding is not None and any(p.is_shard() for p in sharding.placements)


def constrain_tree(tree, shardings):
    """Hold a tree's DTensor leaves to their shardings: a leaf whose
    placements drifted (an update's output takes the placements its ops
    propagate) is redistributed back; other leaves stay as they are."""
    from torch.distributed.tensor import DTensor

    def fix(x, sh):
        if isinstance(x, DTensor) and sh is not None and tuple(x.placements) != sh.placements:
            return x.redistribute(sh.mesh, sh.placements)
        return x

    return _map(fix, tree, shardings)


def device_put(tree, shardings):
    """Place a tree of tensors that every rank holds whole (made from one
    seed) with the given shardings.  Each rank keeps only its own block;
    nothing is communicated.  A leaf that its sharding splits becomes a
    DTensor; a leaf that it replicates on every mesh dim stays the tensor
    itself (the whole tensor on every rank is what ``Replicate()``
    means; under ``implicit_replication`` DTensor ops take it as one), so
    a one-rank mesh runs exactly the unsharded code.  A sharding of
    ``None`` leaves its leaf as it is."""
    from torch.distributed.tensor import DTensor

    def put(x, sh):
        if not is_sharded(sh) or isinstance(x, DTensor):
            return x
        if sh.mesh.get_coordinate() is None:   # a rank outside the mesh holds nothing
            local = x.new_empty((0,) * x.dim())
        else:
            local = local_shard(x, sh).contiguous()
        return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                                  shape=x.shape, stride=x.stride() if x.is_contiguous()
                                  else torch.empty(x.shape, device="meta").stride())

    return _map(put, tree, shardings)


# ---------------------------------------------------------------------------
# optimizer state axes
# ---------------------------------------------------------------------------


def optimizer_state_axes(name: str, param_axes):
    """Logical axes for an optimizer's state tree, leaf-for-leaf:

    - ``adamw``: float32 moments shaped like the param -> same axes.
    - ``adamw8bit``: blockwise-quantized moments in ``(nblocks, QBLOCK)``
      layouts -> ``("qblocks", None)`` for payloads and scales alike.
    - ``adafactor``: factored second moment -> row factor keeps
      ``axes[:-1]``, column factor ``axes[:-2] + axes[-1:]``; vectors keep
      their own axes."""

    def leaf(axes: Tuple[Optional[str], ...]):
        if name == "adamw":
            return {"m": axes, "v": axes}
        if name == "adamw8bit":
            qaxes = ("qblocks", None)
            return {"m_q": qaxes, "m_s": qaxes, "v_q": qaxes, "v_s": qaxes}
        if name == "adafactor":
            if len(axes) >= 2:
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}
        raise ValueError(f"unknown optimizer {name!r}")

    def walk(t):
        if _is_axes_leaf(t):
            return leaf(t)
        return {k: walk(t[k]) for k in sorted(t)}

    return walk(param_axes)


# ---------------------------------------------------------------------------
# activation sharding (a lever inside model forward passes)
# ---------------------------------------------------------------------------

# Process-wide activation-sharding context.  ``mesh`` None (the default)
# makes constrain_activation the identity.
_ACT_CTX: Dict[str, object] = {"mesh": None, "rules": None}


def set_activation_sharding(mesh, rules: Optional[List[Rule]] = None) -> None:
    """Arm (or with ``None`` disarm) activation-sharding constraints.  The
    launchers set it when the group has more than one rank."""
    _ACT_CTX["mesh"] = mesh
    _ACT_CTX["rules"] = rules


def activation_mesh():
    """The armed activation mesh, or ``None``."""
    return _ACT_CTX["mesh"]


def constrain_activation(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor activation to the rules' placements on the
    armed mesh.  A plain tensor, or any tensor when no mesh is armed, is
    returned as it is (the same object)."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sh = named_sharding(tuple(x.shape), axes, mesh, _ACT_CTX["rules"])
    if tuple(x.placements) == sh.placements:
        return x
    return x.redistribute(mesh, sh.placements)


def whole(x):
    """A DTensor gathered whole (``full_tensor``); any other tensor as it
    is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def for_cache(dst, src):
    """``src`` as an in-place write into the cache ``dst`` takes it: a
    plain cache (the serve engine's) takes a DTensor ``src`` gathered
    whole, since DTensor does not dispatch a write into a plain tensor; a
    DTensor cache takes ``src`` as it is."""
    return src if hasattr(dst, "full_tensor") else whole(src)


def gather_dim(x, dim: int):
    """A DTensor with tensor dim ``dim`` made whole (each mesh dim that
    shards it, or holds partial sums, replicated); any other tensor as it
    is.  The port's answer
    to a DTensor op whose sharding rule is missing or wrong for that dim:
    it gathers the operand at the op (ROADMAP.md, deliberate
    differences)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    pl = tuple(Replicate() if p.is_shard(dim) or p.is_partial() else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


# ---------------------------------------------------------------------------
# per-device byte accounting (shared by the mesh fitting)
# ---------------------------------------------------------------------------


def shard_fraction(shape, axes, mesh, rules: Optional[List[Rule]] = None) -> int:
    """The total mesh extent this tensor divides over (1 = replicated)."""
    mshape = mesh_shape(mesh)
    div = 1
    for entry in spec_for_shape(shape, axes, mesh, rules):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            div *= int(mshape[a])
    return div


def tree_bytes_per_device(spec_tree, mesh, itemsize: float = 2.0,
                          rules: Optional[List[Rule]] = None) -> float:
    """Per-device resident bytes of a ParamSpec tree under the rules: the
    path ``smallest_fitting_mesh(specs=...)`` searches with, so the
    estimate and the real placement agree by construction.  ``mesh`` may
    be a description."""
    from repro_torch.models.params import tree_leaves

    total = 0.0
    for sp in tree_leaves(spec_tree):
        div = shard_fraction(sp.shape, sp.axes, mesh, rules)
        total += float(math.prod(sp.shape)) * itemsize / div
    return total
