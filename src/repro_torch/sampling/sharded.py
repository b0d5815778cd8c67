"""Mesh-sharded draws on ``torch.distributed``: per-shard kernels and the
counter RNG, the counterpart of ``repro.sampling.sharded``.

The paper's technique wins by keeping every access local to one device;
this module keeps that win when the batch spans a mesh.  Row-sharded
weights and tables stay where they live, every shard runs the same
kernels the single-device path runs, and every random number comes from
the counter RNG (:mod:`repro_torch.kernels.rng`) seeded by one key that
every rank holds, so **the draw path issues no collective**.

Layout, on a :class:`~torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names`` (``DATA_AXES`` name the row axes; ``spec=`` overrides
them)::

    weights / logits (B, K)  Shard(0) on each row axis, Replicate() on the others
    tables / state           the same, built per shard from its rows
    key                      a raw (2,) uint32 pair or an int, on every rank
    draws (B,)               Shard(0); (S, B) draws Shard(1)

Row-sharded arrays are DTensors (:func:`place_rows` makes them with
``distribute_tensor``).  An entry point takes a DTensor and draws from its
``to_local()`` rows, or a plain tensor holding the whole (B, K) array on
every rank, of which each rank takes its own rows; it returns DTensors made
by ``DTensor.from_local(..., run_check=False, shape=, stride=)``, which
communicates nothing.  The per-shard bodies (``_shard_*``) see local
tensors only, so no DTensor sharding rule can insert a collective.

A shard's rows start at global row ``row0 = linear index * B / shards``,
its position along the row axes linearised in the mesh's order (the
order in which a DTensor stacks its shards).  Counters are global rows,
so a row's uniforms are the same for 1, 2 or 8 ranks at a fixed key.  The
kernels sum each row in a fixed order whatever the batch (K2-K5, K8,
K9-K12), so their draws are bit-identical at any rank count.  Tables
built by PyTorch's CUDA scans and reductions (``torch.cumsum`` in
``prefix``, ``fenwick``, ``two_level``, ``radix_forest``) may sum in an
order that depends on the number of rows; their draws then differ only
at float64-checked boundary ties (on the CPU they are bit-identical).

The ``kernel`` method draws one token per row with the fused seeded
kernels: K5 (``butterfly_sample_rng``) and, under a truncation chain, K10
(``butterfly_sample_truncated_rng``).  S draws per row under a chain take
the threshold, K11 and K12 on ``rng.multi_row_uniforms``, where the
reference masks the weights and builds ``kernel`` state: the same masked
sums and walks, so the same draws.  Every other method builds its state
per shard and draws through ``distribution._draw_u`` with counter
uniforms; ``gumbel`` and the alias methods use the ``TAG_GUMBEL``,
``TAG_ALIAS_J`` and ``TAG_ALIAS_A`` streams.

Entry points are reached through :func:`repro_torch.sampling.plan` with
``mesh=`` (and ``spec=``): ``build`` / ``draw`` / ``sample`` /
``sample_logits`` route here.  The reference memoises jitted shard_map
closures; here nothing is compiled and nothing is memoised.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.core import alias as _alias
from repro_torch.kernels import rng as _rng
from repro_torch.kernels.butterfly_sample import ops as _kops
from repro_torch.sampling import distribution as _dist
from repro_torch.sampling import transforms as _tr
from repro_torch.sampling.distribution import Categorical

# mesh axes a batch may shard over (model axes never shard the draw: K
# stays whole, so the in-shard walk is local)
DATA_AXES = ("pod", "data")


def _names(mesh) -> Tuple[str, ...]:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh)}")
    names = tuple(mesh.mesh_dim_names or ())
    if len(names) != mesh.ndim:
        raise ValueError("sharded draws need a DeviceMesh with mesh_dim_names")
    return names


def data_axes(mesh, spec=None) -> Tuple[str, ...]:
    """The mesh axes batch rows shard over.

    Default: every ``pod``/``data`` axis the mesh has, in the mesh's order
    (its first axis for a mesh without either).  ``spec`` (a tuple laid out
    as a ``PartitionSpec``) overrides: its entry 0 names the row axes, a
    name or a tuple of names in the mesh's order; e.g. ``("pod",)`` on a
    ("pod", "data") mesh shards rows over pods only."""
    names = _names(mesh)
    if spec is not None:
        entry = spec[0] if len(spec) else None
        if entry is None:
            raise ValueError(
                f"spec {spec} does not shard axis 0; sharded draws need "
                "row-sharded batches"
            )
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names axes {missing} not on the mesh {names}")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(
                f"spec {spec} names the row axes out of the mesh's order {names}; "
                "a DTensor stacks its shards in mesh order"
            )
        return axes
    axes = tuple(a for a in names if a in DATA_AXES)
    return axes or names[:1]


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[_names(mesh).index(name)])


def data_size(mesh, spec=None) -> int:
    """Number of shards the batch rows split into."""
    return math.prod(_axis_size(mesh, a) for a in data_axes(mesh, spec))


def row_spec(mesh, spec=None) -> Tuple:
    """DTensor placements sharding dimension 0 over the row axes."""
    axes = data_axes(mesh, spec)
    return tuple(Shard(0) if n in axes else Replicate() for n in _names(mesh))


def mesh_signature(mesh, spec=None) -> Tuple:
    """Hashable topology signature: axis names and sizes, ranks, device
    type and spec.  Part of every sharded plan's memo key, so two
    topologies never share a plan."""
    if mesh is None:
        return ()
    ranks = mesh.mesh
    return (
        _names(mesh),
        tuple(int(s) for s in ranks.shape),
        tuple(int(r) for r in ranks.flatten().tolist()),
        mesh.device_type,
        "" if spec is None else str(spec),
    )


def _linear_index(mesh, spec=None) -> int:
    """This rank's position along the row axes, linearised in mesh order:
    its shard of the rows (a host integer)."""
    idx = 0
    for a in data_axes(mesh, spec):
        idx = idx * _axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return idx


class _Layout(NamedTuple):
    mesh: object
    shards: int
    index: int            # this rank's shard (linear index)
    placements: Tuple     # row placements of dimension 0


def _layout(mesh, spec=None) -> _Layout:
    return _Layout(mesh, data_size(mesh, spec), _linear_index(mesh, spec),
                   row_spec(mesh, spec))


def reset_sharded_cache() -> None:
    """Kept for the reference's API (``plan.reset_plans`` calls it): the
    reference drops its memoised jitted closures here; the port compiles
    nothing and memoises nothing per mesh."""


# ---------------------------------------------------------------------------
# Local rows in, DTensors out
# ---------------------------------------------------------------------------


def _local_rows(lay: _Layout, x, B: int, what: str, shape=None) -> torch.Tensor:
    """This rank's rows of ``x``: a DTensor's local tensor once it is
    row-sharded (redistributed to the rows' placements if it is not), or
    rows [index * B/shards, (index + 1) * B/shards) of a plain tensor
    holding the whole array.  ``shape`` checks the global shape."""
    if isinstance(x, DTensor):
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"plan was made for shape {tuple(shape)}, got {what} of "
                             f"shape {tuple(x.shape)}")
        if tuple(x.placements) != lay.placements:
            # shard_map's in_specs: any other placement (a model's Partial
            # or vocab-sharded logits) is redistributed to the row layout
            x = x.redistribute(lay.mesh, lay.placements)
        return x.to_local()
    x = torch.as_tensor(x)
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"plan was made for shape {tuple(shape)}, got {what} of "
                         f"shape {tuple(x.shape)}")
    if x.shape[0] != B or B % lay.shards:
        raise ValueError(f"{what}: {x.shape[0]} rows do not split into {lay.shards} shards "
                         f"of a {B}-row batch")
    n = B // lay.shards
    return x.narrow(0, lay.index * n, n)


def _per_row(lay: _Layout, v, B: int, what: str):
    """A scalar stays; a (B,) per-row parameter gives this rank's rows."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return _local_rows(lay, v, B, what)
    return v


def _from_local(lay: _Layout, local: torch.Tensor, row_dim: int = 0) -> DTensor:
    """The DTensor whose shards are every rank's ``local`` (rows along
    ``row_dim``), made without communicating."""
    local = local.contiguous()
    shape = list(local.shape)
    shape[row_dim] *= lay.shards
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    placements = tuple(Shard(row_dim) if isinstance(p, Shard) else p
                       for p in lay.placements)
    return DTensor.from_local(local, lay.mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _draws_out(lay: _Layout, idx: torch.Tensor) -> DTensor:
    """(B_loc,) or (S, B_loc) local draws as the global (B,) / (S, B)."""
    return _from_local(lay, idx, row_dim=idx.dim() - 1)


def _require_key(key) -> None:
    if key is None:
        raise ValueError("sharded draws derive all randomness from a key; "
                         "pass key= (u= is not accepted)")


def _plan_layout(plan) -> _Layout:
    lay = _layout(plan.mesh, plan.spec)
    if plan.shape[0] % lay.shards:
        raise ValueError(f"cannot shard B={plan.shape[0]} rows over {lay.shards} shards")
    return lay


# ---------------------------------------------------------------------------
# The per-shard bodies: local tensors only, all randomness from counters
# ---------------------------------------------------------------------------


def _local_draw(dist: Categorical, seed, row0: int, num_samples: int) -> torch.Tensor:
    """Draw from a shard-local Categorical with counter RNG.

    ``seed`` is the raw (2,) seed (``rng.seed_from_key(key)``) and
    ``row0`` the shard's first global row: every random number is a pure
    function of (seed, global row, draw index), never of the shard count.
    The key-driven variants get their own tagged streams."""
    B, K = dist.shape
    dev = dist.device
    rows = int(row0) + torch.arange(B, dtype=torch.int64, device=dev)

    def per_draw(one):
        if num_samples == 1:
            return one(0)
        return torch.stack([one(s) for s in range(num_samples)])

    if dist.method == "gumbel":
        logw = dist.state["logw"].to(torch.float32)
        cols = torch.arange(K, dtype=torch.int64, device=dev)
        tiny = torch.finfo(torch.float32).tiny

        def gumbel(s):
            sd = _rng.fold(seed, _rng.TAG_GUMBEL, s).to(dev)
            u = _rng.uniform(sd, rows[:, None], cols[None, :])
            g = -torch.log(-torch.log(u.clamp(min=tiny)))
            return torch.argmax(logw + g, dim=-1).to(torch.int32)

        return per_draw(gumbel)
    if dist.method in ("alias", "alias_device"):
        table = _alias.AliasTable(prob=dist.state["prob"], alias=dist.state["alias"])

        def alias(s):
            uj = _rng.uniform(_rng.fold(seed, _rng.TAG_ALIAS_J, s).to(dev), rows)
            ua = _rng.uniform(_rng.fold(seed, _rng.TAG_ALIAS_A, s).to(dev), rows)
            return _alias.draw_alias_batch(table, u=(uj, ua))

        return per_draw(alias)
    sd = _rng.fold(seed, _rng.TAG_U, 0).to(dev)
    if num_samples == 1:
        return _dist._draw_u(dist, _rng.row_uniforms(sd, row0, B))
    return _dist.draw(dist, u=_rng.multi_row_uniforms(sd, row0, B, num_samples))


def _local_dist(method: str, W: int, state, shape, tb: int = 0) -> Categorical:
    return Categorical(method=method, W=W, shape=tuple(shape), state=state, tb=tb)


def _shard_sample(method: str, W: int, w: torch.Tensor, seed, row0: int,
                  num_samples: int = 1) -> torch.Tensor:
    """One shard's build + draw on its (B_loc, K) weights; the ``kernel``
    method's single draw is K5 (uniforms made in the kernel)."""
    if method == "kernel" and num_samples == 1:
        return _kops.butterfly_sample_rng(w, seed, row_offset=row0, W=W)
    d = _local_dist(method, W, _dist._build_state(method, w, W), w.shape)
    return _local_draw(d, seed, row0, num_samples)


def _shard_sample_logits(method: str, W: int, z: torch.Tensor, temperature, seed,
                         row0: int, num_samples: int = 1) -> torch.Tensor:
    """One shard's softmax + build + draw on its logits; ``gumbel`` stays
    in logit space."""
    if method == "gumbel":
        zt = _dist._scale_by_temperature(z, temperature)
        d = _local_dist(method, W, {"logw": zt.to(torch.float32)}, z.shape)
        return _local_draw(d, seed, row0, num_samples)
    return _shard_sample(method, W, _dist.logits_to_weights(z, temperature), seed, row0,
                         num_samples)


def _shard_sample_truncated(method: str, W: int, z: torch.Tensor, temperature,
                            params: torch.Tensor, seed, row0: int,
                            num_samples: int = 1) -> torch.Tensor:
    """One shard's truncated draw: thresholds are row-local.  ``kernel``
    draws one token per row with K10 and S per row with tau, K11 and K12
    on ``rng.multi_row_uniforms``; other methods mask by the threshold
    and build their state from the masked weights."""
    w = _dist.logits_to_weights(z, temperature)
    if method == "kernel":
        if num_samples == 1:
            return _kops.butterfly_sample_truncated_rng(w, seed, params, row_offset=row0,
                                                        W=W)
        sd = _rng.fold(seed, _rng.TAG_U, 0).to(w.device)
        us = _rng.multi_row_uniforms(sd, row0, w.shape[0], num_samples)
        return _kops.butterfly_sample_truncated(w, us, params, W=W, route="two_pass")
    tau = _tr.thresholds_from_params(w, params)
    wm = torch.where(w.to(torch.float32) >= tau[:, None], w, torch.zeros_like(w))
    d = _local_dist(method, W, _dist._build_state(method, wm, W), w.shape)
    return _local_draw(d, seed, row0, num_samples)


# ---------------------------------------------------------------------------
# Entry points (reached through SamplerPlan when plan(mesh=...) was given)
# ---------------------------------------------------------------------------


def _state_leaf(lay: _Layout, v) -> torch.Tensor:
    """A state leaf's local rows: a DTensor's shard, or this rank's share
    of dimension 0 of a plain tensor holding the whole state."""
    if isinstance(v, DTensor):
        return v.to_local()
    return _local_rows(lay, v, v.shape[0], "state")


def build_sharded(plan, weights) -> Categorical:
    """Pass A per shard: a :class:`Categorical` whose state leaves are
    DTensors sharded like the rows that built them."""
    lay = _plan_layout(plan)
    B, K = plan.shape
    w = _local_rows(lay, weights, B, "weights", shape=plan.shape)
    _dist._note_build()
    state = _dist._build_state(plan.table_method, w, plan.W)
    return Categorical(method=plan.table_method, W=plan.W, shape=(B, K),
                       state={k: _from_local(lay, v) for k, v in state.items()},
                       tb=plan.tb)


def draw_sharded(plan, dist: Categorical, key, num_samples: int = 1) -> DTensor:
    """Draw from a sharded distribution: each shard walks its own rows with
    uniforms from (global row, draw) counters.  (B,) draws sharded like
    the rows; (num_samples, B) for several draws per row."""
    _require_key(key)
    B, K = dist.shape
    if dist.method in _dist.FACTORED_VARIANTS:
        raise ValueError(
            f"{dist.method!r} state indexes *local* factor rows: row-sharding a "
            "globally built factored distribution would leave doc_ids pointing "
            "past each shard's theta.  Draw factored state per shard instead "
            "(see repro_torch.lda.distributed.make_sharded_gibbs)"
        )
    if (B, K) != tuple(plan.shape):
        raise ValueError(
            f"plan was made for shape {plan.shape}, got a distribution of shape "
            f"{(B, K)}: global row counters would overlap across shards; plan the "
            "distribution's own shape"
        )
    lay = _plan_layout(plan)
    state = {k: _state_leaf(lay, v) for k, v in dist.state.items()}
    Bloc = B // lay.shards
    d = _local_dist(dist.method, dist.W, state, (Bloc, K), dist.tb)
    return _draws_out(lay, _local_draw(d, _rng.seed_from_key(key), lay.index * Bloc,
                                       num_samples))


def sample_sharded(plan, weights, key, num_samples: int = 1) -> DTensor:
    """One-shot build + draw per shard; a ``kernel`` plan's single draw
    launches K5 with in-kernel counter uniforms."""
    _require_key(key)
    lay = _plan_layout(plan)
    B = plan.shape[0]
    w = _local_rows(lay, weights, B, "weights", shape=plan.shape)
    row0 = lay.index * (B // lay.shards)
    return _draws_out(lay, _shard_sample(plan.table_method, plan.W, w,
                                         _rng.seed_from_key(key), row0, num_samples))


def sample_logits_sharded(plan, logits, key, temperature=1.0, num_samples: int = 1,
                          transforms=None) -> DTensor:
    """The sharded serving path: softmax + build + draw per shard.  A
    ``gumbel`` plan draws in logit space; a ``kernel`` plan's single draw
    is K5.  ``transforms`` (the canonical top-k -> top-p -> min-p chain)
    routes to :func:`sample_logits_truncated_sharded`.  ``temperature`` is
    a scalar or a (B,) per-row tensor."""
    if transforms:
        return sample_logits_truncated_sharded(plan, logits, key, temperature=temperature,
                                               num_samples=num_samples,
                                               transforms=transforms)
    _require_key(key)
    lay = _plan_layout(plan)
    B = plan.shape[0]
    z = _local_rows(lay, logits, B, "logits", shape=plan.shape)
    # a float32 operand, as the reference passes it: bf16 logits give
    # float32 weights
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.as_tensor(temperature, dtype=torch.float32)
    t = _per_row(lay, temperature, B, "temperature")
    row0 = lay.index * (B // lay.shards)
    return _draws_out(lay, _shard_sample_logits(plan.table_method, plan.W, z, t,
                                                _rng.seed_from_key(key), row0,
                                                num_samples))


def sample_logits_truncated_sharded(plan, logits, key, temperature=1.0,
                                    num_samples: int = 1, transforms=()) -> DTensor:
    """Truncated decode, sharded: temperature and top-k / top-p / min-p per
    shard, parameters scalar or per row (sharded with the rows).  The
    thresholds are row-local and the uniforms are (seed, global row)
    counters, so the draw path has no collective and tokens are the same
    at any rank count; a ``kernel`` plan's single draw is K10."""
    _require_key(key)
    lay = _plan_layout(plan)
    B = plan.shape[0]
    z = _local_rows(lay, logits, B, "logits", shape=plan.shape)
    kpm = _tr.canonical_params(transforms, B, device=z.device)
    if kpm is None:
        raise ValueError(
            "sharded truncation needs the canonical TopK -> TopP -> MinP chain "
            "(repro_torch.sampling.transforms.chain); reorder or pre-mask the "
            "weights and use plan.sample instead"
        )
    temp = _tr._row(_tr.temperature_of(transforms, temperature), B, device=z.device)
    prm = _local_rows(lay, kpm, B, "params").contiguous()
    t = _local_rows(lay, temp, B, "temperature")
    row0 = lay.index * (B // lay.shards)
    return _draws_out(lay, _shard_sample_truncated(plan.table_method, plan.W, z, t, prm,
                                                   _rng.seed_from_key(key), row0,
                                                   num_samples))


def place_rows(mesh, *arrays):
    """Arrays as DTensors row-sharded over the mesh's data axes
    (``distribute_tensor``: rank 0's copy is scattered), for callers that
    stage inputs before a sharded plan call."""
    placements = row_spec(mesh)
    out = tuple(distribute_tensor(torch.as_tensor(a), mesh, placements) for a in arrays)
    return out[0] if len(out) == 1 else out
