"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake
process group, the counterpart of ``repro.launch.dryrun``.

For each cell this makes abstract inputs (``FakeTensor``s: nothing is
allocated), places parameters, optimizer state, batch and caches as
DTensors through the rules engine (``dist.sharding``) on the production
mesh of a *fake* process group of 256 or 512 ranks, runs the step the
launchers run (``train.train_step.make_train_step``,
``serve.engine.make_prefill_step`` / ``make_serve_step`` with ``mesh=``)
under ``FakeTensorMode``, and records per device what the reference reads
from XLA: memory (arguments, outputs, temporaries, aliased arguments),
cost (FLOPs, bytes accessed) and collectives.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
    python -m repro_torch.launch.dryrun --device cpu --smoke --arch llama3-8b ...

The counts come from one dispatch mode over the trace (:class:`StepTally`)
that sees each DTensor op after DTensor has split it into the ops on rank
0's local shards, so every number is per device, as the reference's
partitioned module's are:

* ``memory``: ``argument_bytes`` are rank 0's local shards of the step's
  inputs; ``temp_bytes`` and ``output_bytes`` come from the storages the
  step makes (their peak above the arguments, less what its outputs hold
  at the end, and that); ``alias_bytes`` are the arguments the step
  writes in place (the decode caches).  ``peak_bytes`` = arguments +
  outputs + temporaries; ``by_argument`` splits the arguments by tree;
  ``peak_top`` lists the five largest storages live at the peak (bytes,
  shape, dtype, the op that made them).
* ``cost``: ``flops`` by ``torch.utils.flop_counter``'s formulas on the
  local ops; ``bytes_accessed`` every op's inputs read and outputs written
  once (eager PyTorch fuses nothing), plus the bytes each hand-written
  kernel's fake rule reckons (``kernels.fake``).  ``flops_top`` names the
  ops (with their local input shapes) that hold the most FLOPs.
* ``collectives``: every functional collective DTensor (or the port)
  issues, as :func:`collective_bytes` sums them (the reference's keys);
  ``collectives_by`` groups them by kind and output shapes.  The port's
  gather sites (ROADMAP.md, deliberate differences) show here as
  all-gathers that XLA's partitioner does not emit.

The sampler kernels have fake rules, so a traced decode or prefill step
takes the kernel route the card runs; ``kernel_calls`` counts them.
``lower_s`` holds the trace's seconds; the reference's ``compile_s`` has
no counterpart.  The step's host integers (the train step, the decode
position, the draw's key) are host values in the port: the trace passes
step 0, the cache's last position and key 0, which decide no shape.

Importing this module brings up no process group: :func:`main` (the CLI)
does, as the reference's entry point alone sets ``XLA_FLAGS``.  Callers
bring one up with :func:`fake_process_group` before building a mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, all_cells, get_config
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.kernels import fake as _fake
from repro_torch.models import build_model, logical_axes, param_count
from repro_torch.models.params import tree_map

# functional collective -> the reference's HLO op name
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------


def fake_process_group(world_size: int = 512) -> int:
    """Bring up a fake process group of ``world_size`` ranks with this
    process as rank 0 (``torch.testing``'s ``FakeStore``: nothing is
    communicated; collectives return tensors of the right shape).  Returns
    the world size of the group, which may already be up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    return dist.get_world_size()


@contextlib.contextmanager
def _dtensor_under_fake():
    """DTensor under ``FakeTensorMode``, for the trace only.

    DTensor treats an active fake mode as compile-time tracing with
    symbolic shapes: it then re-derives every op's sharding (and every
    redistribution's cost) uncached, which makes a full-width step take
    many minutes.  The dry-run's shapes are static, so the caches hold;
    DTensor's own eager path is restored on exit.  DTensor's strided-shard
    bookkeeping computes shard sizes with small tensors of indices: those
    run on the host, outside the fake mode (integers, never data)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import _dispatch, _redistribute, _sharding_prop
    from torch.distributed.tensor.placement_types import _StridedShard

    mods = (fc, _dispatch, _redistribute, _sharding_prop)
    saved = [m._are_we_tracing for m in mods]
    strided = _StridedShard.local_shard_size_and_offset

    def on_host(self, *a, **k):
        with unset_fake_temporarily():
            return strided(self, *a, **k)

    for m in mods:
        m._are_we_tracing = lambda: False
    _StridedShard.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m._are_we_tracing = f
        _StridedShard.local_shard_size_and_offset = strided


# ---------------------------------------------------------------------------
# the per-device tally of a traced step
# ---------------------------------------------------------------------------


def _tensors(x):
    """The tensors in a nested structure of dicts, lists, tuples and
    named tuples."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's local tensor of a DTensor; any other tensor as it is."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def tree_bytes(tree) -> int:
    """Bytes of the storages of a tree's local tensors (rank 0's shards),
    each storage once."""
    sts = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        sts[id(st)] = int(st.nbytes())
    return sum(sts.values())


class StepTally:
    """Per-device counts of a traced step, taken by a dispatch mode
    (:meth:`counting`).

    Ops on DTensors are handed back to DTensor (``NotImplemented``), which
    runs them as ops on the local shards (and collectives); those come
    back here and are counted.  Ops that DTensor runs to propagate
    shapes (on global shapes) are not counted.  Counts: ``flops``
    (``torch.utils.flop_counter``'s formulas), ``bytes`` (inputs and
    outputs of every op that is not a view or an allocation),
    ``collectives`` ((kind, output shapes, bytes) per op), and the bytes of the
    storages the step makes, live and at their peak."""

    def __init__(self):
        self.flops = 0
        self.flops_by: Dict[str, int] = {}   # "op input shapes" -> FLOPs
        self.bytes = 0
        self.collectives: List[tuple] = []
        self.live = 0
        self.peak = 0
        self.known: Dict[int, int] = {}     # storage id -> bytes (arguments, made)
        self.made: Dict[int, int] = {}      # storages the step made, still live
        self.written: Dict[int, int] = {}   # argument storages written in place
        self.what: Dict[int, tuple] = {}    # made storage -> (bytes, shape, dtype, op)
        self.peak_seen = 0
        self.peak_top: List[tuple] = []

    # -- storages ------------------------------------------------------------

    def add_arguments(self, tree) -> int:
        """Mark the storages of ``tree``'s local tensors as arguments;
        returns their bytes (each storage once)."""
        total = 0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if id(st) not in self.known:
                self.known[id(st)] = int(st.nbytes())
                total += self.known[id(st)]
        return total

    def _made(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.known:
            return
        n = int(st.nbytes())
        self.known[key] = n
        self.made[key] = n
        self.what[key] = (n, tuple(t.shape), str(t.dtype).replace("torch.", ""), op)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            if self.peak > 1.01 * self.peak_seen:   # the largest storages at the peak
                self.peak_seen = self.peak
                self.peak_top = sorted((self.what[k] for k in self.made), reverse=True)[:5]
        weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        n = self.made.pop(key, None)
        self.what.pop(key, None)
        self.known.pop(key, None)
        if n is not None:
            self.live -= n

    def bytes_held(self, tree) -> int:
        """Bytes of the storages made during the step that ``tree`` holds."""
        seen = set()
        for t in _tensors(tree):
            key = id(_local(t).untyped_storage())
            if key in self.made:
                seen.add(key)
        return sum(self.made[k] for k in seen)

    # -- the mode -----------------------------------------------------------

    @contextlib.contextmanager
    def counting(self):
        """Count every op run inside the block (with :func:`_dtensor_under_fake`)."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        depth = [0]

        def propagate(self_, *a, **k):
            depth[0] += 1
            try:
                return prop(self_, *a, **k)
            finally:
                depth[0] -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        try:
            with _dtensor_under_fake(), _TallyMode(self, depth):
                yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = prop

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if n:
                key = f"{packet} {[tuple(t.shape) for t in _tensors(args)]}"
                self.flops_by[key] = self.flops_by.get(key, 0) + n
        ns = func.namespace
        name = packet.__name__
        # a meta tensor (a shape's strides, say) holds no memory and moves nothing
        outs = [t for t in _tensors(out) if t.device.type != "meta"]
        if ns in ("_c10d_functional", "_dtensor") and name in _COLLECTIVE_KINDS:
            self.collectives.append((_COLLECTIVE_KINDS[name], [tuple(t.shape) for t in outs],
                                     sum(t.numel() * t.element_size() for t in outs)))
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if not view and not (ns == "aten" and name.startswith(("empty", "new_empty"))) \
                and ns != "prim":
            ins = {id(t): t for t in _tensors((args, kwargs)) if t.device.type != "meta"}
            self.bytes += sum(t.numel() * t.element_size() for t in ins.values())
            self.bytes += sum(t.numel() * t.element_size() for t in outs)
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write and i < len(args):
                for t in _tensors(args[i]):
                    key = id(t.untyped_storage())
                    if key in self.known and key not in self.made:
                        self.written[key] = self.known[key]
        for t in outs:
            self._made(t, str(packet))

    def flops_top(self, n: int = 8) -> List[list]:
        """The ``n`` (op, input shapes) groups of the most FLOPs: [FLOPs,
        "op [shapes]", share of the step's]."""
        top = sorted(self.flops_by.items(), key=lambda kv: -kv[1])[:n]
        return [[f, k, f / max(self.flops, 1)] for k, f in top]

    def result(self, outputs) -> Dict:
        """The memory fields the step's storages give, ``outputs`` held."""
        out = self.bytes_held(outputs)
        return {"output_bytes": out, "temp_bytes": max(self.peak - out, 0),
                "alias_bytes": sum(self.written.values()),
                "peak_top": [list(w) for w in self.peak_top]}


class _TallyMode(TorchDispatchMode):
    """:class:`StepTally`'s dispatch mode; ``depth[0]`` > 0 while DTensor
    propagates shapes."""

    def __init__(self, tally: StepTally, depth):
        super().__init__()
        self.tally, self.depth = tally, depth

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default and _fake.is_fake(args[0]):
            # a fake wait returns a new tensor where the eager wait returns
            # its input
            return args[0]
        out = func(*args, **kwargs)
        if not self.depth[0]:
            self.tally._count(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# collectives in the reference's schema
# ---------------------------------------------------------------------------


def collective_bytes(records) -> Dict[str, float]:
    """Sum output bytes per collective kind, as the reference sums the
    output shapes of the per-device HLO's collectives.  ``records``: one
    per op, (kind, output shapes, bytes) (:class:`StepTally`'s) or (kind,
    bytes).  Keys: each kind present (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``, ``collective-broadcast``), ``total_bytes``
    and ``op_counts``."""
    out: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for rec in records:
        op, b = rec[0], rec[-1]
        out[op] = out.get(op, 0) + b
        count[op] = count.get(op, 0) + 1
    out["total_bytes"] = sum(v for k, v in out.items() if k != "total_bytes")
    out["op_counts"] = count
    return out


def collectives_by(records) -> Dict[str, list]:
    """The tally's collective records grouped by kind and output shapes:
    ``{"kind [shapes]": [count, bytes]}``, the most bytes first."""
    by: Dict[str, list] = {}
    for kind, shapes, b in records:
        c = by.setdefault(f"{kind} {shapes}", [0, 0])
        c[0] += 1
        c[1] += b
    return dict(sorted(by.items(), key=lambda kv: -kv[1][1]))


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def _fake_mode(mode=None):
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return mode or active_fake_mode() or FakeTensorMode()


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="cpu", mode=None) -> Dict:
    """Fake stand-ins for every model input of this cell, the reference's
    shapes and dtypes (nothing is allocated), made in ``mode`` (the
    active fake mode, else a new one)."""
    B, S = shape.global_batch, shape.seq_len
    i32, u32, bf16 = torch.int32, torch.uint32, torch.bfloat16
    with _fake_mode(mode):
        def sds(shp, dt):
            return torch.empty(shp, dtype=dt, device=device)

        if cfg.encoder_layers > 0:
            se = S // 2
            batch = {"src_embeds": sds((B, se, cfg.d_model), bf16),
                     "tgt_tokens": sds((B, S - se), i32)}
        elif cfg.frontend_len > 0:
            batch = {"tokens": sds((B, S - cfg.frontend_len), i32),
                     "frontend_embeds": sds((B, cfg.frontend_len, cfg.d_model), bf16)}
        else:
            batch = {"tokens": sds((B, S), i32)}
        if shape.kind == "decode":
            return {"token": sds((B, 1), i32), "pos": sds((), i32), "seed": sds((), u32)}
        if shape.kind == "prefill":
            return {"batch": batch, "seed": sds((), u32)}
        return {"batch": batch, "step": sds((), i32)}


def _place(x: torch.Tensor, axes, mesh, rules) -> torch.Tensor:
    """A fake tensor of ``x``'s shape placed by the rules: rank 0's local
    shard (a fresh fake tensor of the local shape) as a DTensor where the
    rules shard it, else a fake tensor of the whole shape."""
    from torch.distributed.tensor import DTensor

    if mesh is None:
        return x
    sh = shd.named_sharding(tuple(x.shape), axes, mesh, rules)
    if not shd.is_sharded(sh):
        return x
    local = list(x.shape)
    for md, p in enumerate(sh.placements):
        if p.is_shard():
            local[p.dim] = -(-local[p.dim] // int(mesh.size(md)))
    loc = torch.empty(local, dtype=x.dtype, device=x.device)
    return DTensor.from_local(loc, mesh, sh.placements, run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())


def _abstract_tree(specs, dtype, mesh, rules, device):
    """A ParamSpec tree as placed fake tensors of ``dtype``."""
    return tree_map(lambda s: _place(torch.empty(s.shape, dtype=dtype, device=device),
                                     s.axes, mesh, rules), specs)


def _batch_axes(x) -> tuple:
    """The launchers' batch layout: rows over the data axes
    (``multihost.host_local_rows_to_global``), where the reference also
    shards dim 1 over ``seq``."""
    return ("batch",) + (None,) * (x.dim() - 1)


# ---------------------------------------------------------------------------
# per-cell trace
# ---------------------------------------------------------------------------


def pick_optimizer_name(cfg: ModelConfig) -> str:
    """The production optimizer for this arch: 8-bit moments when fp32
    m+v would not fit 256 chips (arctic-class), plain adamw otherwise."""
    return "adamw8bit" if param_count(build_model(cfg).specs) > 5e10 else "adamw"


def _mesh_name(mesh) -> str:
    if mesh is None:
        return "one device"
    return "pod2x16x16" if mesh.ndim == 3 else "pod16x16"


def _draw_mesh(mesh, B: int):
    """The mesh the draw row-shards over: the cell's where its B rows
    divide over the data axes, else none (a batch of one draws whole on
    every rank, as the rules replicate its rows)."""
    from repro_torch.sampling import sharded

    return mesh if mesh is not None and B % sharded.data_size(mesh) == 0 else None


def cell_step(cfg: ModelConfig, shape: ShapeConfig, args: Dict, mesh=None, *,
              rules=None, remat: str = "full", sampling_params=None):
    """The step the launchers run for a cell, bound to its arguments
    (``args``: :func:`real_inputs`' keys, real or fake): a callable that
    runs it once and returns its outputs.  On a mesh it runs as
    ``launch.train`` holds it (the new state redistributed back to its
    shardings) and draws row-sharded (``sampling.sharded``) where the
    batch divides over the data axes."""
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step

    model = build_model(cfg)
    draw_mesh = _draw_mesh(mesh, shape.global_batch)
    key = 0 if draw_mesh is not None else None   # the counter key, or the generator
    if shape.kind == "train":
        opt = make_optimizer(pick_optimizer_name(cfg), lr=3e-4)
        step_fn = make_train_step(model, opt, remat=remat)
        p_sh = o_sh = None
        if mesh is not None:
            p_axes = logical_axes(model.specs)
            p_sh = shd.tree_shardings(args["params"], p_axes, mesh, rules)
            o_sh = shd.tree_shardings(args["opt"], shd.optimizer_state_axes(
                pick_optimizer_name(cfg), p_axes), mesh, rules)

        def run():
            p, o, m = step_fn(args["params"], args["opt"], args["batch"], 0)
            if mesh is not None:
                p, o = shd.constrain_tree(p, p_sh), shd.constrain_tree(o, o_sh)
            return p, o, m
    elif shape.kind == "prefill":
        step_fn = make_prefill_step(model, mesh=draw_mesh)

        def run():
            return step_fn(args["params"], args["batch"], key)
    else:
        step_fn = make_serve_step(model, mesh=draw_mesh, sampling_params=sampling_params)
        pos = shape.seq_len - 1   # the step that fills the cache

        def run():
            return step_fn(args["params"], args["caches"], args["token"], pos, key)
    return run


def fake_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *, device="cuda",
                rules=None, mode=None) -> Dict:
    """The step's arguments as fake tensors placed on ``mesh`` by the
    rules (made in ``mode``): bfloat16 parameters and caches, the
    optimizer's state, the batch of :func:`input_specs`."""
    from repro_torch.train.optimizer import make_optimizer

    rules = rules or shd.DEFAULT_RULES
    dev = torch.device(device)
    model = build_model(cfg)
    mode = _fake_mode(mode)
    ins = input_specs(cfg, shape, dev, mode)
    with mode:
        args = {"params": _abstract_tree(model.specs, torch.bfloat16, mesh, rules, dev)}
        if "batch" in ins:
            args["batch"] = {k: _place(v, _batch_axes(v), mesh, rules)
                             for k, v in ins["batch"].items()}
        if shape.kind == "train":
            name = pick_optimizer_name(cfg)
            args["opt"] = tree_map(
                lambda m, ax: _place(torch.empty(m.shape, dtype=m.dtype, device=dev), ax,
                                     mesh, rules),
                make_optimizer(name).state_specs(model.specs),
                shd.optimizer_state_axes(name, logical_axes(model.specs)))
        if shape.kind == "decode":
            args["caches"] = _abstract_tree(model.cache_specs(shape.global_batch,
                                                              shape.seq_len),
                                            torch.bfloat16, mesh, rules, dev)
            args["token"] = _place(ins["token"], ("batch", None), mesh, rules)
    return args


def real_inputs(cfg: ModelConfig, shape: ShapeConfig, device="cuda", seed: int = 0) -> Dict:
    """The step's arguments on one device, made from ``seed``, with the
    shapes and dtypes of :func:`fake_inputs`: bfloat16 parameters
    (``init_params``), the optimizer's initial state, zero caches, tokens
    below the vocabulary and normal embeddings."""
    import numpy as np

    from repro_torch.models import init_params
    from repro_torch.train.optimizer import make_optimizer

    dev = torch.device(device)
    model = build_model(cfg)
    args = {"params": init_params(seed, model.specs, torch.bfloat16, dev)}
    rng = np.random.default_rng(seed)

    def real(x):
        if x.dtype.is_floating_point:
            return torch.as_tensor(rng.standard_normal(tuple(x.shape), dtype=np.float32),
                                   device=dev).to(x.dtype)
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, tuple(x.shape)),
                               dtype=x.dtype, device=dev)

    ins = input_specs(cfg, shape, "cpu")
    if "batch" in ins:
        args["batch"] = {k: real(v) for k, v in ins["batch"].items()}
    if shape.kind == "train":
        args["opt"] = make_optimizer(pick_optimizer_name(cfg)).init(args["params"])
    if shape.kind == "decode":
        args["caches"] = init_params(seed, model.cache_specs(shape.global_batch,
                                                             shape.seq_len),
                                     torch.bfloat16, dev)
        args["token"] = real(ins["token"])
    return args


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *, device="cuda",
               rules=None, remat: str = "full", act_seq_shard: bool = False,
               compile_: bool = True, sampling_params=None,
               chunked_threshold: Optional[int] = None) -> Dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a DeviceMesh
    of the process group, or None for one device) under ``FakeTensorMode``
    and count it per device.  ``compile_=False`` returns the parameters
    and collectives only.  ``sampling_params`` (a ``serve.SamplingParams``)
    bakes a truncation chain into a decode step.  Every global it sets
    (the attention threshold, the activation mesh) is restored."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import attention as attn_mod
    from repro_torch.serve.engine import _logits_plan, _sp_sig

    dev = torch.device(device)
    rules = rules or shd.DEFAULT_RULES
    # real tensors entering the trace are host data (the draw's seeds, the
    # mesh's ranks): they are taken as constants
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    tally = StepTally()
    old_thresh = attn_mod.CHUNKED_THRESHOLD
    old_act = (shd.activation_mesh(), shd._ACT_CTX["rules"])
    result = {"kind": shape.kind, "mesh": _mesh_name(mesh),
              "devices": 1 if mesh is None else int(mesh.size()),
              "params": param_count(build_model(cfg).specs), "device": dev.type}
    if shape.kind == "train":
        result["optimizer"] = pick_optimizer_name(cfg)
    _fake.reset_traced()
    try:
        if chunked_threshold is not None:
            attn_mod.CHUNKED_THRESHOLD = chunked_threshold
        if act_seq_shard:
            shd.set_activation_sharding(mesh, rules)
        args = fake_inputs(cfg, shape, mesh, device=dev, rules=rules, mode=mode)
        with mode:
            run = cell_step(cfg, shape, args, mesh, rules=rules, remat=remat,
                            sampling_params=sampling_params)
            argument_bytes = tally.add_arguments(args)
            by_argument = {k: tree_bytes(v) for k, v in args.items()}
            repl = implicit_replication() if mesh is not None else contextlib.nullcontext()
            t0 = time.perf_counter()
            with repl, tally.counting():
                outputs = run()
            result["lower_s"] = round(time.perf_counter() - t0, 3)
            mem = tally.result(outputs)
            del outputs
        if shape.kind != "train":
            sig = _sp_sig(sampling_params) if shape.kind == "decode" else ""
            p = _logits_plan(cfg, shape.global_batch, cfg.padded_vocab, "bfloat16",
                             mesh=_draw_mesh(mesh, shape.global_batch), transforms=sig,
                             backend=dev.type)
            result["sampler"] = {"method": p.method, "W": p.W}
    finally:
        attn_mod.CHUNKED_THRESHOLD = old_thresh
        shd.set_activation_sharding(*old_act)
    result["kernel_calls"] = dict(_fake.TRACED)
    result["collectives"] = collective_bytes(tally.collectives)
    result["collectives_by"] = collectives_by(tally.collectives)
    if not compile_:
        return result
    top = mem.pop("peak_top")
    result["memory"] = {"argument_bytes": argument_bytes, **mem,
                        "peak_bytes": argument_bytes + mem["output_bytes"] + mem["temp_bytes"],
                        "by_argument": by_argument, "peak_top": top}
    result["cost"] = {"flops": float(tally.flops),
                      "bytes_accessed": float(tally.bytes + sum(_fake.TRACED_BYTES.values()))}
    result["kernel_bytes"] = dict(_fake.TRACED_BYTES)
    result["flops_top"] = tally.flops_top()
    return result


def lower_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    compile_: bool = True,
    moe_dispatch: Optional[str] = None,
    extra_rules: Optional[list] = None,
    remat: str = "full",
    act_seq_shard: bool = False,
    no_fsdp: bool = False,
    pad_vocab: int = 0,
    sampler: Optional[str] = None,
    chunked_threshold: Optional[int] = None,
    device="cuda",
    smoke: bool = False,
):
    """Trace one production cell on its mesh (the process group must have
    256 ranks, 512 for ``multi_pod``).  Returns the result dict: the
    reference's keys less ``compile_s``, ``body_costs`` and ``corrected``
    from :mod:`costing`, and the port's ``device``, ``sampler``,
    ``kernel_calls`` and ``kernel_bytes``."""
    from repro_torch.launch import costing
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch, smoke=smoke)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=moe_dispatch)
    if pad_vocab:
        cfg = dataclasses.replace(cfg, pad_vocab_multiple=pad_vocab)
    if sampler:
        cfg = dataclasses.replace(cfg, sampler_method=sampler)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rules = (extra_rules or []) + shd.DEFAULT_RULES
    if no_fsdp:
        rules = shd.override_rules({"embed": None}, rules)
    res = {"arch": arch, "shape": shape_name}
    res.update(trace_cell(cfg, shape, mesh, device=device, rules=rules, remat=remat,
                          act_seq_shard=act_seq_shard, compile_=compile_,
                          chunked_threshold=chunked_threshold))
    if not compile_:
        return res
    try:
        res["body_costs"] = {st: costing.body_cost(cfg, shape, mesh, rules, shape.kind, st,
                                                   device=device)
                             for st in costing.stacks(cfg, shape.kind)}
        res["corrected"] = costing.corrected_totals(res, cfg, res["body_costs"])
    except Exception as e:  # recorded, as the reference records it
        res["body_costs"] = {"error": f"{type(e).__name__}: {e}"}
    return res


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device`` and ``--smoke``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-compile", action="store_true",
                    help="parameters and collectives only (no memory or cost counts)")
    ap.add_argument("--moe-dispatch", choices=["einsum", "gather"], default=None)
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--act-seq-shard", action="store_true",
                    help="sequence-shard saved activations over 'model'")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate params over data axes (decode regime)")
    ap.add_argument("--pad-vocab", type=int, default=0,
                    help="pad embedding tables to this multiple (Megatron)")
    ap.add_argument("--sampler", default=None, help="override decode sampler method")
    ap.add_argument("--q-chunk", type=int, default=None,
                    help="chunked-attention threshold (2048 chunks 4k train)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' and the mesh's device (cpu: the plain "
                         "kernel versions are traced)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' SMOKE configs (reduced widths) at the cells' shapes")
    return ap


def main(argv=None) -> int:
    """CLI: bring up a fake group of 512 ranks, run the selected cells,
    one JSON result file per cell (cells already written are skipped)."""
    args = parser().parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        parser().error("give --arch and --shape, or --all")
    fake_process_group(512)
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    for arch, shape in cells:
        for multi in meshes:
            mesh_tag = "multi" if multi else "single"
            name = f"{arch}__{shape}__{mesh_tag}{args.tag}"
            path = os.path.join(args.out, name + ".json")
            if os.path.exists(path):
                print(f"[skip] {name}")
                continue
            print(f"[run ] {name}", flush=True)
            try:
                res = lower_cell(
                    arch, shape, multi_pod=multi, compile_=not args.no_compile,
                    moe_dispatch=args.moe_dispatch, remat=args.remat,
                    act_seq_shard=args.act_seq_shard, no_fsdp=args.no_fsdp,
                    pad_vocab=args.pad_vocab, sampler=args.sampler,
                    chunked_threshold=args.q_chunk, device=args.device, smoke=args.smoke,
                )
                res["status"] = "ok"
            except Exception as e:
                res = {
                    "arch": arch, "shape": shape, "mesh": mesh_tag,
                    "status": "fail", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                }
                failures += 1
                print(f"[FAIL] {name}: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            if res.get("status") == "ok":
                mem = res.get("memory", {})
                print(
                    f"[ ok ] {name}: trace {res.get('lower_s')}s "
                    f"flops {res.get('cost', {}).get('flops', -1):.3g} "
                    f"peak {mem.get('peak_bytes', 0) / 2**30:.2f} GiB "
                    f"coll {res.get('collectives', {}).get('total_bytes', 0):.3g}B "
                    f"sampler {res.get('sampler', {}).get('method', '-')} "
                    f"kernels {res.get('kernel_calls', {})}",
                    flush=True,
                )
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
