"""Mesh construction on ``torch.distributed``, the counterpart of
``repro.launch.mesh``.  Functions, not module constants: importing this
module touches no process group.

A mesh's "devices" are the ranks of the process group, one card each
(or one CPU process each on gloo).  The device type is the launcher's
(``multihost.launch_device()``: ``$REPRO_TORCH_DEVICE``, ``cuda`` by
default).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist import multihost


def ensure_group(device: torch.device = None) -> int:
    """The world size of the process group, forming a one-rank group over
    a ``HashStore`` first when there is none (NCCL on the card, gloo on
    the CPU; no TCP port), so a single process runs the same mesh code as
    a fleet."""
    if not dist.is_initialized():
        dev = device or multihost.launch_device()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def _device_type(device=None) -> str:
    dev = torch.device(device) if device is not None else multihost.launch_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dev.type


def _mesh(shape, names, device=None) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= int(s)
    ranks = torch.arange(n).reshape(tuple(int(s) for s in shape))
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  Raises
    ``ValueError`` naming the world it needs when the group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of {need} ranks; "
            f"this process group has {have}")
    return _mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device=None) -> DeviceMesh:
    """Every rank of the group on ``data`` (``model`` of them on
    ``model``): a (world / model, model) mesh, forming a one-rank group
    first when there is none."""
    n = ensure_group(device)
    if model < 1 or n % model:
        raise ValueError(
            f"cannot build a host mesh with model={model}: {n} rank"
            f"{'s' if n != 1 else ''} is not divisible by it "
            f"(try model in {sorted(m for m in range(1, n + 1) if n % m == 0)}, "
            "or use smallest_fitting_mesh to take a rank subset)")
    return _mesh((n // model, model), ("data", "model"), device)


def smallest_fitting_mesh(data: int = 1, model: int = 1, *, specs=None,
                          budget_bytes: float = None, itemsize: float = 2.0,
                          rules=None, device=None) -> DeviceMesh:
    """A (data, model) mesh on the *first* data*model ranks of the group.

    With ``specs`` (a ParamSpec tree) and ``budget_bytes``, the explicit
    shape is ignored and the function *searches*: candidate (data, model)
    shapes are costed through the rules engine the launchers place with
    (``dist.sharding.tree_bytes_per_device``), and the fewest ranks whose
    per-rank bytes fit the budget win; ties prefer smaller ``model``.
    Raises ``ValueError`` when the group has too few ranks.  Every rank of
    the group calls it (a DeviceMesh over a subset still forms its
    subgroups collectively); ranks outside the mesh get no coordinate."""
    from repro_torch.dist import sharding as shd

    n = ensure_group(device)
    if specs is not None:
        if budget_bytes is None:
            raise ValueError("specs= requires budget_bytes=")
        candidates = sorted((d * m, m, d) for d in range(1, n + 1)
                            for m in range(1, n + 1) if d * m <= n)
        for _, m, d in candidates:
            desc = shd.MeshDesc({"data": d, "model": m})
            if shd.tree_bytes_per_device(specs, desc, itemsize, rules) <= budget_bytes:
                data, model = d, m
                break
        else:
            raise ValueError(
                f"no mesh on {n} ranks fits {budget_bytes / 1e9:.2f} GB per rank for this "
                "param tree (a larger group or budget is needed)")
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got ({data}, {model})")
    need = data * model
    if need > n:
        raise ValueError(
            f"smallest_fitting_mesh(({data}, {model})) needs {need} ranks but the "
            f"process group has only {n}")
    return _mesh((data, model), ("data", "model"), device)
