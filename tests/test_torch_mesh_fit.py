"""Mesh fitting through the port's sharding rules (``repro_torch.launch.mesh``),
the twin of ``tests/test_mesh_fit.py``: ``smallest_fitting_mesh``'s budget
search must agree with the REAL DTensor placement, on a spawned 4-rank
gloo group.  The same group checks that a DTensor splits a dim sharded
over two mesh dims ("pod", "data") pod-major, as JAX does, and that
``make_production_mesh`` on a small group names the world it needs.
(The reference's ``test_memory_model_uses_the_rules_engine`` reads
``benchmarks/memory_model.py``; it has no twin until the benchmark folder
is ported.)  Tolerance: none."""

import json
import os

import pytest
import torch

from repro_torch.dist import sharding as shd
from repro_torch.models.params import ParamSpec
from torch_ranks import run_ranks


def _toy_specs():
    return {
        "emb": ParamSpec((1024, 256), ("vocab", "embed")),
        "w": ParamSpec((256, 512), ("embed", "mlp")),
        "b": ParamSpec((512,), (None,)),  # always replicated
    }


def test_estimator_divides_by_assigned_axes_only():
    specs = _toy_specs()
    one = shd.MeshDesc({"data": 1, "model": 1})
    four = shd.MeshDesc({"data": 2, "model": 2})
    assert shd.tree_bytes_per_device(specs, one, itemsize=4.0) == \
        (1024 * 256 + 256 * 512 + 512) * 4.0
    assert shd.tree_bytes_per_device(specs, four, itemsize=4.0) == \
        (1024 * 256 / 4 + 256 * 512 / 4 + 512) * 4.0


def _fit_worker(rank, world, out_dir):
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.launch.mesh import _mesh, make_production_mesh, smallest_fitting_mesh
    from repro_torch.models import init_params

    specs = _toy_specs()
    total = shd.tree_bytes_per_device(specs, shd.MeshDesc({"data": 1, "model": 1}), 4.0)
    m1 = smallest_fitting_mesh(specs=specs, budget_bytes=total, itemsize=4.0)
    m2 = smallest_fitting_mesh(specs=specs, budget_bytes=total * 0.6, itemsize=4.0)
    try:
        smallest_fitting_mesh(specs=specs, budget_bytes=512.0, itemsize=4.0)
        unfittable = "no error"
    except ValueError:
        unfittable = "raised"
    try:
        make_production_mesh()
        production = "no error"
    except ValueError as e:
        production = str(e)

    # the REAL placement on the chosen mesh holds exactly the bytes the
    # estimator predicted, on every rank of the mesh
    params = init_params(0, specs, torch.float32, "cpu")
    sh = shd.tree_shardings(params, {k: s.axes for k, s in specs.items()}, m2)
    placed = shd.device_put(params, sh)
    actual = None
    if m2.get_coordinate() is not None:
        actual = 0
        for k, leaf in placed.items():
            local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            actual += local.numel() * local.element_size()
            whole = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
            assert torch.equal(whole, params[k])
    est = shd.tree_bytes_per_device(specs, shd.MeshDesc(shd.mesh_shape(m2)), itemsize=4.0)

    # a dim over ("pod", "data") splits pod-major: shard p*2+d
    pd = _mesh((2, 2), ("pod", "data"))
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    s = shd.named_sharding(x.shape, ("batch", None), pd)
    assert s.spec == (("pod", "data"), None) and s.placements == (Shard(0), Shard(0))
    p, d = pd.get_coordinate()
    mine = shd.local_shard(x, s)
    fused_ok = (torch.equal(mine, x[(p * 2 + d) * 2:(p * 2 + d + 1) * 2])
                and torch.equal(distribute_tensor(x, pd, s.placements).to_local(), mine)
                and torch.equal(shd.device_put({"x": x}, {"x": s})["x"].full_tensor(), x))
    with open(os.path.join(out_dir, f"fit{rank}.json"), "w") as f:
        json.dump({"m1": shd.mesh_shape(m1), "m2": shd.mesh_shape(m2), "unfittable": unfittable,
                   "production": production, "actual": actual, "est": est,
                   "fused_ok": bool(fused_ok)}, f)


@pytest.mark.slow
def test_budget_search_agrees_with_real_placement(tmp_path):
    run_ranks(_fit_worker, tmp_path, 4)
    res = [json.loads((tmp_path / f"fit{r}.json").read_text()) for r in range(4)]
    for r, got in enumerate(res):
        assert got["m1"] == {"data": 1, "model": 1}
        assert got["m2"]["data"] * got["m2"]["model"] == 2, got["m2"]
        assert got["unfittable"] == "raised"
        assert "needs a world of 256 ranks" in got["production"]
        assert "has 4" in got["production"]
        assert got["fused_ok"]
        if r < 2:   # the ranks of the chosen 2-rank mesh
            assert got["actual"] == got["est"], "estimate and real placement disagree"
        else:
            assert got["actual"] is None
