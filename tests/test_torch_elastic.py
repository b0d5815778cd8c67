"""Elastic checkpoints of the port (``repro_torch.dist.fault``), the twin
of ``tests/test_elastic.py``, and the on-disk format shared with the
reference (``repro.dist.fault``, schema 2, docs/OPERATIONS.md).

A smoke llama3-8b bf16 parameter tree saved by a 2-rank gloo group on a
(2, 1) mesh restores onto (1, 1), (4, 1) and (2, 2) meshes of a 4-rank
group, onto one process without a group, and in the reference.
Checkpoints written by either package restore in the other.  Tolerance:
bit-equal everywhere, except int8-compressed leaves, which come back
within scale / 2 of the saved values (and bit-equal across packages)."""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.dist.fault import CheckpointManager
from torch_ranks import run_ranks


def _params():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params

    model = build_model(get_config("llama3-8b", smoke=True))
    return model, init_params(0, model.specs, torch.bfloat16, "cpu")


def _leaves(tree):
    from repro_torch.models.params import tree_leaves

    return tree_leaves(tree)


def _bits(t) -> bytes:
    t = t.detach().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _save_on_2x1(rank, world, out_dir):
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import smallest_fitting_mesh
    from repro_torch.models import logical_axes

    model, params = _params()
    mesh = smallest_fitting_mesh(data=2, model=1)
    placed = shd.device_put(params, shd.tree_shardings(params, logical_axes(model.specs), mesh))
    mgr = CheckpointManager(os.path.join(out_dir, "ck"), async_save=False)
    mgr.save(7, {"params": placed}, extra={"step": 7, "cursor": 123}, mesh=mesh)


def _restore_on_four(rank, world, out_dir):
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh, smallest_fitting_mesh
    from repro_torch.models import logical_axes

    model, params = _params()
    ax = logical_axes(model.specs)
    mgr = CheckpointManager(os.path.join(out_dir, "ck"), async_save=False)
    res = {}
    for name, mesh in (("1x1", smallest_fitting_mesh(data=1, model=1)),
                       ("4x1", smallest_fitting_mesh(data=4, model=1)),
                       ("2x2", make_host_mesh(model=2))):
        if mesh.get_coordinate() is None:
            continue    # this rank is outside the mesh
        sh = shd.tree_shardings(params, ax, mesh)
        restored, extra = mgr.restore(like={"params": params}, shardings={"params": sh})
        ok, bf16, sharded = True, True, 0
        for want, got, s in zip(_leaves(params), _leaves(restored["params"]), _leaves(sh)):
            bf16 &= got.dtype == torch.bfloat16
            if isinstance(got, DTensor):
                sharded += 1
                assert tuple(got.placements) == s.placements
                ok &= _bits(got.to_local()) == _bits(shd.local_shard(want, s))
            else:
                ok &= _bits(got) == _bits(want)
        res[name] = {"equal": ok, "bf16": bf16, "sharded_leaves": sharded,
                     "step": extra["step"], "cursor": extra["cursor"],
                     "files_read": mgr.restore_stats()["files_read"]}
    with open(os.path.join(out_dir, f"restore{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.mark.slow
def test_checkpoint_shrinks_and_grows(tmp_path):
    """A (2, 1)-mesh checkpoint restores bit-exact (bf16 kept) onto (1, 1),
    (4, 1) and (2, 2) meshes and onto one process, resuming at the saved
    step with its extra payload; the reference restores it too."""
    run_ranks(_save_on_2x1, tmp_path, 2)
    ck = tmp_path / "ck"
    man = json.loads((ck / "step_00000007" / "manifest.json").read_text())
    assert man["topology"] == {"processes": 2, "devices": 2, "mesh": {"data": 2, "model": 1}}
    assert man["files"]["1"]["nbytes"] > 0        # rank 1 wrote its own shards
    run_ranks(_restore_on_four, tmp_path, 4)
    res = [json.loads((tmp_path / f"restore{r}.json").read_text()) for r in range(4)]
    assert set(res[0]) == {"1x1", "4x1", "2x2"}
    assert all(set(r) == {"4x1", "2x2"} for r in res[1:])
    for r in res:
        for name, v in r.items():
            assert v["equal"] and v["bf16"], (name, v)
            assert v["step"] == 7 and v["cursor"] == 123
    assert res[0]["1x1"]["sharded_leaves"] == 0
    assert res[0]["1x1"]["files_read"] == ["data.rank0.bin", "data.rank1.bin"]
    assert all(r["4x1"]["sharded_leaves"] > 0 and r["2x2"]["sharded_leaves"] > 0 for r in res)

    # one process, no group: whole tensors
    _, params = _params()
    out, extra = CheckpointManager(str(ck)).restore(like={"params": params})
    assert extra == {"step": 7, "cursor": 123}
    for a, b in zip(_leaves(params), _leaves(out["params"])):
        assert b.dtype == torch.bfloat16 and _bits(a) == _bits(b)

    # the reference reads the port's 2-rank checkpoint
    import jax
    import jax.numpy as jnp

    from repro.dist.fault import CheckpointManager as RefManager

    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16), params)
    jout, jextra = RefManager(str(ck)).restore(like={"params": like})
    assert jextra == extra
    for a, b in zip(_leaves(params), jax.tree.leaves(jout["params"])):
        assert np.asarray(b).dtype.name == "bfloat16"
        assert _bits(a) == np.asarray(b).view(np.int16).tobytes()


def test_int8_checkpoint_roundtrip(tmp_path):
    """compress=True stores float32 leaves as int8 + scale: each element
    comes back within scale/2, int leaves stay exact, and the file is
    smaller than the uncompressed payload."""
    from repro_torch.dist.compression import quantize_int8

    rng = np.random.default_rng(0)
    tree = {"m": torch.as_tensor(rng.normal(size=(64, 32)), dtype=torch.float32),
            "v": torch.as_tensor(rng.random((64, 32)) * 1e-3, dtype=torch.float32),
            "count": torch.tensor(42, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), async_save=False, compress=True)
    mgr.save(1, tree)
    restored, _ = mgr.restore(like=tree)
    for k in ("m", "v"):
        _, scale = quantize_int8(tree[k])
        err = (tree[k] - restored[k]).abs().max().item()
        assert err <= float(scale) * 0.5 + 1e-7, f"{k}: err {err}"
    assert int(restored["count"]) == 42 and restored["count"].dtype == torch.int32
    data = os.path.getsize(tmp_path / "step_00000001" / "data.rank0.bin")
    assert data < 64 * 32 * 2 * 4


def _mixed_numpy():
    import ml_dtypes

    rng = np.random.default_rng(9)
    return {
        "a": rng.standard_normal((6, 5)).astype(np.float32),
        "b": {"h": rng.standard_normal((4, 7)).astype(ml_dtypes.bfloat16),
              "i": rng.integers(-50, 50, (9,)).astype(np.int32)},
        "s": np.float32(2.5),
    }


def _np_bits(x) -> bytes:
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "int8"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, compress):
    """The reference saves numpy leaves (float32, bfloat16, int32, a 0-d
    float32) with ``extra``; the port restores every leaf bit for bit, its
    dtype kept (int8 blocks dequantized to the same bits)."""
    import jax

    from repro.dist.fault import CheckpointManager as RefManager

    tree = _mixed_numpy()
    ref = RefManager(str(tmp_path), async_save=False, compress=compress)
    ref.save(3, tree, extra={"cursor": {"seed": 0, "step": 3}, "step": 3})
    jout, _ = ref.restore(like=tree)
    like = {"a": torch.zeros(6, 5), "b": {"h": torch.zeros(4, 7, dtype=torch.bfloat16),
                                          "i": torch.zeros(9, dtype=torch.int32)},
            "s": torch.zeros(())}
    out, extra = CheckpointManager(str(tmp_path)).restore(like=like)
    assert extra == {"cursor": {"seed": 0, "step": 3}, "step": 3}
    mine = _leaves(out)
    assert [str(t.dtype) for t in mine] == ["torch.float32", "torch.bfloat16", "torch.int32",
                                            "torch.float32"]
    for t, j in zip(mine, jax.tree.leaves(jout)):
        assert tuple(t.shape) == np.shape(j)
        assert _bits(t) == _np_bits(j)


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "int8"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, compress):
    """The port saves tensors and numpy leaves; the reference restores them
    bit for bit, and its restore equals the port's own."""
    import jax
    import jax.numpy as jnp

    from repro.dist.fault import CheckpointManager as RefManager

    src = _mixed_numpy()
    tree = {"a": torch.from_numpy(src["a"]),
            "b": {"h": torch.from_numpy(src["b"]["h"].view(np.int16)).view(torch.bfloat16),
                  "i": src["b"]["i"]},
            "s": torch.tensor(2.5)}
    mgr = CheckpointManager(str(tmp_path), async_save=False, compress=compress)
    mgr.save(4, tree, extra={"step": 4}, mesh={"data": 1, "model": 1})
    mine, _ = mgr.restore(like=tree)
    jlike = jax.tree.map(lambda x: jnp.zeros(np.shape(x)), src)
    jout, jextra = RefManager(str(tmp_path)).restore(like=jlike)
    assert jextra == {"step": 4}
    for t, j in zip(_leaves(mine), jax.tree.leaves(jout)):
        assert np.asarray(j).dtype.name == str(t.dtype).replace("torch.", "")
        assert _bits(t) == _np_bits(j)
    if not compress:
        for t, j in zip(_leaves(tree), jax.tree.leaves(jout)):
            want = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
            assert _bits(want) == _np_bits(j)
