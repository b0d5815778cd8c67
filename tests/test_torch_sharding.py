"""The port's sharding rules engine and int8 compression against the
reference, the twin of ``tests/test_sharding.py`` (plus
``repro.dist.compression``).

The rules engine is pure: every ``ParamSpec`` of the ten configs, SMOKE
and full, is resolved over six mesh descriptions with the default rules
and with ``override_rules({"embed": None})``, and the port's specs must
equal the reference's ``PartitionSpec`` entries, ``tree_bytes_per_device``
must be float-equal and ``optimizer_state_axes`` equal.  Compression must
be bit-equal: ``q``, ``scale``, and the error-feedback allreduce's means
and residuals.  Tolerance: none."""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.dist import compression as tcomp
from repro_torch.dist import sharding as shd
from repro_torch.models.params import tree_leaves

MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 1}, {"data": 1, "model": 2},
          {"data": 4, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


class FakeMesh:
    """Duck-typed mesh: axis_names + shape mapping (rules only need these)."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


def test_param_2d_sharding():
    assert shd.spec_for_shape((128256, 4096), ("vocab", "embed"), SINGLE) == ("model", "data")
    assert shd.spec_for_shape((128256, 4096), ("vocab", "embed"), MULTI) == \
        ("model", ("pod", "data"))


def test_odd_vocab_replicates_but_fsdp_survives():
    assert shd.spec_for_shape((49155, 1024), ("vocab", "embed"), SINGLE) == (None, "data")


def test_heads_not_divisible_drop():
    p = shd.spec_for_shape((1600, 25, 64), ("embed", "heads", "head"), SINGLE)
    assert p == ("data", None, None)


def test_batch_beats_kv_seq():
    p = shd.spec_for_shape((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", "head"), MULTI)
    assert p[0] == ("pod", "data") and p[1] == "model"


def test_kv_seq_fallback_when_batch_1():
    p = shd.spec_for_shape((1, 524416, 8, 128), ("batch", "kv_seq", "kv_heads", "head"), MULTI)
    assert p[0] is None and p[1] == ("pod", "data")


def test_no_mesh_axis_reused():
    p = shd.spec_for_shape((128, 7168, 4864), ("experts", "embed", "mlp"), SINGLE)
    flat = []
    for a in p:
        if a is not None:
            flat.extend([a] if isinstance(a, str) else list(a))
    assert len(flat) == len(set(flat))
    assert p[0] == "model" and p[1] == "data" and p[2] is None


def test_optimizer_state_axes_adamw8bit():
    assert shd.optimizer_state_axes("adamw8bit", {"w": ("embed", "mlp")})["w"]["m_q"] == \
        ("qblocks", None)


def test_optimizer_state_axes_adafactor():
    ax = shd.optimizer_state_axes("adafactor", {"w": ("embed", "mlp"), "b": ("embed",)})
    assert ax["w"] == {"vr": ("embed",), "vc": ("mlp",)}
    assert ax["b"] == {"v": ("embed",)}


def test_rules_priority_order_is_stable():
    from repro.dist import sharding as jshd

    names = [n for n, _ in shd.DEFAULT_RULES]
    assert names.index("batch") < names.index("kv_seq")
    assert names.index("embed") < names.index("kv_seq")
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES


def test_constrain_activation_noop_without_mesh():
    shd.set_activation_sharding(None)
    x = torch.ones((4, 8, 16))
    assert shd.constrain_activation(x, ("batch", "act_seq", None)) is x


def test_override_rules_equal_the_reference():
    from repro.dist import sharding as jshd

    for ov in ({"embed": None}, {"vocab": "data"}, {"heads": ("pod", "data")},
               {"new_axis": "model"}, {"new_none": None}):
        assert shd.override_rules(ov) == jshd.override_rules(ov), ov


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_bytes_and_optimizer_axes_equal_the_reference(arch, smoke):
    """Every ParamSpec (and cache spec) of one config, over the six
    meshes, default and no-FSDP rules."""
    from repro.configs import get_config as jget
    from repro.dist import sharding as jshd
    from repro.models import build_model as jbuild
    from repro.models import logical_axes as jaxes
    from repro.models.params import is_spec

    import jax

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, logical_axes

    model, jmodel = build_model(get_config(arch, smoke=smoke)), jbuild(jget(arch, smoke=smoke))
    trees = [(model.specs, jmodel.specs)]
    if model.cfg.encoder_layers == 0 and model.cfg.frontend_len == 0:
        trees.append((model.cache_specs(8, 64), jmodel.cache_specs(8, 64)))
    for specs, jspecs in trees:
        mine = tree_leaves(specs)
        ref = jax.tree.leaves(jspecs, is_leaf=is_spec)
        assert [(s.shape, s.axes) for s in mine] == [(s.shape, s.axes) for s in ref]
        for rules, jrules in ((None, None), (shd.override_rules({"embed": None}),
                                             jshd.override_rules({"embed": None}))):
            for m in MESHES:
                desc, jdesc = shd.MeshDesc(m), jshd.MeshDesc(m)
                for s in mine:
                    got = shd.spec_for_shape(s.shape, s.axes, desc, rules)
                    want = jshd.spec_for_shape(s.shape, s.axes, jdesc, jrules)
                    assert tuple(got) == tuple(want), (arch, m, s)
                for item in (2.0, 4.0):
                    assert shd.tree_bytes_per_device(specs, desc, item, rules) == \
                        jshd.tree_bytes_per_device(jspecs, jdesc, item, jrules)
    ax, jax_ = logical_axes(model.specs), jaxes(jmodel.specs)
    for name in ("adamw", "adamw8bit", "adafactor"):
        assert shd.optimizer_state_axes(name, ax) == \
            jax.tree.map(lambda x: x, jshd.optimizer_state_axes(name, jax_),
                         is_leaf=lambda x: isinstance(x, tuple))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    mesh.mesh_dim_names = mesh.axis_names
    assert shd.placements_for_spec(("model", ("pod", "data")), mesh) == \
        (Shard(1), Shard(1), Shard(0))
    assert shd.placements_for_spec((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(11)
    f32 = rng.standard_normal((37, 129)).astype(np.float32) * 3.0
    huge = np.zeros((64,), np.float32)
    huge[17] = 3.0e38
    return {
        "normal": f32,
        "tiny": (rng.standard_normal(1000) * 1e-30).astype(np.float32),
        "zeros": np.zeros((5, 7), np.float32),
        "huge": huge,
        "halves": (np.arange(-300, 301, dtype=np.float32) / 2.0),
    }


def _bf16_pair(x32: np.ndarray):
    import jax.numpy as jnp

    t = torch.from_numpy(x32).to(torch.bfloat16)
    j = jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return t, j


@pytest.mark.parametrize("name", ["normal", "tiny", "zeros", "huge", "halves"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_equal(name, dtype):
    import jax.numpy as jnp

    from repro.dist import compression as jcomp

    x = _inputs()[name]
    t, j = (torch.from_numpy(x), jnp.asarray(x)) if dtype == "float32" else _bf16_pair(x)
    q, s = tcomp.quantize_int8(t)
    jq, js = jcomp.quantize_int8(j)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    d, jd = tcomp.dequantize_int8(q, s), jcomp.dequantize_int8(jq, js)
    assert d.numpy().tobytes() == np.asarray(jd).tobytes()
    # the documented bound, up to the float32 rounding of q * scale
    xf = t.to(torch.float32).numpy()
    err = np.abs(d.numpy() - xf)
    assert np.all(err <= s.item() / 2 + np.spacing(np.abs(xf)))


def test_compressed_allreduce_bit_equal_over_rounds():
    import jax.numpy as jnp

    from repro.dist import compression as jcomp

    rng = np.random.default_rng(5)
    workers = 3
    res = [tcomp.init_error_feedback({"a": torch.zeros(40), "b": torch.zeros(6, 9)})
           for _ in range(workers)]
    jres = [jcomp.init_error_feedback({"a": jnp.zeros(40), "b": jnp.zeros((6, 9))})
            for _ in range(workers)]
    for _ in range(3):
        g = [{"a": rng.standard_normal(40).astype(np.float32),
              "b": rng.standard_normal((6, 9)).astype(np.float32) * 10} for _ in range(workers)]
        mean, res = tcomp.simulate_compressed_allreduce(
            [{k: torch.from_numpy(v) for k, v in w.items()} for w in g], res)
        jmean, jres = jcomp.simulate_compressed_allreduce(
            [{k: jnp.asarray(v) for k, v in w.items()} for w in g], jres)
        for k in ("a", "b"):
            assert mean[k].numpy().tobytes() == np.asarray(jmean[k]).tobytes()
            for r, jr in zip(res, jres):
                assert r[k].numpy().tobytes() == np.asarray(jr[k]).tobytes()
    # bare arrays (one leaf per worker)
    bare = [torch.from_numpy(rng.standard_normal(33).astype(np.float32)) for _ in range(2)]
    m, r = tcomp.simulate_compressed_allreduce(bare, [torch.zeros(33)] * 2)
    jm, jr = jcomp.simulate_compressed_allreduce([jnp.asarray(b.numpy()) for b in bare],
                                                 [jnp.zeros(33)] * 2)
    assert m.numpy().tobytes() == np.asarray(jm).tobytes()
    assert all(a.numpy().tobytes() == np.asarray(b).tobytes() for a, b in zip(r, jr))
