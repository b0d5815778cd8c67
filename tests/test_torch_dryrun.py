"""The dry-run (``repro_torch.launch.dryrun`` and ``launch.costing``) on the
CPU, against the reference's ``repro.launch.dryrun`` / ``costing`` where
both compute the same thing.

Cells trace SMOKE configs: on a fake process group of 8 ranks and a
(4, 2) ``cpu`` mesh (the reference's test cell), and on one device.  A
``cuda`` DeviceMesh cannot be built by this CPU-only PyTorch, so the
kernel route is traced on fake ``cuda`` tensors without a mesh; the
production cells and the one-card prediction against a real step run on
the card (``chip_smoke.py`` phase 12).
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import autotune, sampling
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.kernels import _build
from repro_torch.kernels import fake as kfake
from repro_torch.launch import costing, dryrun

SRC = Path(__file__).resolve().parents[1] / "src"
KINDS = ("train", "prefill", "decode")


def smoke_shape(kind: str) -> ShapeConfig:
    """The reference test's geometry: 8 sequences of 64 tokens."""
    return ShapeConfig("t", 64, 8, kind)


@pytest.fixture
def port_tuner(tmp_path, monkeypatch):
    """The port's tuner on a throwaway cache file."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    yield
    autotune.reset()


@pytest.fixture(scope="module")
def mesh_cell(tmp_path_factory):
    """llama3-8b's SMOKE train step traced on a fake group of 8 ranks and
    a (4, 2) ("data", "model") cpu mesh, once for the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import smallest_fitting_mesh

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "autotune.json"))
        autotune.reset()
        assert not dist.is_initialized()
        assert dryrun.fake_process_group(8) == 8
        try:
            mesh = smallest_fitting_mesh(data=4, model=2, device="cpu")
            cfg = get_config("llama3-8b", smoke=True)
            yield mesh, cfg, dryrun.trace_cell(cfg, smoke_shape("train"), mesh, device="cpu")
        finally:
            dist.destroy_process_group()
            autotune.reset()


# ---------------------------------------------------------------------------
# the reference's schema
# ---------------------------------------------------------------------------


def test_collective_bytes_matches_reference_parser():
    """The three collectives of the reference's parser test, as the
    tally's records, give the reference parser's numbers key for key."""
    from repro.launch.dryrun import collective_bytes as ref_collective_bytes

    hlo = """
      %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={}
      ROOT %ag = bf16[64]{0} all-gather(bf16[32]{0} %y), dimensions={0}
      %cp = (f32[8,8]{1,0}, f32[8,8]{1,0}) collective-permute(%a, %b)
      %dead = f32[4]{0} add(f32[4]{0} %p, f32[4]{0} %q)
    """
    records = [("all-reduce", [(128, 256)], 128 * 256 * 4), ("all-gather", [(64,)], 64 * 2),
               ("collective-permute", [(8, 8), (8, 8)], 2 * 64 * 4)]
    assert dryrun.collective_bytes(records) == ref_collective_bytes(hlo)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Every arch's SMOKE config x train / prefill / decode: the fake
    inputs have the reference's ShapeDtypeStruct shapes and dtypes."""
    import numpy as onp

    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.launch.dryrun import input_specs as ref_input_specs

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v

    for kind in KINDS:
        ref = dict(flat(ref_input_specs(ref_config(arch, smoke=True),
                                        RefShape("t", 64, 8, kind))))
        got = dict(flat(dryrun.input_specs(get_config(arch, smoke=True), smoke_shape(kind))))
        assert sorted(got) == sorted(ref), (kind, sorted(got), sorted(ref))
        for k, v in got.items():
            assert kfake.is_fake(v)
            assert tuple(v.shape) == tuple(ref[k].shape), (kind, k)
            assert str(v.dtype).replace("torch.", "") == onp.dtype(ref[k].dtype).name, (kind, k)


def test_pick_optimizer_name_matches_reference():
    from repro.configs import get_config as ref_config
    from repro.launch.dryrun import pick_optimizer_name as ref_pick

    picks = {a: dryrun.pick_optimizer_name(get_config(a)) for a in ARCH_IDS}
    assert picks == {a: ref_pick(ref_config(a)) for a in ARCH_IDS}
    assert picks["arctic-480b"] == "adamw8bit" and picks["llama3-8b"] == "adamw"


def test_fake_process_group_module_is_there():
    """The fake group rests on a private module of PyTorch's test suite:
    pinned here, so a PyTorch that moves it fails this test first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert isinstance(FakeStore(), dist.Store)
    assert "fake" in dist.Backend.backend_list


# ---------------------------------------------------------------------------
# the (4, 2) mesh cell, per device
# ---------------------------------------------------------------------------


def test_mesh_cell_counts(mesh_cell):
    """The reference test's cell: FLOPs, temporaries and collectives of at
    least one kind, and the reference's parameter count."""
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    from repro.models import param_count as ref_param_count

    _, _, res = mesh_cell
    assert res["cost"]["flops"] > 0 and res["cost"]["bytes_accessed"] > 0
    assert res["memory"]["temp_bytes"] > 0
    assert res["collectives"]["total_bytes"] > 0 and len(res["collectives"]["op_counts"]) >= 1
    assert res["params"] == ref_param_count(ref_build(ref_config("llama3-8b", smoke=True)).specs)
    assert res["optimizer"] == "adamw" and res["devices"] == 8


def test_mesh_state_bytes_match_reference(mesh_cell):
    """Parameter and optimizer-state bytes per device equal the reference's
    ``tree_bytes_per_device`` on a mesh description of the same shape."""
    from repro.configs import get_config as ref_config
    from repro.dist import sharding as ref_shd
    from repro.models import build_model as ref_build

    _, _, res = mesh_cell
    specs = ref_build(ref_config("llama3-8b", smoke=True)).specs
    desc = ref_shd.MeshDesc({"data": 4, "model": 2})
    got = res["memory"]["by_argument"]
    assert got["params"] == ref_shd.tree_bytes_per_device(specs, desc, 2.0)
    # AdamW: float32 m and v, placed as the parameters
    assert got["opt"] == 2 * ref_shd.tree_bytes_per_device(specs, desc, 4.0)
    assert res["memory"]["argument_bytes"] == sum(got.values())


def test_per_device_counts_are_one_eighth(mesh_cell):
    """A leaf sharded 8 ways counts 1/8 of its bytes and a product on it
    1/8 of its one-device FLOPs; FlopCounterMode outside DTensor counts
    the whole product (the trap the tally avoids)."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = mesh_cell[0]
    rules = shd.override_rules({"rows": ("data", "model")})
    whole = 2 * 64 * 32 * 16
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = dryrun._place(torch.empty((64, 32)), ("rows", None), mesh, rules)
        w = torch.empty((32, 16))
        assert all(p.is_shard(0) for p in x.placements)
        assert x.to_local().shape == (8, 32)
        tally = dryrun.StepTally()
        assert tally.add_arguments(x) == 64 * 32 * 4 // 8
        with implicit_replication(), tally.counting():
            y = x @ w
        assert y.to_local().shape == (8, 16)
        with implicit_replication(), FlopCounterMode(display=False) as fc:
            x @ w
    assert tally.flops == whole // 8
    assert fc.get_total_flops() == whole


@pytest.mark.parametrize("eq,sa,sb", [
    ("bsd,dnh->bsnh", (2, 3, 4), (4, 5, 6)), ("bsnh,nhd->bsd", (2, 3, 5, 6), (5, 6, 4)),
    ("...d,vd->...v", (2, 3, 4), (7, 4)), ("bqhe,bshe->bhqs", (2, 3, 4, 5), (2, 6, 4, 5)),
    ("bcqhn,bcshn->bcqsh", (2, 3, 4, 5, 6), (2, 3, 7, 5, 6))])
def test_matmul_einsum_equals_einsum(eq, sa, sb):
    """The DTensor operands' einsum (one matmul between reshapes) is the
    einsum, values and gradients, on plain float64 tensors."""
    from repro_torch.models.layers import _matmul_einsum

    g = torch.Generator().manual_seed(0)
    a = torch.randn(sa, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(sb, generator=g, dtype=torch.float64, requires_grad=True)
    got, want = _matmul_einsum(eq, a, b), torch.einsum(eq, a, b)
    torch.testing.assert_close(got, want)
    for x, y in zip(torch.autograd.grad(got.sum(), (a, b)),
                    torch.autograd.grad(want.sum(), (a, b))):
        torch.testing.assert_close(x, y)


def test_reshape_gathers_what_cannot_stay_sharded(mesh_cell):
    """``layers.reshape`` of a DTensor keeps a sharded dim that leads its
    group and gathers one that a flatten would put behind another."""
    from torch.distributed.tensor import Shard

    from repro_torch.models.layers import reshape

    mesh = mesh_cell[0]
    rules = shd.override_rules({"rows": ("data",), "cols": ("model",)})
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = dryrun._place(torch.empty((8, 4, 6)), ("rows", "cols", None), mesh, rules)
        assert tuple(x.placements) == (Shard(0), Shard(1))
        kept = reshape(x, (8, 24))
        flat = reshape(x, (32, 6))
    assert tuple(kept.placements) == (Shard(0), Shard(1)) and kept.shape == (8, 24)
    assert flat.placements[0] == Shard(0) and not flat.placements[1].is_shard()
    assert flat.to_local().shape == (8, 6)


# ---------------------------------------------------------------------------
# the loss and the unembedding on the (4, 2) mesh (ROADMAP F4)
# ---------------------------------------------------------------------------


def _vocab_cfg(V: int):
    """llama3-8b's SMOKE config with a vocabulary of ``V``: 1,000 splits
    over ``model`` (2), 999 does not, so the positions split instead."""
    return dataclasses.replace(get_config("llama3-8b", smoke=True), vocab_size=V)


@pytest.mark.parametrize("V", [1000, 999], ids=["vocab", "positions"])
def test_mesh_train_holds_no_whole_vocabulary(V, mesh_cell, port_tuner):
    """No logits over a rank's rows, every position and the whole
    vocabulary are among the largest storages at the peak, in any dtype
    (the gathered vocabulary of the loss held five float32 ones, 33.6 GB
    each, in llama3-8b's train_4k on the card): each rank holds its block
    of the logits."""
    mesh = mesh_cell[0]
    res = dryrun.trace_cell(_vocab_cfg(V), smoke_shape("train"), mesh, device="cpu")
    rows, S = 8 // 4, 64
    top = res["memory"]["peak_top"]
    assert top, res["memory"]
    for _, shape, dtype, op in top:
        whole = shape[-1] == V and np.prod(shape[:-1]) >= rows * (S - 1)
        assert not whole, (shape, dtype, op)
    assert res["collectives"]["op_counts"].get("all-reduce", 0) >= 3


@pytest.mark.parametrize("V,tied", [(1000, False), (999, False), (1000, True)],
                         ids=["vocab", "positions", "tied"])
def test_unembedding_flops_are_one_eighth(V, tied, mesh_cell):
    """The unembedding and the loss, forward and backward, count 1/8 of
    their one-device FLOPs per device on the (4, 2) mesh: every rank
    projects its own rows onto its own columns (or positions)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers
    from repro_torch.train.train_step import _loss

    mesh = mesh_cell[0]
    Bs, S, D = 8, 64, 64

    def flops(m):
        with FakeTensorMode(allow_non_fake_inputs=True):
            h = dryrun._place(torch.empty((Bs, S, D), dtype=torch.bfloat16),
                              ("batch", None, None), m, shd.DEFAULT_RULES)
            shape, axes = ((V, D), ("vocab", "embed")) if tied else ((D, V), ("embed", "vocab"))
            table = dryrun._place(torch.empty(shape, dtype=torch.bfloat16), axes, m,
                                  shd.DEFAULT_RULES)
            toks = dryrun._place(torch.zeros((Bs, S), dtype=torch.int32), ("batch", None), m,
                                 shd.DEFAULT_RULES)
            for t in (h, table):
                t.requires_grad_(True)
            tally = dryrun.StepTally()
            repl = implicit_replication() if m is not None else contextlib.nullcontext()
            with repl, tally.counting():
                logits = layers.unembed(None if tied else {"table": table}, h,
                                        tied_table=table if tied else None, vocab_size=V - 1)
                loss, _, _ = _loss(logits, {"tokens": toks}, 1e-4)
                torch.autograd.grad(loss, [h, table])
        return tally.flops

    one = flops(None)
    assert one == 3 * 2 * Bs * S * D * V
    assert flops(mesh) * 8 == one


@pytest.mark.parametrize("arch", ["arctic-480b", "seamless-m4t-medium"])
def test_mesh_train_4k_traces(arch, mesh_cell, port_tuner, monkeypatch):
    """The two train_4k cells that failed on the card (PERF.md §5) trace
    at their SMOKE widths on the (4, 2) mesh: arctic-480b with 8-bit AdamW
    (its moments flattened in the reference's row-major blocks, each rank
    its own), seamless-m4t-medium with one head a ``model`` rank, as 16
    heads on 16 ranks give (a gradient whose local shard is a transposed
    view)."""
    from repro_torch.configs.base import SHAPES_BY_NAME

    mesh = mesh_cell[0]
    cfg = get_config(arch, smoke=True)
    if arch == "arctic-480b":
        monkeypatch.setattr(dryrun, "pick_optimizer_name", lambda c: "adamw8bit")
    else:
        cfg = dataclasses.replace(cfg, num_heads=2, num_kv_heads=2)
    res = dryrun.trace_cell(cfg, SHAPES_BY_NAME["train_4k"], mesh, device="cpu")
    assert res["cost"]["flops"] > 0 and res["memory"]["peak_bytes"] > 0
    if arch == "arctic-480b":
        from repro_torch.models import build_model, logical_axes
        from repro_torch.train.optimizer import make_optimizer

        assert res["optimizer"] == "adamw8bit"
        specs = build_model(cfg).specs
        state = make_optimizer("adamw8bit").state_specs(specs)
        axes = shd.optimizer_state_axes("adamw8bit", logical_axes(specs))
        desc = shd.MeshDesc({"data": 4, "model": 2})
        want = sum(t.numel() * t.element_size() // shd.shard_fraction(t.shape, ax, desc)
                   for t, ax in zip(_leaves(state), _leaves(axes)))
        assert res["memory"]["by_argument"]["opt"] == want


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------------------
# fake rules of the sampler kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def no_build(monkeypatch):
    """Building or loading a kernel library fails the test."""
    def boom(*a, **k):
        raise AssertionError("a fake trace reached _build.load")
    monkeypatch.setattr(_build, "load", boom)
    kfake.reset_traced()


# (plan method, truncation chain, draws per row) -> the launches the route
# records (PERF.md §6)
PLAN_ROUTES = {
    ("kernel", False, 1): {"blocksums": 1, "walk": 1},
    ("kernel", False, 4): {"blocksums": 1, "walk": 1},
    ("kernel", True, 1): {"fused_trunc_draw": 1},
    ("kernel_trunc", True, 1): {"fused_trunc_draw": 1},
}


@pytest.mark.parametrize("method,chain,S", list(PLAN_ROUTES))
def test_plan_kernel_route_traces_its_fake_rules(method, chain, S, no_build, port_tuner):
    """``plan((8, 4096), method=m).sample_logits`` on fake cuda logits
    traces the route's kernels by their fake rules: nothing built, the
    output shaped as the plain version's on real CPU tensors.  (Plans
    whose other steps make cuda tensors this CPU-only PyTorch cannot make,
    even fake ones, trace on the card: the other methods, and S draws
    under a chain, whose thresholds K11 and K12 take.)"""
    tr = (sampling.TopK(64), sampling.TopP(0.95)) if chain else None
    sig = "kp" if chain else ""
    with FakeTensorMode():
        p = sampling.plan((8, 4096), method=method, backend="cuda", transforms=sig)
        out = p.sample_logits(torch.empty((8, 4096), device="cuda"), None, temperature=1.0,
                              num_samples=S, transforms=tr)
    plain = sampling.plan((8, 4096), method=method, backend="cpu", transforms=sig).sample_logits(
        torch.randn((8, 4096)), torch.Generator().manual_seed(0), temperature=1.0,
        num_samples=S, transforms=tr)
    assert (tuple(out.shape), out.dtype) == (tuple(plain.shape), plain.dtype)
    assert out.device.type == "cuda"
    assert kfake.TRACED == PLAN_ROUTES[(method, chain, S)]
    assert all(kfake.TRACED_BYTES[n] > 0 for n in kfake.TRACED)


def _entry_calls():
    """The sampler kernels' entry points that no plan of the table above
    reaches on the CPU: name -> (call on inputs made on a device; fake
    cuda inputs are made empty, which a fake tensor is anyway)."""
    from repro_torch.kernels.alias_build import kernel as KA
    from repro_torch.kernels.butterfly_sample import kernel as KB
    from repro_torch.kernels.butterfly_sample import ops as bops
    from repro_torch.kernels.butterfly_table import ops as tops

    def weights(dev):
        return torch.ones((64, 4096), device=dev)

    def ints(dev, shape, high):
        if dev == "cuda":
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return torch.randint(0, high, shape, dtype=torch.int32)

    def vec(dev, n):
        return torch.full((n,), 0.5, device=dev)

    prm = [64.0, 0.95, 0.0]
    running = (lambda d: KB.blocksums(weights(d), 128, 32) if d == "cuda"
               else KB.blocksums_torch(weights(d), 128, 32))
    return {
        "masked_blocksums": lambda d: (KB.masked_blocksums if d == "cuda" else
                                       KB.masked_blocksums_torch)(weights(d), vec(d, 64), 128,
                                                                  32),
        "walk_trunc": lambda d: (KB.walk_trunc if d == "cuda" else KB.walk_trunc_torch)(
            weights(d), running(d), vec(d, 256), vec(d, 64), ints(d, (256,), 64), 128),
        "butterfly_table": lambda d: tops.butterfly_table(weights(d), W=32),
        "fused_draw": lambda d: bops.butterfly_sample(weights(d), torch.zeros(64, device=d),
                                                      W=32),
        "fused_draw_rng": lambda d: bops.butterfly_sample_rng(weights(d), [1, 2], W=32),
        "fused_trunc_draw_rng": lambda d: bops.butterfly_sample_truncated_rng(
            weights(d), [1, 2], torch.tensor([prm] * 64, device=d), W=32),
        "alias_assemble": lambda d: (KA.alias_assemble if d == "cuda" else
                                     KA.alias_assemble_torch)(
            torch.ones((64, 4096), device=d), ints(d, (64,), 4096), ints(d, (64, 4096), 4096)),
    }


@pytest.mark.parametrize("name", ["butterfly_table", "fused_draw", "fused_draw_rng",
                                  "fused_trunc_draw_rng", "masked_blocksums", "walk_trunc",
                                  "alias_assemble"])
def test_kernel_entry_traces_its_fake_rule(name, no_build):
    """K1, K4, K5, K10, K11, K12 and K13 on fake cuda tensors: the launch
    name traced (K12 after the K2 that makes its running sums), outputs
    shaped as the plain version's."""
    call = _entry_calls()[name]
    with FakeTensorMode():
        out = call("cuda")
    plain = call("cpu")
    outs, plains = (out, plain) if isinstance(out, tuple) else ((out,), (plain,))
    assert [(tuple(o.shape), o.dtype) for o in outs] == \
        [(tuple(o.shape), o.dtype) for o in plains]
    assert kfake.TRACED == ({name: 1, "blocksums": 1} if name == "walk_trunc" else {name: 1})


def test_host_alias_build_raises_by_name_under_a_trace():
    """The host Vose build reads the weights' values: on a fake tensor it
    raises, naming itself, where it would compute with made-up values."""
    from repro_torch.core.alias import build_alias_tables_host

    with FakeTensorMode():
        w = torch.empty((4, 16))
        with pytest.raises(ValueError, match="host alias build"):
            build_alias_tables_host(w)


def test_measure_mode_never_times_during_trace(port_tuner, monkeypatch):
    """The reference's regression under a fake trace: measure mode falls
    back to the cost model (nothing timed, a "model" entry persisted) and
    no weights are digested."""
    from repro_torch.autotune import tuner as tuner_mod
    from repro_torch.autotune.cache import bucket_key
    from repro_torch.autotune.tables import content_digest
    from repro_torch.sampling.plan import METHODS

    def timed(*a, **k):
        raise AssertionError("timed in trace")

    monkeypatch.setattr(tuner_mod, "measure_candidates", timed)
    monkeypatch.setattr(tuner_mod, "measure_method", timed)
    monkeypatch.setenv("REPRO_AUTOTUNE", "measure")
    autotune.reset()
    assert not tuner_mod._tracing_active()
    with FakeTensorMode():
        assert tuner_mod._tracing_active()
        w = torch.ones((16, 4096))
        assert content_digest(w) is None
        p = sampling.plan((16, 4096), method="auto", backend="cpu")
        assert p.method in METHODS
    entry = autotune.get_tuner().cache.get(bucket_key("cpu", 16, 4096, 1, "float32"))
    assert entry is not None and entry["source"] == "model"


# ---------------------------------------------------------------------------
# fake equals real, and the globals a trace sets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_fake_trace_equals_real_run(kind, port_tuner):
    """A SMOKE cell traced, then run for real on the CPU with inputs of the
    same shapes: FlopCounterMode over the real step counts the trace's
    FLOPs, and the tally's memory (arguments, peak, outputs, in-place
    writes) and bytes are the same."""
    cfg, shape = get_config("llama3-8b", smoke=True), smoke_shape(kind)
    traced = dryrun.trace_cell(cfg, shape, None, device="cpu")
    args = dryrun.real_inputs(cfg, shape, "cpu", seed=0)
    run = dryrun.cell_step(cfg, shape, args)
    tally = dryrun.StepTally()
    arg_bytes = tally.add_arguments(args)
    with FlopCounterMode(display=False) as fc, tally.counting():
        out = run()
    mem = tally.result(out)
    assert traced["cost"]["flops"] == fc.get_total_flops() == tally.flops > 0
    assert traced["cost"]["bytes_accessed"] == tally.bytes
    assert traced["memory"]["argument_bytes"] == arg_bytes
    for k in ("output_bytes", "temp_bytes", "alias_bytes"):
        assert traced["memory"][k] == mem[k], k
    if kind == "decode":   # the caches are written in place
        assert mem["alias_bytes"] > 0


def test_trace_restores_globals_where_reference_leaves_them(port_tuner, monkeypatch):
    """A trace that fails restores the attention threshold and the
    activation mesh; the reference's ``lower_cell`` restores the
    threshold only after a successful lower (dryrun.py:211) and never
    resets the activation mesh (:141)."""
    import jax

    import repro.launch.dryrun as ref_dry
    from repro.configs import get_config as ref_config
    from repro.dist import sharding as ref_shd
    from repro.models import attention as ref_attn

    from repro_torch.models import attention as attn
    from repro_torch.serve import engine

    def fail(*a, **k):
        raise RuntimeError("step fails")

    cfg = get_config("llama3-8b", smoke=True)
    monkeypatch.setattr(engine, "make_prefill_step", fail)
    with pytest.raises(RuntimeError, match="step fails"):
        dryrun.trace_cell(cfg, smoke_shape("prefill"), None, device="cpu",
                          chunked_threshold=128, act_seq_shard=True)
    assert attn.CHUNKED_THRESHOLD == 4096 and shd.activation_mesh() is None

    monkeypatch.setattr(ref_attn, "CHUNKED_THRESHOLD", ref_attn.CHUNKED_THRESHOLD)
    monkeypatch.setitem(ref_shd._ACT_CTX, "mesh", None)
    monkeypatch.setattr(ref_dry, "get_config", lambda a: ref_config(a, smoke=True))
    monkeypatch.setattr(ref_dry, "make_production_mesh",
                        lambda multi_pod=False: jax.make_mesh((1, 1), ("data", "model")))
    monkeypatch.setattr(ref_dry, "make_prefill_step", fail)
    with pytest.raises(RuntimeError, match="step fails"):
        ref_dry.lower_cell("llama3-8b", "prefill_32k", compile_=False, chunked_threshold=128,
                           act_seq_shard=True)
    assert ref_attn.CHUNKED_THRESHOLD == 128 and ref_shd._ACT_CTX["mesh"] is not None


def _cache_write_worker(rank, world, out):
    """Rank ``rank`` of 2 on a (1, 2) mesh: a decode step written into a
    cache whose sequence shards over ``model`` lands in the cache."""
    from repro_torch.launch.mesh import smallest_fitting_mesh
    from repro_torch.models import attention as attn

    mesh = smallest_fitting_mesh(data=1, model=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    whole, new = torch.randn((2, 8, 1, 4), generator=g), torch.randn((2, 1, 1, 4), generator=g)
    sh = shd.named_sharding(tuple(whole.shape), ("batch", "kv_seq", "kv_heads", "head"), mesh)
    assert [p.is_shard(1) for p in sh.placements] == [False, True], sh
    for pos in (2, 6, 9):   # rank 0's half, rank 1's, clamped to the end
        cache = shd.device_put({"k": whole.clone()}, {"k": sh})["k"]
        attn._cache_update(cache, new, pos)
        want = whole.clone()
        start = min(pos, 7)
        want[:, start:start + 1] = new
        assert torch.equal(cache.full_tensor(), want), pos


def test_decode_writes_into_a_sequence_sharded_cache(tmp_path):
    """The dry-run's finding (ROADMAP F4): DTensor writes a slice of a
    sharded sequence into a gathered copy; the port writes each rank's
    block in place, on two gloo ranks."""
    from torch_ranks import run_ranks

    run_ranks(_cache_write_worker, tmp_path, 2)


# ---------------------------------------------------------------------------
# costing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "train"), ("seamless-m4t-medium", "train"),
                                       ("seamless-m4t-medium", "decode")])
def test_total_is_layers_times_body_plus_the_rest(arch, kind, port_tuner):
    """The trace counts every layer: its FLOPs are L x body_cost per stack
    plus the work outside the layers (the one-layer-per-stack trace less
    its bodies), and corrected_totals equals the trace's totals."""
    cfg, shape = get_config(arch, smoke=True), smoke_shape(kind)
    full = dryrun.trace_cell(cfg, shape, None, device="cpu")
    depth = {"decoder": cfg.num_layers, "encoder": cfg.encoder_layers,
             "encdec_decoder": cfg.num_layers}
    one = dataclasses.replace(cfg, num_layers=1, encoder_layers=min(cfg.encoder_layers, 1))
    bodies = {st: costing.body_cost(cfg, shape, None, None, kind, st)
              for st in costing.stacks(cfg, kind)}
    rest = (dryrun.trace_cell(one, shape, None, device="cpu")["cost"]["flops"]
            - sum(b["flops"] for b in bodies.values()))
    assert all(depth[st] > 1 and b["flops"] > 0 for st, b in bodies.items())
    assert full["cost"]["flops"] == sum(depth[st] * b["flops"] for st, b in bodies.items()) + rest
    assert costing.corrected_totals(full, cfg, bodies) == {
        "flops_total": full["cost"]["flops"],
        "bytes_total": full["cost"]["bytes_accessed"],
        "collective_bytes_total": full["collectives"]["total_bytes"]}


def test_encdec_decode_body_costs_where_reference_raises():
    """The enc-dec decode body splits the cache length as the model does
    and returns a cost; the reference's calls encdec_cache_specs without
    src_len (costing.py:148) and raises TypeError."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.configs.base import ShapeConfig as RefShape
    from repro.dist import sharding as ref_shd
    from repro.launch import costing as ref_costing

    arch = "seamless-m4t-medium"
    got = costing.body_cost(get_config(arch, smoke=True), smoke_shape("decode"), None, None,
                            "decode", "encdec_decoder")
    assert got["flops"] > 0 and got["bytes_accessed"] > 0
    mesh = jax.make_mesh((1,), ("data",))
    with pytest.raises(TypeError, match="src_len"), mesh:
        ref_costing.body_cost(ref_config(arch, smoke=True), RefShape("t", 64, 8, "decode"),
                              mesh, ref_shd.DEFAULT_RULES, "decode", "encdec_decoder")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_writes_one_file_per_cell_and_skips_it_after(tmp_path):
    """``python -m repro_torch.launch.dryrun --device cpu --smoke`` writes
    one JSON file per cell with the reference's keys less ``compile_s``,
    then skips the cell; importing the modules brings up no group."""
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp_path), "REPRO_TORCH_AUTOTUNE_CACHE": str(tmp_path / "a.json")}
    imp = subprocess.run(
        [sys.executable, "-c", "import repro_torch.launch.dryrun, repro_torch.launch.costing, "
         "torch.distributed as d; print(d.is_initialized())"],
        env=env, capture_output=True, text=True, timeout=120, check=True)
    assert imp.stdout.strip().splitlines()[-1] == "False"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--smoke",
           "--arch", "qwen3-4b", "--shape", "decode_32k", "--out", str(tmp_path / "out")]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert first.returncode == 0, first.stderr[-3000:]
    res = json.loads((tmp_path / "out" / "qwen3-4b__decode_32k__single.json").read_text())
    ref_keys = {"arch", "shape", "kind", "mesh", "devices", "params", "lower_s", "memory",
                "cost", "collectives", "body_costs", "corrected", "status"}
    assert ref_keys <= set(res) and "compile_s" not in res, sorted(res)
    assert res["status"] == "ok" and res["mesh"] == "pod16x16" and res["devices"] == 256
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"} <= set(res["memory"])
    assert set(res["cost"]) == {"flops", "bytes_accessed"}
    assert set(res["corrected"]) == {"flops_total", "bytes_total", "collective_bytes_total"}
    second = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0 and "[skip] qwen3-4b__decode_32k__single" in second.stdout
    assert np.isfinite(res["cost"]["flops"]) and res["cost"]["flops"] > 0
