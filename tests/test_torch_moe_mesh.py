"""The MoE dispatch, the MLP and the unembedding of a vocabulary that the
``model`` degree does not divide, on a mesh (``repro_torch.models.moe``,
``repro_torch.models.layers``; ROADMAP.md F5 (b)-(d)).

On one spawned gloo group of 4 ranks ((data, model) meshes (1, 4) and
(2, 2)), each case runs on DTensors placed by the rules (the activation
as the residual stream is placed, its positions over ``model`` where they
divide): ``moe_block`` on granite-moe's and arctic's SMOKE configs (a
rank's rows holding whole routing groups, or a group spanning the ranks'
rows, capacity that drops tokens, a decode step), ``mlp`` (pixtral-12b's
and hymba's SMOKE widths, a decode step, a batch of one row), and at
V = 130 (and 129) the unembedding of a decode step, the loss through it
(a padded vocabulary, a tied table) and the sharded draw.  Rank 0 writes
its results; the tests hold them to the unsharded port, and the outputs
(the aux loss too) to the reference's ``repro.models.moe.moe_block``,
``repro.models.layers.mlp`` / ``unembed`` and ``repro.train.train_step.
cross_entropy`` on the same numpy-seeded inputs.  The gradients of the
tokens, the router and the expert weights (the MLP's weights, the
table) are held to the unsharded port's, and the MLP's (a decode step's
with its weights in place too) to the reference's.  Two cases keep the
DTensor path of the unsharded code and are named so: experts that
``model`` does not divide, and the ``gather`` dispatch.  The sharded draw equals the
unsharded counter draw on the whole batch bit for bit (the ``gumbel``
draw also the reference's per-shard body).

Tolerance: float32, rtol 1e-5 and atol 1e-6 in units of the compared
tensor's largest magnitude, as tests/test_torch_attention_mesh.py holds
attention: the combine's partial sums over ``model``, a sharded
gradient's over the ranks and the aux loss's means over the ranks add in
another order than one einsum, and XLA contracts in its own order.

On a fake process group of 16 ranks (a (data, model) (2, 4) mesh,
``FakeTensorMode``): the FLOPs a device of the dispatch, combine and
experts, of the MLP and of the odd-vocabulary unembedding are the
unsharded count over the ranks that share it, a decode step's MLP
moves no weight, and arctic-480b's SMOKE prefill traces on the mesh
(its combined output a DTensor).
"""

import contextlib
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
KEY = np.array([7, 99], np.uint32)
W = 16                     # the draw's W-block
Z = 1e-3                   # the loss's z-loss

# name -> the case: the function ("moe", "mlp", "unembed", "loss", "draw"),
# the mesh, rows B and positions S, gradients or not, and its options
CASES = {
    "granite_1x4": dict(fn="moe", arch="granite-moe-1b-a400m", mesh="1x4", B=2, S=16,
                        grad=True),
    "granite_rows_hold_groups_2x2": dict(fn="moe", arch="granite-moe-1b-a400m", mesh="2x2",
                                         B=2, S=16, grad=True, group=16, cf=0.5),
    "granite_group_spans_rows_2x2": dict(fn="moe", arch="granite-moe-1b-a400m", mesh="2x2",
                                         B=2, S=16, grad=True),
    "granite_decode_2x2": dict(fn="moe", arch="granite-moe-1b-a400m", mesh="2x2", B=4, S=1),
    "arctic_1x4": dict(fn="moe", arch="arctic-480b", mesh="1x4", B=2, S=16, grad=True, cf=0.5),
    "arctic_2x2": dict(fn="moe", arch="arctic-480b", mesh="2x2", B=4, S=8, grad=True, group=8),
    "experts_do_not_divide_1x4": dict(fn="moe", arch="granite-moe-1b-a400m", mesh="1x4", B=2,
                                      S=16, grad=True, E=6),
    "gather_dispatch_1x4": dict(fn="moe", arch="granite-moe-1b-a400m", mesh="1x4", B=2, S=16,
                                grad=True, dispatch="gather"),
    "mlp_1x4": dict(fn="mlp", arch="pixtral-12b", mesh="1x4", B=2, S=16, grad=True),
    "mlp_2x2": dict(fn="mlp", arch="hymba-1.5b", mesh="2x2", B=2, S=8, grad=True),
    "mlp_decode_2x2": dict(fn="mlp", arch="pixtral-12b", mesh="2x2", B=4, S=1, grad=True),
    "mlp_decode_1x4": dict(fn="mlp", arch="hymba-1.5b", mesh="1x4", B=2, S=1, grad=True),
    "mlp_decode_one_row_2x2": dict(fn="mlp", arch="llama3-8b", mesh="2x2", B=1, S=1, grad=True),
    "mlp_one_row_2x2": dict(fn="mlp", arch="arctic-480b", mesh="2x2", B=1, S=8, grad=True),
    "unembed_decode_1x4": dict(fn="unembed", mesh="1x4", B=4, S=1, V=130),
    "unembed_decode_padded_2x2": dict(fn="unembed", mesh="2x2", B=4, S=1, V=129, vocab=126),
    "loss_1x4": dict(fn="loss", mesh="1x4", B=2, S=5, V=130, vocab=127, grad=True),
    "loss_tied_2x2": dict(fn="loss", mesh="2x2", B=2, S=5, V=129, tied=True, grad=True),
    "draw_kernel_1x4": dict(fn="draw", mesh="1x4", B=8, V=130, method="kernel"),
    "draw_gumbel_2x2": dict(fn="draw", mesh="2x2", B=8, V=129, method="gumbel"),
}
# the MoE cases that keep the unsharded code on DTensors
TODAYS_PATH = ("experts_do_not_divide_1x4", "gather_dispatch_1x4")
D_UNEMBED = 16


def _cfg(name, port=True):
    """The case's SMOKE config with its MoE options (the port's or the
    reference's)."""
    if port:
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    c = CASES[name]
    cfg = get_config(c.get("arch", "llama3-8b"), smoke=True)
    if c["fn"] == "moe":
        kw = {k: c[n] for n, k in (("group", "group_tokens"), ("cf", "capacity_factor"),
                                   ("E", "num_experts")) if n in c}
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))
    return cfg


def _specs(name):
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_spec, unembed_spec
    from repro_torch.models.params import ParamSpec

    c, cfg = CASES[name], _cfg(name)
    if c["fn"] == "moe":
        return moe.moe_spec(cfg)
    if c["fn"] == "mlp":
        return mlp_spec(cfg.d_model, cfg.d_ff)
    if c.get("tied"):
        return {"table": ParamSpec((c["V"], D_UNEMBED), ("vocab", "embed"))}
    return unembed_spec(c["V"], D_UNEMBED)


def _arrays(name):
    """The case's numpy inputs from a seed of its name: parameters (normal
    by fan-in; the router at unit scale, so that no two experts tie), the
    activation, the weights of the gradient's loss, tokens or logits."""
    from repro_torch.models import params as tparams

    c, cfg = CASES[name], _cfg(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if c["fn"] == "draw":
        return {"z": (3 * rng.standard_normal((c["B"], c["V"]))).astype(np.float32)}

    def leaf(sp):
        x = rng.standard_normal(sp.shape).astype(np.float32)
        return x / np.float32(np.sqrt(tparams._fan_in(sp)))

    d = D_UNEMBED if c["fn"] in ("unembed", "loss") else cfg.d_model
    a = {"params": tparams.tree_map(leaf, _specs(name)),
         "x": rng.standard_normal((c["B"], c["S"], d)).astype(np.float32),
         "w": rng.standard_normal((c["B"], c["S"], d)).astype(np.float32)}
    if c["fn"] == "loss":
        a["tokens"] = rng.integers(0, c.get("vocab", c["V"]), (c["B"], c["S"])).astype(np.int32)
    return a


def _port(name, mesh=None):
    """The case's outputs (and gradients) by the port: numpy, keyed ``y``,
    ``aux``, ``loss``, ``ce``, ``grad.<leaf>``; ``mesh``: on DTensors placed
    by the rules."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.models import layers, moe
    from repro_torch.models.params import logical_axes, params_from_numpy
    from repro_torch.train import train_step as ts

    c, cfg, a = CASES[name], _cfg(name), _arrays(name)
    if c["fn"] == "draw":
        return _port_draw(name, mesh)

    def put(t, axes):
        """``t`` placed by the rules; a tensor they replicate, as a
        replicated DTensor (as a layer's input is on a mesh)."""
        if mesh is None:
            return t
        t = shd.device_put({"t": t}, {"t": shd.named_sharding(tuple(t.shape), axes, mesh)})["t"]
        return t if hasattr(t, "full_tensor") else \
            DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    params = params_from_numpy(a["params"], device="cpu")
    if mesh is not None:
        params = shd.device_put(params, shd.tree_shardings(params, logical_axes(_specs(name)),
                                                           mesh))
    seq = "act_seq" if c["fn"] in ("moe", "mlp") else None
    xp = put(torch.tensor(a["x"]), ("batch", seq, None))
    leaves = {"x": xp, **params}
    if c.get("grad"):
        for t in leaves.values():
            t.requires_grad_(True)
    out = {}
    with implicit_replication() if mesh is not None else contextlib.nullcontext():
        if c["fn"] == "moe":
            y, aux = moe.moe_block(params, xp, cfg, c.get("dispatch", "einsum"))
            loss = (y * torch.tensor(a["w"])).sum() + 0.5 * aux
            out["aux"] = shd.whole(aux).detach().numpy()
        elif c["fn"] == "mlp":
            y = layers.mlp(params, xp, cfg.act)
            loss = (y * torch.tensor(a["w"])).sum()
        else:
            tied = c.get("tied", False)
            y = layers.unembed(None if tied else params, xp,
                               tied_table=params["table"] if tied else None,
                               vocab_size=c.get("vocab"))
            if c["fn"] == "loss":
                toks = put(torch.tensor(a["tokens"]), ("batch", None))
                loss, ce, _ = ts._loss(y, {"tokens": toks}, Z)
                out.update(loss=shd.whole(loss).detach().numpy(),
                           ce=shd.whole(ce).detach().numpy())
        if c.get("grad"):
            grads = torch.autograd.grad(shd.whole(loss), list(leaves.values()))
            out.update({f"grad.{k}": shd.whole(g).numpy() for k, g in zip(leaves, grads)})
    out["y"] = shd.whole(y).detach().numpy()
    if mesh is not None and c["fn"] == "unembed":   # the logits' columns over model
        out["placements"] = np.array([str(p) for p in y.placements])
    return out


def _port_draw(name, mesh):
    """The sharded draw from logits placed as the unembedding places them
    (columns unevenly over ``model``), or (``mesh`` None) the unsharded
    counter draw: the per-shard body on the whole batch."""
    from repro_torch import sampling
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import rng as trng
    from repro_torch.models import layers
    from repro_torch.sampling import sharded as tsh

    c, z = CASES[name], torch.tensor(_arrays(name)["z"])
    if mesh is None:
        got = tsh._shard_sample_logits(c["method"], W, z, torch.tensor(1.0),
                                       trng.seed_from_key(KEY), 0, 1)
        return {"y": got.numpy()}
    sh = layers.logits_sharding(tuple(z.shape), mesh)
    zd = shd.device_put({"z": z}, {"z": sh})["z"]
    p = sampling.plan(tuple(z.shape), method=c["method"], W=W, mesh=mesh)
    return {"y": shd.whole(p.sample_logits(zd, key=KEY)).numpy(),
            "placements": np.array([str(q) for q in zd.placements])}


def _reference(name):
    """The case's outputs by the reference's functions."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jl
    from repro.models import moe as jmoe
    from repro.train.train_step import cross_entropy as jce

    c, a = CASES[name], _arrays(name)
    jp = jax.tree.map(jnp.asarray, a["params"])
    x = jnp.asarray(a["x"])
    if c["fn"] == "moe":   # jitted: quicker than the eager ops at this size
        block = jax.jit(jmoe.moe_block, static_argnums=(2, 3))
        y, aux = block(jp, x, _cfg(name, port=False), c.get("dispatch", "einsum"))
        return {"y": np.asarray(y), "aux": np.asarray(aux)}
    if c["fn"] == "mlp":
        return {"y": np.asarray(jl.mlp(jp, x, _cfg(name, port=False).act))}
    tied = c.get("tied", False)
    y = jl.unembed(None if tied else jp, x, tied_table=jp["table"] if tied else None)
    if "vocab" in c:
        y = jnp.where(jnp.arange(c["V"]) < c["vocab"], y, jnp.asarray(-1e30, y.dtype))
    out = {"y": np.asarray(y)}
    if c["fn"] == "loss":
        toks = jnp.asarray(a["tokens"])
        loss, ce = jce(y[:, :-1], toks[:, 1:], jnp.ones(toks[:, 1:].shape, jnp.float32), Z)
        out.update(loss=np.asarray(loss), ce=np.asarray(ce))
    return out


# ---------------------------------------------------------------------------
# the gloo group: every case on its mesh, once for the module
# ---------------------------------------------------------------------------


def _worker(rank, world, out):
    from pathlib import Path

    from repro_torch.launch.mesh import smallest_fitting_mesh
    from repro_torch.models import moe

    meshes = {n: smallest_fitting_mesh(data=d, model=m, device="cpu")
              for n, (d, m) in MESHES.items()}
    per_shard = moe._moe_per_shard
    calls = {}

    def counted(*a, **k):
        calls[current] = calls.get(current, 0) + 1
        return per_shard(*a, **k)

    moe._moe_per_shard = counted
    for current, c in CASES.items():
        got = _port(current, meshes[c["mesh"]])
        if rank == 0:
            np.savez(Path(out) / f"{current}.npz", **got)
    if rank == 0:
        (Path(out) / "per_shard.json").write_text(json.dumps(calls))


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    from torch_ranks import run_ranks

    out = tmp_path_factory.mktemp("moe_mesh")
    run_ranks(_worker, out, 4, timeout=300)
    return out


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    """Within ``rtol``, and ``atol`` times the larger of 1 and ``want``'s
    largest magnitude (module docstring)."""
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_matches_unsharded_and_reference(name, ranks_out):
    """Each case on its mesh: its outputs (the aux loss, the loss and CE
    too) and gradients match the unsharded port; its outputs the
    reference's; a draw equals the unsharded counter draw exactly."""
    with np.load(ranks_out / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files}
    got.pop("placements", None)
    plain = _port(name)
    assert sorted(got) == sorted(plain)
    if CASES[name].get("grad"):
        assert any(k.startswith("grad.") for k in got)
    if CASES[name]["fn"] == "draw":
        np.testing.assert_array_equal(got["y"], plain["y"])
        return
    for k in got:
        _close(got[k], plain[k], f"{name} {k}: mesh vs unsharded")
    for k, want in _reference(name).items():
        _close(got[k], want, f"{name} {k}: mesh vs reference")


def _reference_mlp_grads(name):
    """The gradients of an MLP case's loss by the reference's
    ``repro.models.layers.mlp`` (``jax.grad``), keyed as :func:`_port`
    keys them."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jl

    a, act = _arrays(name), _cfg(name, port=False).act

    def loss(p, x):
        return jnp.sum(jl.mlp(p, x, act) * jnp.asarray(a["w"]))

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, a["params"]),
                                            jnp.asarray(a["x"]))
    return {"grad.x": np.asarray(gx), **{f"grad.{k}": np.asarray(v) for k, v in gp.items()}}


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["fn"] == "mlp"])
def test_mlp_gradients_match_the_reference(name, ranks_out):
    """Each MLP case on its mesh (sequence-parallel, or a decode step's
    weights in place): the input's gradient and every weight's match the
    reference's."""
    with np.load(ranks_out / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files if k.startswith("grad.")}
    want = _reference_mlp_grads(name)
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k], f"{name} {k}: mesh vs reference")


def test_moe_paths(ranks_out):
    """Every MoE case where ``model`` divides the experts took the
    per-shard dispatch once; experts that ``model`` does not divide (6 on
    4 ranks) and the ``gather`` dispatch keep the unsharded code on
    DTensors."""
    calls = json.loads((ranks_out / "per_shard.json").read_text())
    moes = [n for n, c in CASES.items() if c["fn"] == "moe"]
    assert calls == {n: 1 for n in moes if n not in TODAYS_PATH}


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c["fn"] in ("unembed", "draw")])
def test_odd_vocabulary_splits_the_columns(name, ranks_out):
    """The logits of a vocabulary that ``model`` does not divide (130 on 4
    ranks, 129 on 2) and of one position split their columns over
    ``model``, unevenly."""
    with np.load(ranks_out / f"{name}.npz") as z:
        placements = list(z["placements"])
    assert placements[1] == ("S(1)" if CASES[name]["fn"] == "draw" else "S(2)"), placements


def test_gumbel_draw_matches_the_reference():
    """The unsharded counter draw the mesh's gumbel draw equals is the
    reference's per-shard body on the whole batch."""
    import jax.numpy as jnp

    from repro.kernels import rng as jrng
    from repro.sampling import distribution as jdist
    from repro.sampling import sharded as jsh

    name = "draw_gumbel_2x2"
    z = _arrays(name)["z"]
    d = jdist.Categorical(method="gumbel", W=W, shape=z.shape,
                          state={"logw": jnp.asarray(z).astype(jnp.float32)})
    want = np.asarray(jsh._local_draw(d, jrng.seed_from_key(jnp.asarray(KEY)), 0, 1))
    np.testing.assert_array_equal(_port(name)["y"], want)


# ---------------------------------------------------------------------------
# the fake group: FLOPs a device, a trace of arctic's prefill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_mesh():
    """A fake group of 16 ranks and a cpu (data, model) (2, 4) mesh on it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    assert not dist.is_initialized()
    dryrun.fake_process_group(16)
    try:
        yield DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _traced(fn, mesh, *shapes_axes, grad=False):
    """FLOPs a device of ``fn`` on fake tensors of the given (shape, axes)
    placed on ``mesh`` by the rules (one device where ``mesh`` is None),
    its gradient too with ``grad``."""
    return _tally(fn, mesh, *shapes_axes, grad=grad).flops


def _tally(fn, mesh, *shapes_axes, grad=False):
    """The ``dryrun.StepTally`` of :func:`_traced`'s trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun

    with FakeTensorMode(allow_non_fake_inputs=True):
        ins = [dryrun._place(torch.empty(shape), axes, mesh, shd.DEFAULT_RULES)
               for shape, axes in shapes_axes]
        if grad:
            for t in ins:
                t.requires_grad_(True)
        tally = dryrun.StepTally()
        with implicit_replication() if mesh is not None else contextlib.nullcontext(), \
                tally.counting():
            y = fn(*ins)
            if grad:
                torch.autograd.grad(y.sum(), ins)
    return tally


def _moe_cfg(E=8):
    from repro_torch.configs import get_config

    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=E,
                                                            group_tokens=32))


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_moe_flops_are_split_over_the_ranks(kind, fake_mesh):
    """On the (2, 4) mesh with 8 experts, the dispatch, combine and expert
    products count 1/8 of their one-device FLOPs a device: forward and
    backward in train, where each rank's rows hold whole groups; in
    decode, where one group spans every row, each rank dispatches its own
    tokens and runs its experts on its half of d_model (the weights stay).
    The router's product is each rank's rows', on every ``model`` rank."""
    from repro_torch.models import moe

    cfg = _moe_cfg()
    m, D, E = cfg.moe, cfg.d_model, cfg.moe.num_experts
    B, S = (4, 32) if kind == "train" else (16, 1)
    G, g = moe._group(B * S, m)
    spec = moe.moe_spec(cfg)
    args = [((B, S, D), ("batch", "act_seq" if S > 1 else None, None))] + \
        [(sp.shape, sp.axes) for sp in spec.values()]

    def fn(x, *ws):
        y, aux = moe.moe_block(dict(zip(spec, ws)), x, cfg)
        return y.sum() + aux

    def router(x, r, *_):
        return moe._router(r, x.reshape(G, g, D), m)[2]

    grad = kind == "train"
    one = _traced(fn, None, *args, grad=grad)
    route = _traced(router, None, *args[:2], grad=grad)
    per_device = _traced(fn, fake_mesh, *args, grad=grad)
    rows, model = 2, 4     # the data ranks that split the rows; model ranks
    assert per_device * rows * model == (one - route) + route * model, (per_device, one)
    assert 0 < route < one / 8


@pytest.mark.parametrize("S", [32, 1])
def test_mlp_flops_are_split_over_the_ranks(S, fake_mesh):
    """On the (2, 4) mesh the MLP counts 1/8 of its one-device FLOPs a
    device, forward and backward (S = 32) or a decode step (S = 1): each
    rank its rows, every position, its columns of d_ff."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("pixtral-12b", smoke=True)
    spec = layers.mlp_spec(cfg.d_model, cfg.d_ff)
    args = [((4, S, cfg.d_model), ("batch", "act_seq" if S > 1 else None, None))] + \
        [(sp.shape, sp.axes) for sp in spec.values()]

    def fn(x, *ws):
        return layers.mlp(dict(zip(spec, ws)), x, cfg.act)

    one = _traced(fn, None, *args, grad=S > 1)
    per_device = _traced(fn, fake_mesh, *args, grad=S > 1)
    assert one > 0 and per_device * 8 == one, (per_device, one)


def test_decode_mlp_moves_no_weight(fake_mesh):
    """A decode step's MLP on the (2, 4) mesh keeps its weights in place:
    each of its collectives carries fewer values than a rank's block of a
    weight (the rows to this rank's columns of d_model, the gate and up
    products, the output), so no weight is gathered."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config("pixtral-12b", smoke=True)
    D, F = cfg.d_model, cfg.d_ff
    spec = layers.mlp_spec(D, F)
    args = [((8, 1, D), ("batch", None, None))] + [(sp.shape, sp.axes) for sp in spec.values()]

    def fn(x, *ws):
        return layers.mlp(dict(zip(spec, ws)), x, cfg.act)

    moved = _tally(fn, fake_mesh, *args).collectives
    assert moved
    block = D * F // 8   # a rank's block of a weight: D over 2 data ranks, d_ff over 4
    big = [(kind, shapes) for kind, shapes, _ in moved
           if max(int(np.prod(s)) for s in shapes) >= block]
    assert not big, big


@pytest.mark.parametrize("tied", [False, True])
def test_odd_vocabulary_unembedding_flops(tied, fake_mesh):
    """A decode step's unembedding at V = 130 on the (2, 4) mesh: each rank
    projects its half of the rows onto its ceil(130 / 4) = 33 columns."""
    from repro_torch.models import layers

    V, D = 130, 64
    table = ((V, D), ("vocab", "embed")) if tied else ((D, V), ("embed", "vocab"))

    def fn(x, t):
        return layers.unembed(None if tied else {"table": t}, x,
                              tied_table=t if tied else None)

    args = [((4, 1, D), ("batch", None, None)), table]
    one = _traced(fn, None, *args)
    per_device = _traced(fn, fake_mesh, *args)
    assert one > 0 and per_device * 2 * V == one * 33, (per_device, one)


def test_arctic_prefill_traces_on_a_mesh(fake_mesh, monkeypatch, tmp_path):
    """arctic-480b's SMOKE prefill on the (2, 4) mesh: the MoE output, a
    DTensor, and its dense residual take the per-shard paths, and the
    step traces."""
    from repro_torch import autotune
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, moe

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    calls = {"moe": 0, "mlp": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(moe, "_moe_per_shard", count("moe", moe._moe_per_shard))
    monkeypatch.setattr(layers, "_mlp_per_shard", count("mlp", layers._mlp_per_shard))
    cfg = get_config("arctic-480b", smoke=True)
    try:
        res = dryrun.trace_cell(cfg, ShapeConfig("t", 64, 8, "prefill"), fake_mesh,
                                device="cpu")
    finally:
        autotune.reset()
    assert res["cost"]["flops"] > 0 and res["memory"]["peak_bytes"] > 0
    assert calls == {"moe": cfg.num_layers, "mlp": cfg.num_layers}
