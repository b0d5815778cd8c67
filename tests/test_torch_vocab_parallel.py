"""The port's sharded loss, unembedding and 8-bit moments on spawned gloo
groups of 2 and 4 ranks ((data, model) meshes (1, 2) and (2, 2)), against
the unsharded port and the reference on the same numpy-seeded inputs.

* The vocab-parallel loss (``train_step._lse_gold_per_shard``) and the
  per-shard unembedding (``layers._unembed_per_shard``), in each layout
  the rules give the logits (vocabulary split over ``model``; positions
  split where the vocabulary does not divide; where neither divides, the
  vocabulary split unevenly), with a padded
  vocabulary, gemma2's final softcap, a tied table and a z-loss: the loss,
  the CE and every gradient within rtol 1e-5 (atol 1e-7 on gradients) of
  the unsharded ``cross_entropy`` and of ``repro.train.train_step.
  cross_entropy`` (float32; the sharded sums reduce in another order).
  bfloat16 logits: the loss within rtol 1e-5, the bfloat16 gradient within
  one bfloat16 ulp (rtol 2**-8), the rounding of a float32 value that the
  order moved.
* 8-bit AdamW on DTensor leaves (``optimizer._per_block_shard``): codes
  and scales bit-equal to the unsharded quantization for leaves split on
  both mesh dims, for a leaf whose split is not block-aligned (gathered)
  and for one whose state the rules replicate; a full update bit-equal.
* ``layers.reshape`` of a DTensor whose local shard is not contiguous,
  forward and backward (one head a ``model`` rank).
"""

import os

import numpy as np
import pytest
import torch

# (name, (B, S, V), vocab_size or None, softcap, tied, dtype): the cases of
# the loss.  "logits" cases hand numpy logits to cross_entropy; the others
# project numpy hidden states through unembed first.
B, S, D = 4, 6, 8
LOSS_CASES = {
    "vocab": dict(V=12, kind="logits"),                     # 12 columns split over model
    "positions": dict(V=11, kind="logits"),                 # 11 does not divide: positions
    "neither": dict(V=11, S=5, kind="logits"),              # neither divides: 6 + 5 columns
    "bf16": dict(V=12, kind="logits", dtype="bfloat16"),
    "unembed": dict(V=12, kind="unembed"),
    "padded": dict(V=12, vocab=10, kind="unembed"),         # columns 10, 11 masked
    "padded_positions": dict(V=13, vocab=11, kind="unembed"),
    "softcap_tied": dict(V=12, softcap=5.0, tied=True, kind="unembed"),
    "softcap_positions": dict(V=11, softcap=5.0, kind="unembed"),
}
Z = 1e-3


def _case(name):
    c = {**dict(S=S, vocab=None, softcap=0.0, tied=False, dtype="float32"), **LOSS_CASES[name]}
    rng = np.random.default_rng(sum(map(ord, name)))
    c["tokens"] = rng.integers(0, c["vocab"] or c["V"], (B, c["S"])).astype(np.int32)
    if c["kind"] == "logits":
        c["logits"] = (3 * rng.standard_normal((B, c["S"], c["V"]))).astype(np.float32)
        c["labels"] = c["tokens"]
        c["mask"] = (rng.random((B, c["S"])) < 0.8).astype(np.float32)
    else:
        c["h"] = rng.standard_normal((B, c["S"], D)).astype(np.float32)
        shape = (c["V"], D) if c["tied"] else (D, c["V"])
        c["table"] = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return c


def _port_loss(c, mesh=None):
    """(loss, ce, gradients) of a case by the port; ``mesh``: on DTensors
    placed as the launchers place them."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist import sharding as shd
    from repro_torch.models import layers
    from repro_torch.train import train_step as ts

    dt = getattr(torch, c["dtype"])
    names = ("logits",) if c["kind"] == "logits" else ("h", "table")
    leaves = [torch.tensor(c[n]).to(dt).requires_grad_(True) for n in names]

    def place(t, axes):
        if mesh is None:
            return t
        rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return rep.redistribute(mesh, shd.named_sharding(tuple(t.shape), axes, mesh).placements)

    if c["kind"] == "logits":
        logits = leaves[0]
        if mesh is not None:
            rep = DTensor.from_local(logits, mesh, [Replicate()] * mesh.ndim, run_check=False)
            logits = rep.redistribute(mesh, layers.logits_sharding(logits.shape, mesh).placements)
        loss, ce = ts.cross_entropy(logits, torch.tensor(c["labels"]), torch.tensor(c["mask"]),
                                    Z)
    else:
        h = place(leaves[0], ("batch", None, None))
        table = place(leaves[1], ("vocab", "embed") if c["tied"] else ("embed", "vocab"))
        logits = layers.unembed(None if c["tied"] else {"table": table}, h,
                                tied_table=table if c["tied"] else None,
                                softcap=c["softcap"], vocab_size=c["vocab"])
        loss, ce, _ = ts._loss(logits, {"tokens": place(torch.tensor(c["tokens"]),
                                                        ("batch", None))}, Z)
    grads = torch.autograd.grad(loss, leaves)
    out = [shd.whole(loss), shd.whole(ce)] + list(grads)
    return [t.detach().to(torch.float64).numpy() for t in out]


def _ref_loss(c):
    """The reference's (loss, ce, gradients) of a case, in float32."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jl
    from repro.train.train_step import cross_entropy as jce

    if c["kind"] == "logits":
        def f(lg):
            return jce(lg, jnp.asarray(c["labels"]), jnp.asarray(c["mask"]), Z)
        args = (jnp.asarray(c["logits"]).astype(c["dtype"]),)
    else:
        def f(h, table):
            if c["tied"]:
                lg = jl.unembed(None, h, tied_table=table, softcap=c["softcap"])
            else:
                lg = jl.unembed({"table": table}, h, softcap=c["softcap"])
            if c["vocab"] is not None:
                lg = jnp.where(jnp.arange(c["V"]) < c["vocab"], lg, jnp.asarray(-1e30, lg.dtype))
            toks = jnp.asarray(c["tokens"])
            return jce(lg[:, :-1], toks[:, 1:], jnp.ones(toks[:, 1:].shape, jnp.float32), Z)
        args = (jnp.asarray(c["h"]), jnp.asarray(c["table"]))
    loss, ce = f(*args)
    grads = jax.grad(lambda *a: f(*a)[0], argnums=tuple(range(len(args))))(*args)
    return [np.asarray(x, dtype=np.float64) for x in (loss, ce, *grads)]


# ---------------------------------------------------------------------------
# rank workers (module level: the spawned ranks unpickle them)
# ---------------------------------------------------------------------------


def _mesh(world):
    from repro_torch.launch.mesh import smallest_fitting_mesh

    return smallest_fitting_mesh(data=world // 2, model=2, device="cpu")


def _loss_worker(rank, world, out):
    mesh = _mesh(world)
    for name in LOSS_CASES:
        got = _port_loss(_case(name), mesh)
        if rank == 0:
            np.savez(os.path.join(out, f"loss_{name}.npz"), *got)


# (shape, logical axes) of the 8-bit leaves: split on both mesh dims as
# arctic's (32000, 7168) table is; a stacked expert leaf; a vector; rows
# that do not split into whole blocks a rank (the last block padded, or
# rows that do not divide); blocks the rules replicate
Q8_LEAVES = {
    "table": ((64, 512), ("vocab", "embed")),
    "experts": ((4, 8, 96), ("experts", "embed", "mlp")),
    "vector": ((512,), ("embed",)),
    "padded": ((2, 500), ("vocab", "embed")),
    "odd_rows": ((3, 512), ("mlp", "embed")),
    "replicated": ((6, 100), ("vocab", "embed")),
}


def _q8_worker(rank, world, out):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.train import optimizer as topt

    mesh = _mesh(world)
    rng = np.random.default_rng(7)
    params = {k: torch.tensor(rng.standard_normal(s).astype(np.float32))
              for k, (s, _) in Q8_LEAVES.items()}
    axes = {k: a for k, (_, a) in Q8_LEAVES.items()}
    p_sh = shd.tree_shardings(params, axes, mesh)
    placed = shd.device_put(params, p_sh)
    res = {}
    for k, x in params.items():
        dx = placed[k]
        if not hasattr(dx, "full_tensor"):   # a leaf the rules replicate, as a DTensor
            dx = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for q_fn, dq_fn, v in ((topt._q8, topt._dq8, x), (topt._q8_sqrt, topt._dq8_sqrt,
                                                         x.abs())):
            dv = dx.abs() if q_fn is topt._q8_sqrt else dx
            q, s = q_fn(v)
            dq, ds = q_fn(dv)
            state = shd.named_sharding(tuple(q.shape), ("qblocks", None), mesh)
            assert tuple(dq.placements) == tuple(ds.placements) == state.placements, k
            assert torch.equal(dq.full_tensor(), q) and torch.equal(ds.full_tensor(), s), k
            back = dq_fn(dq, ds, x.shape)
            assert torch.equal(shd.whole(back), dq_fn(q, s, x.shape)), k
        state, rows, _ = topt._block_rows(tuple(x.shape), mesh)
        res[k] = (shd.is_sharded(state), rows is not None)
    # two full updates, sharded against whole
    opt = topt.make_optimizer("adamw8bit", lr=1e-2, warmup=1, total_steps=10)
    o_axes = shd.optimizer_state_axes("adamw8bit", axes)
    state = opt.init(params)
    dstate = shd.device_put(state, shd.tree_shardings(state, o_axes, mesh))
    whole_p, dp = params, placed
    for step in range(2):
        g = {k: torch.tensor(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in params.items()}
        dg = shd.device_put(g, p_sh)
        whole_p, state = opt.update(g, whole_p, state, step)
        with implicit_replication():
            dp, dstate = opt.update(dg, dp, dstate, step)
        for k in params:
            assert torch.equal(shd.whole(dp[k]), whole_p[k]), (step, k)
            for n in ("m_q", "m_s", "v_q", "v_s"):
                assert torch.equal(shd.whole(dstate[k][n]), state[k][n]), (step, k, n)
    if rank == 0:
        np.save(os.path.join(out, "q8.npy"), np.array([res], dtype=object), allow_pickle=True)


def _reshape_worker(rank, world, out):
    """A DTensor (2 data, 8, 2, 3) with rows over ``data`` and one head a
    ``model`` rank, whose local (2, 8, 1, 3) block is a transposed view
    (strides (24, 1, 24, 8)) while its global strides say contiguous:
    ``reshape`` flattens rows and positions, and a gradient of that kind
    reshapes back."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models.layers import reshape

    mesh = _mesh(world)
    gen = torch.Generator().manual_seed(rank)

    def dtensor(local, shape, placements):
        assert not local.is_contiguous()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    rows = 2 * mesh.size(0)
    local = torch.randn((2, 1, 3, 8), generator=gen, dtype=torch.float64).permute(0, 3, 1, 2)
    x = dtensor(local, (rows, 8, 2, 3), [Shard(0), Shard(2)]).requires_grad_(True)
    y = reshape(x, (rows * 8, 2, 3))
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert torch.equal(y.to_local(), local.reshape(16, 1, 3))
    g_local = torch.randn((3, 1, 16), generator=gen, dtype=torch.float64).permute(2, 1, 0)
    (gx,) = torch.autograd.grad(y, x, dtensor(g_local, (rows * 8, 2, 3), y.placements))
    assert torch.equal(gx.to_local(), g_local.reshape(2, 8, 1, 3))


# ---------------------------------------------------------------------------
# the groups, once per world size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks_out(request, tmp_path_factory):
    from torch_ranks import run_ranks

    world = request.param
    out = tmp_path_factory.mktemp(f"vp{world}")
    run_ranks(_all_worker, out, world, timeout=300)
    return world, out


def _all_worker(rank, world, out):
    _loss_worker(rank, world, out)
    _q8_worker(rank, world, out)
    _reshape_worker(rank, world, out)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_sharded_loss_matches_unsharded_and_reference(name, ranks_out):
    """Loss, CE and gradients of each case on the mesh against the port's
    unsharded step and the reference's cross_entropy (module docstring:
    tolerances)."""
    _, out = ranks_out
    c = _case(name)
    with np.load(out / f"loss_{name}.npz") as z:
        got = [z[f"arr_{i}"] for i in range(len(z.files))]
    plain = _port_loss(c)
    ref = _ref_loss(c)
    bf16 = c["dtype"] == "bfloat16"
    for i, (g, p, r) in enumerate(zip(got, plain, ref)):
        rtol, atol = (1e-5, 0.0) if i < 2 else ((2.0 ** -8, 1e-7) if bf16 else (1e-5, 1e-7))
        np.testing.assert_allclose(g, p, rtol=rtol, atol=atol, err_msg=f"{name} output {i}")
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"{name} output {i}")


@pytest.mark.parametrize("leaf", list(Q8_LEAVES))
def test_8bit_moments_bit_equal_on_the_mesh(leaf, ranks_out):
    """The ranks held each leaf's codes, scales, dequantized moments and
    two full updates bit-equal to the unsharded ones; here: the route each
    leaf took.  On the (2, 2) mesh the state's blocks split over ``data``
    but for "replicated"; of those, "padded" and "odd_rows" have no split
    of their rows into whole blocks a rank and were gathered."""
    world, out = ranks_out
    split, by_rows = np.load(out / "q8.npy", allow_pickle=True)[0][leaf]
    assert split == (world == 4 and leaf != "replicated")
    assert by_rows == (world == 4 and leaf in ("table", "experts", "vector"))


def test_reshape_of_a_non_contiguous_local_shard(ranks_out):
    """The ranks reshaped a DTensor with a transposed local shard, and its
    gradient back (``_reshape_worker``); the group's exit is the check."""
    assert ranks_out[0] in (2, 4)


def test_logits_sharding_layouts():
    """The rules' layouts of the logits on a (16, 16) mesh description: the
    vocabulary over ``model`` where it divides (llama3-8b), else the
    positions (mamba2-370m's 50,280), rows over ``data``."""
    from repro_torch.dist import sharding as shd

    desc = shd.MeshDesc({"data": 16, "model": 16})
    assert shd.spec_for_shape((256, 4096, 128256), ("batch", "seq", "vocab"), desc) == \
        shd.PartitionSpec("data", None, "model")
    assert shd.spec_for_shape((256, 4096, 50280), ("batch", "seq", "vocab"), desc) == \
        shd.PartitionSpec("data", "model", None)
