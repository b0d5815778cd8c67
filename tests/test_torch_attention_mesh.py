"""Attention on a mesh whose ``model`` degree does not divide the heads
(``repro_torch.models.attention``, ROADMAP.md F5 (a) and F6).

On one spawned gloo group of 4 ranks, ((data, model) meshes (1, 4) and
(2, 2)), the port's ``gqa_attend`` (the full ``_sdpa`` path, the chunked
path, a sliding window, a softcap, the non-causal encoder, decode at a
position inside the first, a middle and the last block of the cache's
keys), ``cross_attend``, ``mla_attend_full``, ``mla_attend_decode``,
hymba's attention over its meta tokens and local window, and hymba's
whole forward run on DTensors placed by the rules, with head counts the
``model`` degree does not divide: the queries' positions split over
``model`` in train and prefill, the cache's keys in decode (log-sum-exp
over the blocks).  Rank 0 writes its results; the tests hold them to the
unsharded port and to the reference's ``repro.models.attention``
functions (hymba's forward: ``repro.models``) on the same numpy-seeded
inputs and parameters (``params_from_numpy`` carries them to the port),
and the train path's gradients to the unsharded port's (four cases' to
the reference's too: GQA, chunked, cross-attention, MLA).

Tolerance: float32, rtol 1e-5 and atol 1e-6 in units of the compared
tensor's largest magnitude (``_close``).  The blocks sum in another order
than the unsharded softmax, a gradient's partial sums over the ranks add
in another order than one matmul's, and XLA and PyTorch contract in their
own orders: a few float32 ulps of the tensor's largest entries (up to
~7e-6 on gradients of magnitude ~20 in these cases), which an absolute
1e-6 would take for a fault in the entries near zero.  The port's mesh
path where every ``model`` rank attends every head differs from the
unsharded port by as much.  hymba's whole forward (four layers, its SSM
branch too) is held at rtol and atol 1e-4, as tests/test_torch_models.py
holds the models.

On a fake process group (``FakeTensorMode``, as ``test_torch_dryrun.py``
traces): the attention FLOPs a device, a decode step's core's and the
whole train branch's with its projections, are the unsharded count over
the ranks that share it, a decode step issues no all-gather of a
cache-shaped tensor, and minicpm3-4b's SMOKE config with 6 heads traces a decode step
on a 3-D (pod, data, model) mesh (F6).  ``layers.reshape`` of a
``Partial`` DTensor gives the reduced tensor (on the gloo ranks).
"""

import contextlib
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6
B, S, T = 2, 16, 16   # rows, positions of a full block, cache length
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}

# name -> the case: family ("gqa", "mla", "hybrid"), heads, kv heads, mesh,
# kind ("full", "cross", "decode", "model"), and its options
CASES = {
    "gqa_1x4": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="full"),
    "gqa_2x2": dict(fam="gqa", H=3, KV=1, mesh="2x2", kind="full"),
    "gqa_window_softcap": dict(fam="gqa", H=6, KV=3, mesh="1x4", kind="full", window=8,
                               softcap=5.0),
    "gqa_chunked_1x4": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="full", window=8,
                            softcap=5.0, chunked=True),
    "gqa_chunked_2x2": dict(fam="gqa", H=3, KV=3, mesh="2x2", kind="full", chunked=True),
    "encoder_1x4": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="full", causal=False),
    "encoder_chunked_2x2": dict(fam="gqa", H=3, KV=1, mesh="2x2", kind="full", causal=False,
                                chunked=True),
    "cross_1x4": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="cross"),
    "gqa_heads_divide": dict(fam="gqa", H=8, KV=2, mesh="1x4", kind="full"),
    "gqa_positions_do_not_divide": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="full", S=15),
    "decode_first_block": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="decode", pos=1,
                               window=8, softcap=5.0),
    "decode_middle_block": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="decode", pos=6,
                                window=8, softcap=5.0),
    "decode_last_block": dict(fam="gqa", H=6, KV=2, mesh="1x4", kind="decode", pos=14,
                              window=8, softcap=5.0),
    "decode_2x2": dict(fam="gqa", H=3, KV=1, mesh="2x2", kind="decode", pos=12),
    "mla_1x4": dict(fam="mla", H=6, KV=6, mesh="1x4", kind="full"),
    "mla_chunked_2x2": dict(fam="mla", H=3, KV=3, mesh="2x2", kind="full", chunked=True),
    "mla_gather_kv_2x2": dict(fam="mla", H=3, KV=3, mesh="2x2", kind="full"),
    "mla_decode_first_block": dict(fam="mla", H=6, KV=6, mesh="1x4", kind="decode", pos=1),
    "mla_decode_middle_block": dict(fam="mla", H=6, KV=6, mesh="1x4", kind="decode", pos=6),
    "mla_decode_last_block": dict(fam="mla", H=6, KV=6, mesh="1x4", kind="decode", pos=14),
    "mla_decode_2x2": dict(fam="mla", H=3, KV=3, mesh="2x2", kind="decode", pos=3),
    "hymba_window": dict(fam="hybrid", H=6, KV=2, mesh="1x4", kind="full", S=32, window=16),
    "hymba_meta_tokens": dict(fam="hybrid", H=6, KV=2, mesh="1x4", kind="model"),
}
# the path each case takes on its mesh (attention.MESH_PATHS)
PATHS = {n: {"decode": "keys"}.get(c["kind"], "queries") for n, c in CASES.items()}
PATHS.update(gqa_heads_divide="heads", gqa_positions_do_not_divide="whole")
TRAIN = [n for n, c in CASES.items() if c["kind"] in ("full", "cross")]
MODEL_TOL = 1e-4   # the whole forward, as tests/test_torch_models.py holds it
CHUNK_AT = 8   # CHUNKED_THRESHOLD for the chunked cases: S = 16 takes the chunked path
HYMBA_TOKENS = 24   # + 8 meta tokens = 32 positions, past hymba's local window of 16


def _base(fam):
    return {"gqa": "gemma2-9b", "mla": "minicpm3-4b", "hybrid": "hymba-1.5b"}[fam]


def _cfg(name, port=True):
    """The case's SMOKE config with its head counts (the port's, or the
    reference's)."""
    if port:
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    c = CASES[name]
    kw = dict(num_heads=c["H"], num_kv_heads=c["KV"], attn_softcap=c.get("softcap", 0.0))
    if c["fam"] == "hybrid":
        kw["num_layers"] = 4   # layer 1 windowed (hymba's full layers: 0, L // 2, L - 1)
    return dataclasses.replace(get_config(_base(c["fam"]), smoke=True), **kw)


def _specs(name):
    """(parameter specs, cache specs or None) of a case, the port's."""
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model

    c, cfg = CASES[name], _cfg(name)
    if c["kind"] == "model":
        return build_model(cfg).specs, None
    if c["fam"] == "mla":
        return attn.mla_spec(cfg), attn.mla_cache_spec(cfg, B, T)
    if c["kind"] == "cross":
        return attn.cross_attention_spec(cfg), None
    return attn.gqa_spec(cfg), attn.gqa_cache_spec(cfg, B, T)


def _arrays(name):
    """The case's numpy inputs, from a seed of its name: parameters (normal
    by fan-in, norms at one), the block (or the decode step), the cache,
    cross-attention memory, the weights of the gradient's loss."""
    from repro_torch.models import params as tparams

    c, cfg = CASES[name], _cfg(name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    specs, cache_specs = _specs(name)

    def leaf(sp, scale=True):
        if sp.init == "ones":
            return np.ones(sp.shape, np.float32)
        x = rng.standard_normal(sp.shape).astype(np.float32)
        return x * np.float32(sp.scale / np.sqrt(tparams._fan_in(sp))) if scale else x

    a = {"params": tparams.tree_map(leaf, specs)}
    s = 1 if c["kind"] == "decode" else c.get("S", S)
    if c["kind"] == "model":
        a["tokens"] = rng.integers(0, cfg.vocab_size, (B, HYMBA_TOKENS)).astype(np.int32)
        return a
    a["x"] = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    a["w"] = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    if c["kind"] == "decode":
        a["cache"] = tparams.tree_map(lambda sp: leaf(sp, scale=False), cache_specs)
    if c["kind"] == "cross":
        hd = cfg.resolved_head_dim
        a["memory"] = [rng.standard_normal((B, 12, c["KV"], hd)).astype(np.float32)
                       for _ in range(2)]
        a["memory_valid"] = np.arange(12) < 9
    return a


def _port(name, mesh=None):
    """The case's outputs (and gradients) by the port: numpy, keyed
    ``y``, ``cache.<leaf>``, ``grad.<i>``; ``mesh``: on DTensors placed by
    the rules."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.params import logical_axes, params_from_numpy, tree_leaves

    c, cfg, a = CASES[name], _cfg(name), _arrays(name)
    specs, cache_specs = _specs(name)

    def put(tree, axes):
        """The tree placed by the rules; a leaf they replicate, as a
        replicated DTensor (as a layer's input is on a mesh)."""
        if mesh is None:
            return tree
        placed = shd.device_put(tree, shd.tree_shardings(tree, axes, mesh))
        return {k: v if hasattr(v, "full_tensor") else
                DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim, run_check=False)
                for k, v in placed.items()}

    params = params_from_numpy(a["params"], device="cpu")
    if mesh is not None:
        params = shd.device_put(params, shd.tree_shardings(params, logical_axes(specs), mesh))
    train = name in TRAIN
    leaves = tree_leaves(params)
    if "x" in a:
        x = put({"x": torch.tensor(a["x"])}, {"x": ("batch", None, None)})["x"]
        leaves = [x] + leaves
    if train:
        for t in leaves:
            t.requires_grad_(True)
    old = attn.CHUNKED_THRESHOLD
    if c.get("chunked"):
        attn.CHUNKED_THRESHOLD = CHUNK_AT
    out = {}
    try:
        with implicit_replication() if mesh is not None else contextlib.nullcontext():
            if c["kind"] == "model":
                toks = put({"t": torch.tensor(a["tokens"])}, {"t": ("batch", None)})["t"]
                y, _ = build_model(cfg).apply(params, {"tokens": toks})
            elif c["kind"] == "cross":
                mem = put({"k": torch.tensor(a["memory"][0]), "v": torch.tensor(a["memory"][1])},
                          {"k": ("batch", None, "kv_heads", "head"),
                           "v": ("batch", None, "kv_heads", "head")})
                y = attn.cross_attend(params, x, (mem["k"], mem["v"]), cfg,
                                      memory_valid=torch.tensor(a["memory_valid"]))
            elif c["kind"] == "decode":
                cache = put(params_from_numpy(a["cache"], device="cpu"),
                            logical_axes(cache_specs))
                pos = c["pos"]
                if c["fam"] == "mla":
                    y, cache = attn.mla_attend_decode(params, x, cache, pos, cfg)
                else:
                    y, cache = attn.gqa_attend(params, x, torch.full((1,), pos), cfg,
                                               window=c.get("window", 0), cache=cache,
                                               cache_pos=pos)
                out.update({f"cache.{k}": shd.whole(v).numpy() for k, v in cache.items()})
            elif c["fam"] == "mla":
                y, _ = attn.mla_attend_full(params, x, torch.arange(S), cfg)
            else:
                s = c.get("S", S)
                y, _ = attn.gqa_attend(params, x, torch.arange(s), cfg,
                                       causal=c.get("causal", True), window=c.get("window", 0))
            if train:
                loss = shd.whole((y * torch.tensor(a["w"])).sum())
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                out.update({f"grad.{i}": shd.whole(g).numpy() for i, g in enumerate(grads)
                            if g is not None})
    finally:
        attn.CHUNKED_THRESHOLD = old
    out["y"] = shd.whole(y).detach().numpy()
    return out


def _reference(name, monkeypatch):
    """The case's outputs by the reference's functions (``y``, ``cache.<leaf>``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn
    from repro.models import build_model as jbuild

    c, jcfg, a = CASES[name], _cfg(name, port=False), _arrays(name)
    jp = jax.tree.map(jnp.asarray, a["params"])
    if c.get("chunked"):
        monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", CHUNK_AT)
    out = {}
    if c["kind"] == "model":
        y, _ = jbuild(jcfg).apply(jp, {"tokens": jnp.asarray(a["tokens"])}, remat="none")
    elif c["kind"] == "cross":
        y = jattn.cross_attend(jp, jnp.asarray(a["x"]), tuple(map(jnp.asarray, a["memory"])),
                               jcfg, memory_valid=jnp.asarray(a["memory_valid"]))
    elif c["kind"] == "decode":
        cache = jax.tree.map(jnp.asarray, a["cache"])
        x, pos = jnp.asarray(a["x"]), jnp.int32(c["pos"])
        if c["fam"] == "mla":
            y, cache = jattn.mla_attend_decode(jp, x, cache, pos, jcfg)
        else:
            y, cache = jattn.gqa_attend(jp, x, jnp.full((1,), c["pos"]), jcfg,
                                        window=c.get("window", 0), cache=cache, cache_pos=pos)
        out.update({f"cache.{k}": np.asarray(v) for k, v in cache.items()})
    elif c["fam"] == "mla":
        y, _ = jattn.mla_attend_full(jp, jnp.asarray(a["x"]), jnp.arange(S), jcfg)
    else:
        s = c.get("S", S)
        y, _ = jattn.gqa_attend(jp, jnp.asarray(a["x"]), jnp.arange(s), jcfg,
                                causal=c.get("causal", True), window=c.get("window", 0))
    out["y"] = np.asarray(y)
    return out


def _reference_grads(name, monkeypatch):
    """The gradients of a full-block case's loss by the reference's
    functions (``jax.grad``), keyed as :func:`_port` keys them: ``grad.0``
    the input's, then every parameter's in sorted key order."""
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn

    c, jcfg, a = CASES[name], _cfg(name, port=False), _arrays(name)
    if c.get("chunked"):
        monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", CHUNK_AT)
    s = c.get("S", S)

    def loss(p, x):
        if c["kind"] == "cross":
            y = jattn.cross_attend(p, x, tuple(map(jnp.asarray, a["memory"])), jcfg,
                                   memory_valid=jnp.asarray(a["memory_valid"]))
        elif c["fam"] == "mla":
            y, _ = jattn.mla_attend_full(p, x, jnp.arange(s), jcfg)
        else:
            y, _ = jattn.gqa_attend(p, x, jnp.arange(s), jcfg, causal=c.get("causal", True),
                                    window=c.get("window", 0))
        return jnp.sum(y * jnp.asarray(a["w"]))

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, a["params"]),
                                            jnp.asarray(a["x"]))
    return {f"grad.{i}": np.asarray(g) for i, g in enumerate([gx] + jax.tree.leaves(gp))}


# ---------------------------------------------------------------------------
# the gloo group: every case on its mesh, once for the module
# ---------------------------------------------------------------------------


def _partial_reshape(mesh):
    """``layers.reshape`` of a DTensor holding partial sums over ``model``:
    a flatten whose first dim (3) does not divide over ``model`` reduces
    the sums first and gives the summed tensor; one whose first dim (8)
    divides keeps them partial, with the same sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.models.layers import reshape

    md = mesh.mesh_dim_names.index("model")
    n = mesh.size(md)
    coord = mesh.get_coordinate()[md]
    base = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    pl = [Partial() if m == md else Replicate() for m in range(mesh.ndim)]
    x = DTensor.from_local(base * (coord + 1), mesh, pl, run_check=False)
    y = reshape(x, (2, 24))
    assert not any(p.is_partial() for p in y.placements), y.placements
    assert torch.equal(y.to_local(), (base * (n * (n + 1) // 2)).reshape(2, 24))
    base = base.reshape(2, 8, 3)   # rank i of model holds (i + 1) x base
    x = DTensor.from_local(base * (coord + 1), mesh, pl, run_check=False)
    y = reshape(x, (2, 24))
    assert y.placements[md].is_partial(), y.placements
    assert torch.equal(y.full_tensor(), (base * (n * (n + 1) // 2)).reshape(2, 24))


def _worker(rank, world, out):
    from pathlib import Path

    from repro_torch.launch.mesh import smallest_fitting_mesh
    from repro_torch.models import attention as attn

    meshes = {n: smallest_fitting_mesh(data=d, model=m, device="cpu")
              for n, (d, m) in MESHES.items()}
    paths = {}
    for name, c in CASES.items():
        attn.MESH_PATHS.clear()
        got = _port(name, meshes[c["mesh"]])
        paths[name] = dict(attn.MESH_PATHS)
        if rank == 0:
            np.savez(Path(out) / f"{name}.npz", **got)
    for mesh in meshes.values():
        _partial_reshape(mesh)
    if rank == 0:
        (Path(out) / "paths.json").write_text(json.dumps(paths))


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    from torch_ranks import run_ranks

    out = tmp_path_factory.mktemp("attn_mesh")
    run_ranks(_worker, out, 4, timeout=300)
    return out


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    """Within ``rtol``, and ``atol`` times the larger of 1 and ``want``'s
    largest magnitude (module docstring)."""
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_attention_matches_unsharded_and_reference(name, ranks_out, monkeypatch):
    """Each case on its mesh took its path, and its outputs (caches too)
    and gradients match the unsharded port; its outputs the reference's."""
    paths = json.loads((ranks_out / "paths.json").read_text())[name]
    assert set(paths) == {PATHS[name]}, paths
    with np.load(ranks_out / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files}
    plain = _port(name)
    assert sorted(got) == sorted(plain)
    if name in TRAIN:
        assert any(k.startswith("grad.") for k in got)
    tol = (MODEL_TOL, MODEL_TOL) if CASES[name]["kind"] == "model" else (RTOL, ATOL)
    for k in got:
        _close(got[k], plain[k], f"{name} {k}: mesh vs unsharded", *tol)
    for k, want in _reference(name, monkeypatch).items():
        _close(got[k], want, f"{name} {k}: mesh vs reference", *tol)


@pytest.mark.parametrize("name", ["gqa_2x2", "gqa_chunked_1x4", "cross_1x4",
                                  "mla_gather_kv_2x2"])
def test_mesh_gradients_match_the_reference(name, ranks_out, monkeypatch):
    """Cases whose projections run on the ranks' own positions (GQA whole
    and chunked, cross-attention, MLA): the input's
    gradient and every used weight's match the reference's (every train
    case's match the unsharded port's, above)."""
    with np.load(ranks_out / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files if k.startswith("grad.")}
    want = _reference_grads(name, monkeypatch)
    assert "grad.0" in got and set(got) <= set(want)
    for k in got:
        _close(got[k], want[k], f"{name} {k}: mesh vs reference")


def test_partial_reshape_reduces_the_sums(ranks_out):
    """The ranks reshaped a DTensor of partial sums on both meshes
    (``_partial_reshape``); the group's exit is the check."""
    assert (ranks_out / "paths.json").exists()


# ---------------------------------------------------------------------------
# the fake group: FLOPs and collectives a device, the 3-D mesh (F6)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_meshes():
    """A fake group of 16 ranks and two cpu meshes on it: (data, model)
    (2, 4) and (pod, data, model) (2, 2, 4)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    assert not dist.is_initialized()
    dryrun.fake_process_group(16)
    try:
        yield (DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model")),
               DeviceMesh("cpu", torch.arange(16).reshape(2, 2, 4),
                          mesh_dim_names=("pod", "data", "model")))
    finally:
        dist.destroy_process_group()


def _traced(fn, mesh, *shapes_axes, grad=False):
    """FLOPs a device of ``fn`` on fake tensors of the given (shape, axes,
    dtype) placed on ``mesh`` by the rules (one device where ``mesh`` is
    None), its gradient too with ``grad``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun

    with FakeTensorMode(allow_non_fake_inputs=True):
        ins = [dryrun._place(torch.empty(shape, dtype=dt), axes, mesh, shd.DEFAULT_RULES)
               for shape, axes, dt in shapes_axes]
        if grad:
            for t in ins:
                t.requires_grad_(True)
        tally = dryrun.StepTally()
        with implicit_replication() if mesh is not None else contextlib.nullcontext(), \
                tally.counting():
            y = fn(*ins)
            if grad:
                torch.autograd.grad(y.sum(), ins)
    return tally.flops


QKV = ("batch", None, "heads", None)
CACHE = ("batch", "kv_seq", "kv_heads", "head")
F32 = torch.float32


def _branch_flops(kind, mesh, monkeypatch):
    """(FLOPs on one device, FLOPs a device on ``mesh``, the mesh's
    ``MESH_PATHS``) of a train layer's whole attention branch
    (projections, core, ``wo``), forward and backward, with 6 heads:
    ``gqa_attend`` ("gqa"; "train" with a softcap; "chunked"; the
    non-causal "encoder"), ``mla_attend_full`` ("mla_kv"; "mla_train"
    chunked) or ``cross_attend`` ("cross")."""
    from repro_torch.models import attention as attn
    from repro_torch.models.params import tree_leaves

    case = {"train": "gqa_window_softcap", "cross": "cross_1x4"}.get(kind, "gqa_1x4")
    cfg = _cfg("mla_1x4" if kind.startswith("mla") else case)
    if kind in ("chunked", "mla_train"):
        monkeypatch.setattr(attn, "CHUNKED_THRESHOLD", CHUNK_AT)
    Bf, Sf, Sk = 4, 64, 24
    specs = attn.mla_spec(cfg) if kind.startswith("mla") else attn.gqa_spec(cfg)
    if kind == "cross":   # its keys and values are the memory's
        specs = {k: specs[k] for k in ("wo", "wq")}
    pos = torch.arange(Sf)
    args = [((Bf, Sf, cfg.d_model), ("batch", "act_seq", None), F32)] + \
        [(sp.shape, sp.axes, F32) for sp in tree_leaves(specs)]
    if kind == "cross":
        kv = ((Bf, Sk, cfg.num_kv_heads, cfg.resolved_head_dim), ("batch", None, "kv_heads",
                                                                   "head"), F32)
        args += [kv, kv]

    def params_of(ws):   # one leaf each (a norm's scale), in the leaves' order
        it = iter(ws)
        return {k: {"scale": next(it)} if isinstance(specs[k], dict) else next(it)
                for k in sorted(specs)}

    def fn(x, *ws):
        if kind == "cross":
            return attn.cross_attend(params_of(ws[:-2]), x, ws[-2:], cfg)
        if kind.startswith("mla"):
            return attn.mla_attend_full(params_of(ws), x, pos, cfg)[0]
        return attn.gqa_attend(params_of(ws), x, pos, cfg, causal=kind != "encoder",
                               window=24)[0]

    one = _traced(fn, None, *args, grad=True)
    attn.MESH_PATHS.clear()
    per_device = _traced(fn, mesh, *args, grad=True)
    return one, per_device, dict(attn.MESH_PATHS)


@pytest.mark.parametrize("kind", ["train", "chunked", "encoder", "decode", "mla_train",
                                  "mla_decode"])
def test_attention_flops_are_split_over_the_ranks(kind, fake_meshes, monkeypatch):
    """On the (2, 4) mesh with 6 heads, attention counts 1/8 of its
    one-device FLOPs a device: in train (forward and backward) the whole
    branch (:func:`_branch_flops`), each rank on its rows' block of
    positions; in decode the core, each rank on its block of the cache's
    keys with every head."""
    from repro_torch.models import attention as attn

    mesh = fake_meshes[0]
    if "decode" not in kind:
        one, per_device, paths = _branch_flops(kind, mesh, monkeypatch)
        assert one > 0 and per_device * 8 == one, (per_device, one)
        assert paths == {"queries": 1}
        return
    Bf, Sf, H, KV, hd = 4, 64, 6, 2, 16
    dmask = (torch.arange(Sf) <= 40)[None, :]
    if kind == "decode":
        fn = lambda q, k, v: attn._sdpa(q, k, v, dmask, 5.0, kv_sharded=True)  # noqa: E731
        args = [((Bf, 1, H, hd), QKV, F32)] + [((Bf, Sf, KV, hd), CACHE, F32)] * 2
    else:   # the absorbed MLA decode's scores and context, r = 16, rope = 8
        def fn(q_c, q_pe, c_kv, k_pe):
            if not hasattr(c_kv, "full_tensor"):
                s = (attn.einsum("bsnr,btr->bnst", q_c, c_kv)
                     + attn.einsum("bsnh,bth->bnst", q_pe, k_pe)).float()
                return attn.einsum("bnst,btr->bsnr", torch.softmax(s, -1), c_kv)
            return attn._mla_ctx_blocks(q_c, q_pe, c_kv, k_pe, dmask, 0.1, mesh)

        lat = ("batch", "kv_seq", None)
        args = [((Bf, 1, H, 16), QKV, F32), ((Bf, 1, H, 8), QKV, F32),
                ((Bf, Sf, 16), lat, F32), ((Bf, Sf, 8), lat, F32)]
    one = _traced(fn, None, *args)
    attn.MESH_PATHS.clear()
    per_device = _traced(fn, mesh, *args)
    assert one > 0 and per_device * 8 == one, (per_device, one)
    assert set(attn.MESH_PATHS) == {"keys"}


@pytest.mark.parametrize("kind", ["gqa", "mla_kv", "cross"])
def test_projection_flops_are_split_over_the_ranks(kind, fake_meshes, monkeypatch):
    """A train layer's whole attention branch (projections, core, ``wo``),
    forward and backward, on the (2, 4) mesh with 6 heads counts 1/8 of
    its one-device FLOPs a device: each rank projects its rows' block of
    positions, MLA expands its latents on them."""
    one, per_device, paths = _branch_flops(kind, fake_meshes[0], monkeypatch)
    assert paths == {"queries": 1}
    assert one > 0 and per_device * 8 == one, (per_device, one)


def test_decode_step_gathers_no_cache(fake_meshes, monkeypatch, tmp_path):
    """hymba-1.5b's SMOKE decode step with 6 heads on the (2, 4) mesh:
    every attention layer combines its blocks of keys by two all-reduces,
    and no all-gather carries a tensor with the cache's length."""
    from repro_torch import autotune
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    cfg = dataclasses.replace(_cfg("hymba_meta_tokens"), num_layers=2)
    shape = ShapeConfig("t", 96, 8, "decode")
    cache_len = build_model(cfg).cache_specs(8, 96)["attn"]["k"].shape[2]
    attn.MESH_PATHS.clear()
    try:
        res = dryrun.trace_cell(cfg, shape, fake_meshes[0], device="cpu")
    finally:
        autotune.reset()
    assert res["cost"]["flops"] > 0
    assert dict(attn.MESH_PATHS) == {"keys": cfg.num_layers}
    by = res["collectives_by"]
    assert sum(c for c, _ in by.values()) == sum(res["collectives"]["op_counts"].values())
    gathers = [k for k in by if k.startswith("all-gather")]
    assert not [k for k in gathers if f"{cache_len}," in k or f"{cache_len // 4}," in k], gathers
    reduces = sum(c for k, (c, _) in by.items() if k.startswith("all-reduce"))
    assert reduces >= 2 * cfg.num_layers


def test_mla_decode_traces_on_a_3d_mesh(fake_meshes, monkeypatch, tmp_path):
    """F6: minicpm3-4b's SMOKE config with 6 heads traces a decode step on
    the (pod, data, model) (2, 2, 4) mesh: the output projection reshapes
    partial sums over ``model`` that DTensor would scatter over 6 heads
    on 4 ranks."""
    from repro_torch import autotune
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import attention as attn

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    cfg = dataclasses.replace(get_config("minicpm3-4b", smoke=True), num_heads=6, num_kv_heads=6)
    attn.MESH_PATHS.clear()
    try:
        res = dryrun.trace_cell(cfg, ShapeConfig("t", 64, 8, "decode"), fake_meshes[1],
                                device="cpu")
    finally:
        autotune.reset()
    assert res["mesh"] == "pod2x16x16" and res["devices"] == 16
    assert res["cost"]["flops"] > 0 and res["memory"]["peak_bytes"] > 0
    assert dict(attn.MESH_PATHS) == {"keys": cfg.num_layers}
