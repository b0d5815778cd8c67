"""The port's seeded draws (the plain versions of K5 and K10) and its
mesh-sharded sampler (``repro_torch.sampling.sharded``) against the
reference, on the same numpy inputs.

The seeded draws are held against the reference's Pallas kernels in
interpret mode.  The sharded sampler is held against the reference's
per-shard draw (``repro.sampling.sharded._local_draw`` and the seeded
kernels), which needs no ``shard_map``: counters are global rows, so a
sharded draw over R ranks must equal those single-device functions on the
whole batch.  One-rank gloo meshes run in this process; the 4-rank cases
run in one spawned group of 4 gloo processes, each writing its shards to
a file, with every collective of ``torch.distributed`` counted around each
draw (wrapped functions, and a dispatch mode that sees every c10d op).

Tolerance: integer weights keep every fp32 sum exact, so indices must be
equal.  Draws from logits (weights from ``exp``) or Dirichlet weights may
differ from the reference only at float64-checked boundary ties
(``ref.boundary_ties``, ``ref.trunc_boundary_ties``); between the port's
own sharded and whole-batch draws every index must be equal."""

import functools
import multiprocessing
import os
import traceback
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import rng as jrng
from repro.kernels.butterfly_sample import ops as jops
from repro.sampling import distribution as jdist
from repro.sampling import sharded as jsh
from repro.sampling import transforms as jtr
from repro_torch import sampling
from repro_torch.kernels import rng as trng
from repro_torch.kernels.butterfly_sample import kernel as KB
from repro_torch.kernels.butterfly_sample import ops
from repro_torch.kernels.butterfly_sample.ref import boundary_ties, trunc_boundary_ties
from repro_torch.sampling import distribution as tdist
from repro_torch.sampling import sharded as tsh

SEED = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
OFFSETS = [0, 1000, 2**32 - 7]            # the last wraps inside the batch
METHODS = ("prefix", "fenwick", "butterfly", "two_level", "kernel", "gumbel", "alias",
           "alias_device", "radix_forest")
TRUNC_METHODS = ("kernel", "two_level", "gumbel")
B, K, W = 16, 300, 16                      # the sharded cases' workload
KEY = np.array([7, 99], np.uint32)
WORLD = 4
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
               "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "scatter",
               "gather", "barrier", "send", "recv", "isend", "irecv")


def _int_weights(seed, B, K):
    return np.random.default_rng(seed).integers(1, 1000, size=(B, K)).astype(np.float32)


def _params(seed, B):
    """(B, 3) [top_k, top_p, min_p] rows; row r % 4 disables top-k, top-p,
    min-p, or all three."""
    g = np.random.default_rng(seed)
    k = g.integers(1, 40, B).astype(np.float32)
    p = g.uniform(0.5, 1.0, B).astype(np.float32)
    m = g.uniform(0.0, 0.05, B).astype(np.float32)
    r = np.arange(B) % 4
    k[(r == 0) | (r == 3)] = 0
    p[(r == 1) | (r == 3)] = 1
    m[(r == 2) | (r == 3)] = 0
    return np.stack([k, p, m], axis=1)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x)


# ---------------------------------------------------------------------------
# The seeded draws (K5, K10 plain versions) against the reference's kernels
# ---------------------------------------------------------------------------


def test_cipher_known_values():
    """Threefry-2x32 (20 rounds) and Philox-4x32-10 on Random123's
    known-answer vectors; the port's Threefry on the reference's."""
    threefry = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0))]
    for key, ctr, want in threefry:
        got = trng.threefry2x32(*key, *ctr)
        assert tuple(int(x) for x in got) == want
        assert tuple(int(x) for x in trng.threefry2x32(*(torch.tensor(v) for v in key + ctr))) \
            == want
        assert tuple(int(x) for x in jrng.threefry2x32(*(np.uint32(v) for v in key + ctr))) \
            == want
    philox = [((0, 0), (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
              ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 4,
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
              ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for key, ctr, want in philox:
        assert tuple(int(x) for x in trng.philox4x32(*key, *ctr)) == want
    # the host fold equals the tensor fold
    s = trng.seed_from_key(SEED)
    assert torch.equal(trng.fold(s, trng.TAG_U, 5), trng.fold(s, torch.tensor(1), 5))


@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("B,K", [(5, 17), (24, 300), (16, 2000)])
def test_seeded_draw_equals_reference(W, B, K):
    """K5's plain version and both routes against the reference's
    butterfly_sample_rng (Pallas, interpret mode), on integer weights."""
    w = _int_weights(B * 31 + K + W, B, K)
    for off in OFFSETS:
        want = np.asarray(jops.butterfly_sample_rng(_j(w), _j(SEED), row_offset=jnp.uint32(off),
                                                    W=W))
        for route in (None, "fused", "two_pass"):
            got = ops.butterfly_sample_rng(_t(w), SEED, row_offset=off, W=W, route=route)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{off} {route}")


@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("B,K", [(5, 17), (24, 300), (16, 2000)])
def test_seeded_truncated_draw_equals_reference(W, B, K):
    """K10's plain version and both routes against the reference's
    butterfly_sample_truncated_rng (interpret mode): integer weights,
    per-row params with disabled stages."""
    w = _int_weights(B * 37 + K + W, B, K)
    prm = _params(B + K, B)
    for off in OFFSETS:
        want = np.asarray(jops.butterfly_sample_truncated_rng(
            _j(w), _j(SEED), _j(prm), row_offset=jnp.uint32(off), W=W))
        for route in (None, "fused", "two_pass"):
            got = ops.butterfly_sample_truncated_rng(_t(w), SEED, _t(prm), row_offset=off, W=W,
                                                     route=route)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{off} {route}")


def test_seeded_draws_ties_only_on_real_weights():
    Bd, Kd = 96, 300
    w = np.random.default_rng(4).dirichlet(np.full(Kd, 0.3), size=Bd).astype(np.float32)
    prm = _params(5, Bd)
    u = trng.row_uniforms(trng.fold(trng.seed_from_key(SEED), trng.TAG_U), 77, Bd)
    want = np.asarray(jops.butterfly_sample_rng(_j(w), _j(SEED), row_offset=77, W=16))
    got = ops.butterfly_sample_rng(_t(w), SEED, row_offset=77, W=16)
    res = boundary_ties(got, want, w, u)
    assert res["faults"] == 0 and res["ties"] <= 2, res
    want = np.asarray(jops.butterfly_sample_truncated_rng(_j(w), _j(SEED), _j(prm),
                                                          row_offset=77, W=16))
    got = ops.butterfly_sample_truncated_rng(_t(w), SEED, _t(prm), row_offset=77, W=16)
    res = trunc_boundary_ties(got, want, _t(w), u, _t(prm))
    assert res["faults"] == 0 and res["ties"] <= 2, res


def test_row_offset_gives_shard_equivalence():
    """Four shards drawn with row_offset = first row + s * B/4 equal the
    whole batch, across the 2**32 wrap; a 0-dim tensor offset and bf16
    weights are taken."""
    Bw, Kw = 32, 300
    w = _t(_int_weights(11, Bw, Kw))
    prm = _t(_params(12, Bw))
    r0 = 2**32 - 12
    n = Bw // 4
    whole = ops.butterfly_sample_rng(w, SEED, row_offset=r0, W=16)
    shards = [ops.butterfly_sample_rng(w[s * n:(s + 1) * n], SEED,
                                       row_offset=torch.tensor(r0 + s * n), W=16)
              for s in range(4)]
    assert torch.equal(torch.cat(shards), whole)
    whole = ops.butterfly_sample_truncated_rng(w, SEED, prm, row_offset=r0, W=16)
    shards = [ops.butterfly_sample_truncated_rng(w[s * n:(s + 1) * n], SEED,
                                                 prm[s * n:(s + 1) * n],
                                                 row_offset=(r0 + s * n) % 2**32, W=16)
              for s in range(4)]
    assert torch.equal(torch.cat(shards), whole)
    wb = (w % 256).to(torch.bfloat16)      # integers below 256 are exact in bf16
    want = np.asarray(jops.butterfly_sample_rng(_j(wb.float().numpy()).astype(jnp.bfloat16),
                                                _j(SEED), row_offset=5, W=16))
    np.testing.assert_array_equal(ops.butterfly_sample_rng(wb, SEED, row_offset=5, W=16).numpy(),
                                  want)


def test_hw_rng_stream_and_route_check(monkeypatch):
    """hw=True: a fixed seed gives fixed draws, another stream than
    Threefry (the Philox plain version), and a ValueError naming hw_rng
    wherever the two-pass route would be taken."""
    w = _t(_int_weights(13, 64, 300))
    a = ops.butterfly_sample_rng(w, SEED, row_offset=3, W=16, hw=True)
    assert torch.equal(a, ops.butterfly_sample_rng(w, SEED, row_offset=3, W=16, hw=True))
    assert not torch.equal(a, ops.butterfly_sample_rng(w, SEED, row_offset=3, W=16))
    seed2 = trng.fold(trng.seed_from_key(SEED), trng.TAG_U)
    want = KB.fused_draw_torch(w, trng.philox_row_uniforms(seed2, 3, 64), 16)
    assert torch.equal(a, want)
    with pytest.raises(ValueError, match="hw_rng"):
        ops.butterfly_sample_rng(w, SEED, W=16, hw=True, route="two_pass")
    monkeypatch.setattr(KB, "_FUSED_SMEM_BYTES", 256)
    assert not KB.fused_fits(KB.num_blocks(300, 16), 16)
    with pytest.raises(ValueError, match="hw_rng"):
        ops.butterfly_sample_rng(w, SEED, W=16, hw=True)
    # the default stream takes the two-pass route there, with equal draws
    np.testing.assert_array_equal(
        ops.butterfly_sample_rng(w, SEED, W=16).numpy(),
        np.asarray(jops.butterfly_sample_rng(_j(w.numpy()), _j(SEED), W=16)))


# ---------------------------------------------------------------------------
# The reference's single-device draws for the sharded cases (cached: the
# in-process and 4-rank tests compare with the same arrays)
# ---------------------------------------------------------------------------


def _sharded_inputs():
    """(weights, logits, params) of the sharded cases: integer weights,
    N(0, 2^2) logits, per-row params."""
    w = _int_weights(21, B, K)
    z = (2.0 * np.random.default_rng(22).standard_normal((B, K))).astype(np.float32)
    return w, z, _params(23, B)


def _chain(prm):
    return (sampling.TopK(_t(prm[:, 0])), sampling.TopP(_t(prm[:, 1])),
            sampling.MinP(_t(prm[:, 2])))


def _jcat(method, w):
    return jdist.Categorical(method=method, W=W, shape=tuple(w.shape),
                             state=jdist._build_state(method, w, W))


@functools.lru_cache(maxsize=None)
def _reference(path: str, method: str, S: int, row0: int = 0) -> np.ndarray:
    """The reference's per-shard body on the whole batch: ``sample`` and
    ``logits`` as its sample_sharded / sample_logits_sharded bodies,
    ``trunc`` as its sample_logits_truncated_sharded body."""
    w, z, prm = _sharded_inputs()
    seed = jrng.seed_from_key(_j(KEY))
    if path == "sample":
        if method == "kernel" and S == 1:
            return np.asarray(jops.butterfly_sample_rng(_j(w), seed, row_offset=row0, W=W))
        return np.asarray(jsh._local_draw(_jcat(method, _j(w)), seed, row0, S))
    if path == "logits":
        if method == "gumbel":
            d = jdist.Categorical(method="gumbel", W=W, shape=(B, K),
                                  state={"logw": _j(z).astype(jnp.float32)})
            return np.asarray(jsh._local_draw(d, seed, row0, S))
        wts = jdist.logits_to_weights(_j(z), 1.0)
        if method == "kernel" and S == 1:
            return np.asarray(jops.butterfly_sample_rng(wts, seed, row_offset=row0, W=W))
        return np.asarray(jsh._local_draw(_jcat(method, wts), seed, row0, S))
    wts = jdist.logits_to_weights(_j(z), jnp.ones((B,), jnp.float32))
    if method == "kernel" and S == 1:
        return np.asarray(jops.butterfly_sample_truncated_rng(wts, seed, _j(prm),
                                                              row_offset=row0, W=W))
    tau = jtr.thresholds_from_params(wts, _j(prm))
    wm = jnp.where(wts >= tau[:, None], wts, 0.0)
    return np.asarray(jsh._local_draw(_jcat(method, wm), seed, row0, S))


def _port_whole(path: str, method: str, S: int) -> torch.Tensor:
    """The port's per-shard body on the whole batch (row 0 first)."""
    w, z, prm = (_t(x) for x in _sharded_inputs())
    if path == "sample":
        return tsh._shard_sample(method, W, w, KEY, 0, S)
    if path == "logits":
        return tsh._shard_sample_logits(method, W, z, 1.0, KEY, 0, S)
    return tsh._shard_sample_truncated(method, W, z, torch.ones(B), prm, KEY, 0, S)


def _check_reference(path, method, S, got):
    """``got`` (whole-batch draws) against the reference: exact on integer
    weights, float64-checked ties only on weights from logits."""
    want = np.array(_reference(path, method, S))
    got = np.asarray(got)
    if path == "sample" or method == "gumbel":
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {method} S={S}")
        return
    _, z, prm = _sharded_inputs()
    wts = tdist.logits_to_weights(_t(z))
    seed2 = trng.fold(trng.seed_from_key(KEY), trng.TAG_U)
    u = (trng.row_uniforms(seed2, 0, B) if S == 1 else trng.multi_row_uniforms(seed2, 0, B, S))
    if path == "trunc":
        res = trunc_boundary_ties(_t(got), _t(want), wts, u, _t(prm))
    else:
        res = boundary_ties(_t(got), _t(want), wts, u)
    assert res["faults"] == 0, (path, method, S, res)


# ---------------------------------------------------------------------------
# Counting collectives
# ---------------------------------------------------------------------------


class _C10dOps(TorchDispatchMode):
    """Counts every op of a c10d namespace (process-group and functional
    collectives) that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "c10d" in func.namespace:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@contextmanager
def count_collectives():
    """Yields a dict that, after the block, holds the number of calls of
    each torch.distributed collective (wrapped) and of c10d ops
    (``"c10d_ops"``) made inside it."""
    counts = {name: 0 for name in COLLECTIVES}
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return counted

    for name in COLLECTIVES:
        setattr(dist, name, wrap(name))
    mode = _C10dOps()
    try:
        with mode:
            yield counts
    finally:
        for name in COLLECTIVES:
            setattr(dist, name, saved[name])
        counts["c10d_ops"] = len(mode.ops)


def run_ranks(worker, tmp_path, world=WORLD, timeout=240):
    """Run ``worker(rank, world, store_file, out_dir)`` in ``world``
    spawned processes forming one gloo group (a FileStore under
    ``tmp_path``, no TCP port); fail with any rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main, args=(worker, r, world, store, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    errs = [(tmp_path / f"rank{r}.err") for r in range(world)]
    msgs = [e.read_text() for e in errs if e.exists()]
    assert not msgs, "\n".join(msgs)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def _rank_main(worker, rank, world, store, out_dir):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        try:
            worker(rank, world, out_dir)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        sampling.reset_plans()
        dist.destroy_process_group()


def _local(x) -> np.ndarray:
    assert isinstance(x, DTensor)
    return x.to_local().numpy()


class TestShardedPlan:
    def test_plan_memo_distinguishes_topology(self, mesh1):
        sampling.reset_plans()
        p_flat = sampling.plan((32, 64), method="two_level", W=8)
        p_mesh = sampling.plan((32, 64), method="two_level", W=8, mesh=mesh1)
        assert p_mesh is not p_flat
        assert p_mesh.mesh is not None and p_flat.mesh is None
        before = sampling.plan_stats()["plan_misses"]
        again = sampling.plan((32, 64), method="two_level", W=8, mesh=mesh1)
        assert again is p_mesh and sampling.plan_stats()["plan_misses"] == before
        p_dev = sampling.plan((32, 64), method="two_level", W=8, devices=4)
        assert p_dev is not p_flat and p_dev.devices == 4
        p_spec = sampling.plan((32, 64), method="two_level", W=8, mesh=mesh1, spec=("data",))
        assert p_spec is not p_mesh

    @pytest.mark.parametrize("method", METHODS)
    def test_singledev_mesh_draw_matches_counter_semantics(self, mesh1, method):
        """Each method's sharded draw (sample, build + draw, S = 1 and 3)
        equals the reference's per-shard draw at row 0; the u-driven ones
        also equal the flat distribution drawn on the counter uniforms."""
        w, _, _ = _sharded_inputs()
        p = sampling.plan((B, K), method=method, W=W, mesh=mesh1)
        with count_collectives() as counts:
            out = p.sample(_t(w), key=KEY)
            built = p.draw(p.build(_t(w)), key=KEY)
            out3 = p.sample(_t(w), key=KEY, num_samples=3)
        assert sum(counts.values()) == 0, counts
        assert out.shape == (B,) and out3.shape == (3, B)
        np.testing.assert_array_equal(_local(out), _local(built))
        for S, got in ((1, out), (3, out3)):
            _check_reference("sample", method, S, _local(got))
        if method in tdist.U_VARIANTS:
            u = trng.row_uniforms(trng.fold(trng.seed_from_key(KEY), trng.TAG_U), 0, B)
            flat = sampling.Categorical.from_weights(_t(w), method=method, W=W)
            np.testing.assert_array_equal(_local(out), flat.draw(u=u).numpy())

    @pytest.mark.parametrize("method", TRUNC_METHODS)
    def test_sharded_logits_match_reference(self, mesh1, method):
        """sample_logits with and without the per-row top-k/top-p/min-p
        chain, S = 1 and 3, against the reference's per-shard bodies."""
        _, z, prm = _sharded_inputs()
        p = sampling.plan((B, K), method=method, W=W, mesh=mesh1)
        for S in (1, 3):
            with count_collectives() as counts:
                plain = p.sample_logits(_t(z), key=KEY, num_samples=S)
                trunc = p.sample_logits(_t(z), key=KEY, num_samples=S, transforms=_chain(prm))
            assert sum(counts.values()) == 0, counts
            _check_reference("logits", method, S, _local(plain))
            _check_reference("trunc", method, S, _local(trunc))

    def test_sharded_draw_rejects_shape_mismatch(self, mesh1):
        p = sampling.plan((16, 32), method="two_level", W=8, mesh=mesh1)
        other = sampling.Categorical.from_weights(torch.ones(8, 32), method="two_level", W=8)
        with pytest.raises(ValueError, match="overlap"):
            p.draw(other, key=0)
        with pytest.raises(ValueError, match="shape"):
            p.sample(torch.ones(8, 32), key=0)

    def test_sharded_draw_rejects_factored_dist(self, mesh1):
        g = np.random.default_rng(14)
        C, N, V, Kf = 2, 8, 10, 32
        theta = _t(g.uniform(0.5, 1.5, (C, Kf)).astype(np.float32))
        phi = _t(g.uniform(0.5, 1.5, (V, Kf)).astype(np.float32))
        words = _t(g.integers(0, V, C * N).astype(np.int32))
        d = sampling.Categorical.from_factors(theta, phi, words,
                                              torch.arange(C * N, dtype=torch.int32) // N, W=8)
        p = sampling.plan((C * N, Kf), method="two_level", W=8, mesh=mesh1)
        with pytest.raises(ValueError, match="per shard"):
            p.draw(d, key=0)

    def test_sharded_factored_sample_raises_at_boundary(self, mesh1):
        p = sampling.plan((16, 32), method="lda_kernel", W=8, factored=True, mesh=mesh1)
        with pytest.raises(ValueError, match="build_from_factors"):
            p.sample(torch.ones(16, 32), key=0)
        with pytest.raises(ValueError, match="per shard"):
            p.build_from_factors(torch.ones(2, 32), torch.ones(4, 32),
                                 torch.zeros(16, dtype=torch.int32))

    def test_gumbel_sharded_logits_stay_in_logit_space(self, mesh1):
        """A token far below the row max keeps a finite log-weight (no exp
        round trip), so the row max is drawn every time."""
        logits = torch.zeros(8, 16)
        logits[:, 1:] -= 200.0
        p = sampling.plan((8, 16), method="gumbel", mesh=mesh1)
        a = _local(p.sample_logits(logits, key=17, temperature=1.0))
        np.testing.assert_array_equal(a, _local(p.sample_logits(logits, key=17)))
        np.testing.assert_array_equal(a, np.zeros(8, np.int32))

    def test_spec_override_controls_row_axes(self, mesh1):
        with pytest.raises(ValueError, match="not on the mesh"):
            sampling.plan((8, 16), method="two_level", W=8, mesh=mesh1, spec=("nope",))
        with pytest.raises(ValueError, match="axis 0"):
            sampling.plan((8, 16), method="two_level", W=8, mesh=mesh1, spec=(None, "data"))
        with pytest.raises(ValueError, match="only has meaning with mesh"):
            sampling.plan((8, 16), method="two_level", W=8, spec=("data",))
        with pytest.raises(TypeError, match="DeviceMesh"):
            sampling.plan((8, 16), method="two_level", W=8, mesh=object())
        w = _t(np.random.default_rng(15).uniform(0.1, 1.0, (8, 16)).astype(np.float32))
        p_default = sampling.plan((8, 16), method="two_level", W=8, mesh=mesh1)
        p_spec = sampling.plan((8, 16), method="two_level", W=8, mesh=mesh1, spec=("data",))
        np.testing.assert_array_equal(_local(p_default.sample(w, key=5)),
                                      _local(p_spec.sample(w, key=5)))

    def test_sharded_draw_rejects_u(self, mesh1):
        p = sampling.plan((8, 16), method="two_level", W=8, mesh=mesh1)
        w = torch.ones(8, 16)
        with pytest.raises(ValueError, match="counter RNG"):
            p.sample(w, u=torch.full((8,), 0.5))
        with pytest.raises(ValueError, match="counter RNG"):
            p.sample_logits(w, torch.Generator())
        with pytest.raises(ValueError, match="key="):
            p.draw(p.build(w))
        with pytest.raises(ValueError, match="key="):
            sampling.plan((8, 16), method="two_level", W=8).sample(w, key=3)

    def test_sample_logits_sharded_deterministic(self, mesh1):
        g = np.random.default_rng(12)
        logits = _t(g.normal(size=(16, 64)).astype(np.float32))
        p = sampling.plan((16, 64), method="two_level", W=8, mesh=mesh1)
        a = _local(p.sample_logits(logits, key=21, temperature=0.7))
        np.testing.assert_array_equal(a, _local(p.sample_logits(logits, key=21,
                                                                temperature=0.7)))
        assert p.sample_logits(logits, key=21, temperature=0.7, num_samples=3).shape == (3, 16)
        greedy = p.sample_logits(logits, key=21, temperature=0.0)
        np.testing.assert_array_equal(greedy.numpy(), np.argmax(logits.numpy(), -1))
        # a DTensor in, the same draws out
        np.testing.assert_array_equal(
            _local(p.sample_logits(tsh.place_rows(p.mesh, logits), key=21, temperature=0.7)), a)


# ---------------------------------------------------------------------------
# Four ranks: one spawned gloo group for every case
# ---------------------------------------------------------------------------


def _draw_cases(mesh, spec):
    """Every sharded draw path on ``mesh``: (case -> (linear index, local
    draws, collectives counted around the call))."""
    w, z, prm = (_t(x) for x in _sharded_inputs())
    index = tsh._linear_index(mesh, spec)
    out = {}

    def run(case, fn):
        with count_collectives() as counts:
            res = fn()
        out[case] = (index, res.to_local().numpy(), counts)

    for method in METHODS:
        p = sampling.plan((B, K), method=method, W=W, mesh=mesh, spec=spec)
        for S in (1, 3):
            run(("sample", method, S), lambda: p.sample(w, key=KEY, num_samples=S))
        dist_ = p.build(w)
        run(("draw", method, 1), lambda: p.draw(dist_, key=KEY))
    for method in TRUNC_METHODS:
        p = sampling.plan((B, K), method=method, W=W, mesh=mesh, spec=spec)
        for S in (1, 3):
            run(("logits", method, S), lambda: p.sample_logits(z, key=KEY, num_samples=S))
            run(("trunc", method, S), lambda: p.sample_logits(
                z, key=KEY, num_samples=S, transforms=_chain(prm.numpy())))
    return out


def _draw_worker(rank, world, out_dir):
    meshes = {
        "data4": (init_device_mesh("cpu", (world,), mesh_dim_names=("data",)), None),
        "pod2x2": (init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data")), None),
        "pod2x2_spec": (init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data")),
                        ("pod",)),
    }
    res = {name: _draw_cases(mesh, spec) for name, (mesh, spec) in meshes.items()}
    # a DTensor placed by place_rows (a scatter, outside the counted call)
    mesh = meshes["data4"][0]
    w = tsh.place_rows(mesh, _t(_sharded_inputs()[0]))
    p = sampling.plan((B, K), method="kernel", W=W, mesh=mesh)
    with count_collectives() as counts:
        got = p.sample(w, key=KEY)
    res["dtensor_in"] = {("sample", "kernel", 1): (tsh._linear_index(mesh), got.to_local().numpy(),
                                                    counts)}
    torch.save(res, os.path.join(out_dir, f"draws{rank}.pt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4-rank results: {rank: {mesh: {case: (index, local, counts)}}}."""
    d = tmp_path_factory.mktemp("gloo4")
    run_ranks(_draw_worker, d)
    return {r: torch.load(d / f"draws{r}.pt", weights_only=False) for r in range(WORLD)}


def _assemble(results, mesh_name, case):
    """The global draws of one case from every rank's shard; ranks that
    hold the same shard (replicas) must agree."""
    shards = {}
    for r in range(WORLD):
        index, local, counts = results[r][mesh_name][case]
        assert sum(counts.values()) == 0, (mesh_name, case, r, counts)
        if index in shards:
            np.testing.assert_array_equal(shards[index], local)
        shards[index] = local
    return np.concatenate([shards[i] for i in sorted(shards)], axis=-1)


@pytest.mark.parametrize("mesh_name,shards", [("data4", 4), ("pod2x2", 4), ("pod2x2_spec", 2),
                                              ("dtensor_in", 4)])
def test_four_ranks_equal_single_device_draws(four_ranks, mesh_name, shards):
    """Every path, every method, S = 1 and 3, with and without the chain:
    no collective on any rank, and the assembled draws equal the port's
    whole-batch draw bit for bit and the reference's single-device draw
    (exactly on integer weights, ties only on weights from logits)."""
    cases = four_ranks[0][mesh_name]
    assert len({four_ranks[r][mesh_name][c][0] for r in range(WORLD)
                for c in cases}) == shards
    for case in cases:
        path, method, S = case
        got = _assemble(four_ranks, mesh_name, case)
        whole = _port_whole("sample" if path == "draw" else path, method, S).numpy()
        np.testing.assert_array_equal(got, whole, err_msg=f"{mesh_name} {case}")
        _check_reference("sample" if path == "draw" else path, method, S, got)
