"""The port's distributed LDA sweep (``repro_torch.lda.distributed``)
against the reference, on the same numpy corpus.

The reference's ``make_sharded_gibbs`` runs under ``shard_map``, which the
installed jax refuses (ROADMAP queue 3), so the sweep is held against its
parts: the first sweep's z equals the reference's
``lda_draw_factored_rng`` over the whole batch with the sweep's seed (the
draw is device-count invariant), and the all-reduced word-topic counts
equal the reference's ``repro.lda.gibbs._counts`` over all documents.  The
4-rank cases run in one spawned gloo group on a 2 x 2 ("data", "model")
mesh, with every collective counted around each sweep.

Tolerance: theta and phi are Dirichlet draws, so z may differ from the
reference only at float64-checked boundary ties
(``lda_draw.ref.boundary_ties``); counts are integers and must be equal;
phi must be equal bit for bit on every rank."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.kernels.lda_draw import lda_draw_factored_rng as j_draw_rng
from repro.lda.gibbs import _counts as j_counts
from repro_torch import autotune
from repro_torch.kernels import rng as trng
from repro_torch.kernels.lda_draw.ref import boundary_ties
from repro_torch.lda import corpus as tcorpus
from repro_torch.lda import gibbs
from repro_torch.lda.distributed import make_sharded_gibbs
from test_torch_sharded import count_collectives, run_ranks

K, W, SEED, SWEEPS = 4, 8, 3, 8


@pytest.fixture
def port_autotune(tmp_path, monkeypatch):
    """The port's tuner on a throwaway cache file."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.reset()
    yield
    autotune.reset()


def _corpus():
    return tcorpus.synthesize_corpus(seed=0, M=16, V=40, K=K, avg_len=12, max_len=24)


def _state(corpus):
    return gibbs.init_state(SEED, corpus, K, device="cpu")


def _z_seed() -> np.ndarray:
    seed = trng.seed_from_key([0, SEED])      # init_state(SEED) seeds its generator with SEED
    return trng.fold(seed, trng.TAG_LDA_Z, 0).numpy().astype(np.uint32)


def _lda_worker(rank, world, out_dir):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    corpus = _corpus()
    state = _state(corpus)
    place, step = make_sharded_gibbs(mesh, K, corpus.vocab_size, method="lda_kernel", W=W)
    st, docs, mask = place(state, corpus.docs, corpus.mask)
    sweeps = []
    for _ in range(SWEEPS):
        reduced = []
        orig = dist.all_reduce

        def capture(t, *args, **kwargs):
            out = orig(t, *args, **kwargs)
            reduced.append(t.clone())
            return out

        dist.all_reduce = capture
        try:
            with count_collectives() as counts:
                st = step(st, docs, mask)
        finally:
            dist.all_reduce = orig
        full = gibbs.LDAState(theta=st.theta.full_tensor(), phi=st.phi.to_local(),
                              z=st.z.full_tensor(), key=st.key, step=st.step)
        sweeps.append({"counts": counts, "word_topic": reduced[0].numpy(),
                       "z_local": st.z.to_local().numpy(),
                       "theta_local": st.theta.to_local().numpy(),
                       "phi": st.phi.to_local().numpy(), "z": full.z.numpy(),
                       "perplexity": gibbs.perplexity(full, corpus)})
    # another u-driven method: the plan's distribution per shard
    _, step2 = make_sharded_gibbs(mesh, K, corpus.vocab_size, method="two_level", W=W)
    st2 = place(state, corpus.docs, corpus.mask)[0]
    with count_collectives() as counts:
        st2 = step2(st2, corpus.docs, corpus.mask)
    torch.save({"sweeps": sweeps, "two_level": (counts, st2.z.full_tensor().numpy()),
                "index": mesh.get_local_rank("data")}, os.path.join(out_dir, f"lda{rank}.pt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("lda4")
    run_ranks(_lda_worker, d)
    return [torch.load(d / f"lda{r}.pt", weights_only=False) for r in range(4)]


def test_phi_replicated_theta_z_row_sharded(four_ranks):
    corpus = _corpus()
    M, N = corpus.docs.shape
    for s in range(SWEEPS):
        phis = [r["sweeps"][s]["phi"] for r in four_ranks]
        for p in phis[1:]:
            np.testing.assert_array_equal(p, phis[0])
        assert phis[0].shape == (corpus.vocab_size, K)
        np.testing.assert_allclose(phis[0].sum(axis=0), 1.0, rtol=1e-5)
        shards = {}
        for r in four_ranks:
            sw = r["sweeps"][s]
            assert sw["z_local"].shape == (M // 2, N) and sw["theta_local"].shape == (M // 2, K)
            first = shards.setdefault(r["index"], sw)   # the replica along "model" agrees
            np.testing.assert_array_equal(sw["theta_local"], first["theta_local"])
            np.testing.assert_array_equal(sw["z_local"], first["z_local"])
        assert sorted(shards) == [0, 1]
        np.testing.assert_array_equal(
            np.concatenate([shards[0]["z_local"], shards[1]["z_local"]]), shards[0]["z"])


def test_one_all_reduce_per_sweep(four_ranks):
    for r in four_ranks:
        for sw in r["sweeps"]:
            c = sw["counts"]
            assert c["all_reduce"] == 1 and c["c10d_ops"] == 1, c
            assert sum(c.values()) == 2, c          # that one all_reduce, seen twice
        c = r["two_level"][0]
        assert c["all_reduce"] == 1 and sum(c.values()) == 2, c


def test_first_sweep_matches_reference(four_ranks):
    """The first sweep's z equals the reference's counter-RNG factored draw
    over the whole batch with the sweep's seed, and the all-reduced
    word-topic counts equal the reference's counts over all documents."""
    corpus = _corpus()
    st0 = _state(corpus)
    M, N = corpus.docs.shape
    doc_ids = np.arange(M * N, dtype=np.int32) // N
    words = corpus.docs.reshape(-1).astype(np.int32)
    want = np.array(j_draw_rng(jnp.asarray(st0.theta.numpy()), jnp.asarray(st0.phi.numpy()),
                                 jnp.asarray(doc_ids), jnp.asarray(words),
                                 jnp.asarray(_z_seed()), row_offset=0, W=W))
    u = trng.row_uniforms(trng.fold(torch.as_tensor(_z_seed().astype(np.int64)), trng.TAG_U),
                          0, M * N)
    for r in four_ranks:
        z = r["sweeps"][0]["z"]
        res = boundary_ties(torch.as_tensor(z.reshape(-1)), torch.as_tensor(want), st0.theta,
                            st0.phi, torch.as_tensor(doc_ids), torch.as_tensor(words), u)
        assert res["faults"] == 0, res
        for sw in r["sweeps"]:
            _, wt = j_counts(jnp.asarray(sw["z"]), jnp.asarray(corpus.docs),
                             jnp.asarray(corpus.mask), K, corpus.vocab_size)
            np.testing.assert_array_equal(sw["word_topic"], np.asarray(wt))
        # the two_level sweep draws the same topics from the same counters
        np.testing.assert_array_equal(r["two_level"][1], z)


def test_perplexity_decreases(four_ranks):
    ppl = [sw["perplexity"] for sw in four_ranks[0]["sweeps"]]
    assert all(np.isfinite(ppl)) and ppl[-1] < ppl[0], ppl
    for r in four_ranks[1:]:
        assert [sw["perplexity"] for sw in r["sweeps"]] == ppl


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("lda1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_later_slices_raise_and_inputs(mesh1, port_autotune):
    """``sparse=True`` runs (slice 10: the MH-alias z-draw, one sweep
    returning the same sharded state); a key-driven method is refused; the
    default ``method="auto"`` resolves for the per-shard workload and
    sweeps as the method it resolved to; plain tensors holding the whole
    arrays give the sweep that placed DTensors give."""
    corpus = _corpus()
    for kw in ({"method": "lda_kernel"}, {}):
        place, step = make_sharded_gibbs(mesh1, K, corpus.vocab_size, sparse=True, **kw)
        out = step(*place(_state(corpus), corpus.docs, corpus.mask))
        assert out.step == 1 and out.z.to_local().shape == tuple(corpus.docs.shape)
        assert 0 <= int(out.z.to_local().min()) and int(out.z.to_local().max()) < K
    with pytest.raises(ValueError, match="counter uniforms"):
        make_sharded_gibbs(mesh1, K, 40, method="gumbel")
    M, N = corpus.docs.shape
    res = autotune.get_tuner().resolve_full(M * N, K, has_key=False, factored=True,
                                            backend="cpu")
    sweeps = []
    for kw in ({}, {"method": res.method, "W": res.W}):
        place, step = make_sharded_gibbs(mesh1, K, corpus.vocab_size, **kw)
        sweeps.append(step(*place(_state(corpus), corpus.docs, corpus.mask)))
    assert torch.equal(sweeps[0].z.to_local(), sweeps[1].z.to_local())
    assert torch.equal(sweeps[0].phi.to_local(), sweeps[1].phi.to_local())
    place, step = make_sharded_gibbs(mesh1, K, corpus.vocab_size, method="lda_kernel", W=W)
    a = step(_state(corpus), torch.as_tensor(corpus.docs), torch.as_tensor(corpus.mask))
    b = step(*place(_state(corpus), corpus.docs, corpus.mask))
    for x, y in ((a.z, b.z), (a.theta, b.theta), (a.phi, b.phi)):
        assert torch.equal(x.to_local(), y.to_local())
    assert a.step == 1


# ---------------------------------------------------------------------------
# The sparse sweep (make_sharded_gibbs(sparse=True)) on 1 and 2 ranks
# ---------------------------------------------------------------------------

SPARSE_K, SPARSE_CAP, SPARSE_STEPS = 6, 4, 2


def _sparse_run(mesh):
    """3 sparse sweeps: per sweep the incoming state (whole arrays), the
    new z and the collectives counted around the step."""
    corpus = _corpus()
    place, step = make_sharded_gibbs(mesh, SPARSE_K, corpus.vocab_size, sparse=True,
                                     cap=SPARSE_CAP, mh_steps=SPARSE_STEPS)
    st, docs, mask = place(gibbs.init_state(SEED, corpus, SPARSE_K, device="cpu"),
                           corpus.docs, corpus.mask)
    out = []
    for _ in range(3):
        incoming = {"theta": st.theta.full_tensor().numpy(),
                    "phi": st.phi.to_local().numpy(), "z": st.z.full_tensor().numpy(),
                    "step": st.step}
        with count_collectives() as counts:
            st = step(st, docs, mask)
        out.append({"in": incoming, "z": st.z.full_tensor().numpy(), "counts": counts})
    return out


def _sparse_worker(rank, world, out_dir):
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    torch.save(_sparse_run(mesh), os.path.join(out_dir, f"sparse{rank}.pt"))


def _single_device_draw(incoming):
    """The single-device sparse z-draw from a sweep's incoming state at the
    same seed (the generator's) and cap, cdf tables."""
    from repro_torch.lda import sparse as ts

    corpus = _corpus()
    state = gibbs.LDAState(theta=torch.as_tensor(incoming["theta"]),
                           phi=torch.as_tensor(incoming["phi"]),
                           z=torch.as_tensor(incoming["z"]),
                           key=torch.Generator().manual_seed(SEED), step=incoming["step"])
    return ts.draw_z_sparse(state, corpus.docs, corpus.mask, mh_steps=SPARSE_STEPS,
                            word_proposal="cdf",
                            cache=ts.SparseSweepCache(cap_min=SPARSE_CAP,
                                                      cap_max=SPARSE_CAP)).numpy()


def test_sparse_sweep_one_rank_equals_single_device(mesh1):
    """On one gloo rank every sweep's z equals the single-device sparse
    draw from its incoming state, the first equals ``gibbs_step_sparse``'s,
    and each sweep makes exactly one all_reduce."""
    from repro_torch.lda import sparse as ts

    run = _sparse_run(mesh1)
    for sw in run:
        np.testing.assert_array_equal(sw["z"], _single_device_draw(sw["in"]))
        c = sw["counts"]
        assert c["all_reduce"] == 1 and sum(c.values()) == 2, c
    corpus = _corpus()
    first = ts.gibbs_step_sparse(gibbs.init_state(SEED, corpus, SPARSE_K, device="cpu"),
                                 corpus, mh_steps=SPARSE_STEPS,
                                 cache=ts.SparseSweepCache(cap_min=SPARSE_CAP,
                                                           cap_max=SPARSE_CAP))
    np.testing.assert_array_equal(run[0]["z"], first.z.numpy())


def test_sparse_sweep_two_ranks_equals_single_device(tmp_path):
    """Two gloo ranks, each drawing its own documents with global offsets:
    every sweep's z equals the single-device sparse draw from its incoming
    state, on both ranks, with one all_reduce a sweep."""
    run_ranks(_sparse_worker, tmp_path, world=2)
    runs = [torch.load(tmp_path / f"sparse{r}.pt", weights_only=False) for r in range(2)]
    for sw0, sw1 in zip(*runs):
        np.testing.assert_array_equal(sw0["z"], sw1["z"])
        np.testing.assert_array_equal(sw0["z"], _single_device_draw(sw0["in"]))
        for sw in (sw0, sw1):
            c = sw["counts"]
            assert c["all_reduce"] == 1 and sum(c.values()) == 2, c
