"""The sparse sweep's counts and lists in one pass a document
(``repro_torch.kernels.sparse_counts``).

On the CPU: the exact-order model of the kernel
(``ref.sparse_counts_rank_order_torch``) against the plain version
(``ref.sparse_counts_torch``: index_add_ counts, a stable descending sort
and the largest support, what the sweep computed before the kernel), in
every output and every slot, on tie-heavy counts, documents with more and
with fewer nonzero topics than the width, all-masked documents, one
document, K = 12, 240 and 1,000; and the sweep's two routes (the fused
pass, taken on the card where a document fits, and ``_counts`` with the
sort) giving the same state and lists.

Marked ``cuda`` (skip here with their reason): the kernel against the
plain version on the card, bit for bit, at the sparse cell's shape
(43,556 x 110, K = 240, width 64) and at K = 1,000 on 3 seeds, on edge
shapes (shared memory above 48 KB among them), and one launch a sweep.
Every count is an integer, so every comparison is equality."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_counts import kernel as KC
from repro_torch.kernels.sparse_counts import ops, ref
from repro_torch.lda import corpus as tcorpus
from repro_torch.lda import gibbs as tg
from repro_torch.lda import sparse as ts

CPU = "cpu"
CASES = ("ties", "wide", "narrow", "masked", "one_doc")


def _inputs(seed, kind, K, M=24, L=40, V=30):
    """numpy (z, docs, mask) for one case (module note)."""
    g = np.random.default_rng(seed)
    if kind == "one_doc":
        M = 1
    docs = g.integers(0, V, size=(M, L)).astype(np.int32)
    mask = np.arange(L)[None] < g.integers(1, L + 1, size=M)[:, None]
    if kind == "ties":
        # each document cycles through a few topics: counts tie by blocks
        tops = g.integers(0, K, size=(M, 4))
        slot = (np.arange(L)[None] // g.integers(1, 4, size=(M, 1))) % 4
        z = np.take_along_axis(tops, slot, axis=1)
    elif kind == "narrow":
        z = g.integers(0, min(K, 3), size=(M, L)) * (K // 3 or 1)
    else:
        z = g.integers(0, K, size=(M, L))
    if kind == "masked":
        mask[::3] = False
    if kind == "wide":
        mask[:] = True
    return (torch.as_tensor(z.astype(np.int32)), torch.as_tensor(docs),
            torch.as_tensor(mask))


def _widths(K):
    return sorted({1, min(8, K), min(64, K), K})


@pytest.mark.parametrize("K", [12, 240, 1000])
@pytest.mark.parametrize("kind", CASES)
def test_rank_order_model_equals_plain_in_every_slot(kind, K):
    z, docs, mask = _inputs(K + CASES.index(kind), kind, K)
    V = 30
    for width in _widths(K):
        want = ref.sparse_counts_torch(z, docs, mask, K, V, width)
        got = ref.sparse_counts_rank_order_torch(z, docs, mask, K, V, width)
        for name, a, b in zip(("doc_topic", "word_topic", "ids", "cnt", "nnz_max"),
                              got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (kind, K, width, name)
        assert torch.equal(want[0], tg._counts(z, docs, mask, K, V)[0])
        assert int(want[4]) == ts._nnz_max(want[0])


@pytest.mark.parametrize("K", [12, 240, 1000])
def test_cases_reach_what_they_name(K):
    """Each case covers its edge: ties, more and fewer nonzero topics than
    the width (the zero slots then hold the unused topics ascending), an
    all-masked document, one document."""
    width = min(8, K)
    nnz = {k: (ref.sparse_counts_torch(*_inputs(K + CASES.index(k), k, K), K, 30,
                                       width)[0] > 0).sum(1) for k in CASES}
    assert int(nnz["wide"].max()) > width and int(nnz["narrow"].max()) < width
    assert int(nnz["masked"].min()) == 0 and nnz["one_doc"].shape == (1,)
    z, docs, mask = _inputs(K + CASES.index("ties"), "ties", K)
    dt = ref.sparse_counts_torch(z, docs, mask, K, 30, K)[0]
    assert any(len(set(r[r > 0].tolist())) < int((r > 0).sum()) for r in dt)
    z, docs, mask = _inputs(K + CASES.index("narrow"), "narrow", K)
    dt, _, ids, cnt, _ = ref.sparse_counts_rank_order_torch(z, docs, mask, K, 30, width)
    for d in range(dt.shape[0]):
        n = int((dt[d] > 0).sum())
        unused = [k for k in range(K) if dt[d, k] == 0][: width - n]
        assert ids[d, n:].tolist() == unused and not cnt[d, n:].any()


def test_plain_version_skips_the_word_side_and_takes_any_mask_dtype():
    z, docs, mask = _inputs(3, "masked", 12)
    full = ops.sparse_counts(z, docs, mask, 12, 30, 8)
    part = ops.sparse_counts(z.long(), docs.long(), mask.to(torch.uint8), 12, 30, 8,
                             word=False)
    assert part[1] is None
    for a, b in zip(full[:1] + full[2:], part[:1] + part[2:]):
        assert torch.equal(a, b)
    empty = ops.sparse_counts(z[:0], docs[:0], mask[:0], 12, 30, 8)
    assert empty[2].shape == (0, 8) and int(empty[4]) == 0


def test_fits_by_shape():
    assert KC.fits(240, 110) and KC.fits(1000, 415) and KC.fits(50000, 110)
    assert not KC.fits(60000, 110) and not KC.fits(20000, 20000)
    assert KC.smem_bytes(240, 110) == 4 * (240 + 220)
    assert KC.smem_bytes(12, 415) == 4 * (12 + 24)


def _corpus():
    return tcorpus.synthesize_corpus(3, M=40, V=60, K=6, avg_len=12, max_len=20)


@pytest.mark.parametrize("K,cap_min,cap_max", [(12, 8, 4), (12, 8, 64), (40, 2, 64)])
def test_sweep_routes_give_the_same_state_and_lists(monkeypatch, K, cap_min, cap_max):
    """The fused route (forced here: ``kernels.sparse_counts`` then runs its
    plain version) and the route off the card or where a document does not
    fit (``_counts``, the sort and the largest support) give the same
    states, capacities and lists, the lists cut to the capacity (no copy at
    the full width)."""
    corpus = _corpus()

    def run():
        cache = ts.SparseSweepCache(cap_min=cap_min, cap_max=cap_max)
        s = tg.init_state(4, corpus, K, device=CPU)
        out = []
        for _ in range(3):
            s = tg.gibbs_step(s, corpus, sparse=True, sparse_cache=cache)
            out.append((s.theta, s.phi, s.z.clone(), cache.cap, cache.counts))
        return out

    monkeypatch.setattr(ts, "_fused_route", lambda z, K: True)
    fused = run()
    monkeypatch.setattr(ts, "_fused_route", lambda z, K: False)
    plain = run()
    for (a, b) in zip(fused, plain):
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
        assert a[3] == b[3] and all(torch.equal(x, y) for x, y in zip(a[4], b[4]))
        assert a[4].ids.is_contiguous() and a[4].ids.shape[1] == min(a[3], K)


def test_full_width_cut_is_no_copy():
    cache = ts.SparseSweepCache(cap_min=8, cap_max=8)
    z, docs, mask = _inputs(5, "wide", 12)
    dt, _, lists, nnz = ts._counts_and_lists(z, docs, mask, 12, 30, cache, word=False)
    ts._next_lists(cache, lists, nnz, 12)
    assert cache.cap == 8 and cache.counts.ids.data_ptr() == lists.ids.data_ptr()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sparse_counts kernel runs only on the card")
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _corpus_like(dev, seed, M, L, K, V):
    """Poisson-like lengths (mean 0.64 L), half the documents over few
    topics (ties), half over all K."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.clamp(torch.poisson(torch.full((M,), 0.64 * L, device=dev), generator=g),
                    0, L)
    mask = torch.arange(L, device=dev)[None] < n[:, None]
    z = torch.randint(0, K, (M, L), generator=g, device=dev, dtype=torch.int32)
    few = torch.randint(0, K, (M, 1), generator=g, device=dev, dtype=torch.int32) \
        + torch.randint(0, 6, (M, L), generator=g, device=dev, dtype=torch.int32)
    z = torch.where(torch.arange(M, device=dev)[:, None] % 2 == 0, z, few % K)
    docs = torch.randint(0, V, (M, L), generator=g, device=dev, dtype=torch.int32)
    return z, docs, mask


def _equal_on_card(z, docs, mask, K, V, width):
    for word in (True, False):
        got = KC.sparse_counts(z, docs, mask, K, V, width, word=word)
        want = ref.sparse_counts_torch(z, docs, mask, K, V, width, word=word)
        torch.cuda.synchronize()
        for name, a, b in zip(("doc_topic", "word_topic", "ids", "cnt", "nnz_max"),
                              got, want):
            if b is None:
                assert a is None
                continue
            assert a.dtype == b.dtype and torch.equal(a, b), (K, width, name)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000003701, 3000003702, 3000003703])
@pytest.mark.parametrize("K", [240, 1000])
def test_kernel_equals_plain_at_the_cells_shape(dev, K, seed):
    z, docs, mask = _corpus_like(dev, seed, 43556, 110, K, 37286)
    _equal_on_card(z, docs, mask, K, 37286, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,K,width", [
    (1, 40, 12, 1), (1, 40, 12, 12), (64, 415, 12, 12), (300, 96, 1000, 1000),
    (200, 110, 20000, 64), (50, 3, 240, 64), (128, 300, 1000, 64)])
def test_kernel_equals_plain_on_edge_shapes(dev, M, L, K, width):
    """One document; width 1 and K; documents wider than K; every topic
    listed; shared memory above 48 KB (K = 20,000); short documents."""
    z, docs, mask = _corpus_like(dev, M + L + K, M, L, K, 50)
    mask[::5] = False
    _equal_on_card(z, docs, mask, K, 50, width)


@pytest.mark.cuda
def test_fits_reads_the_cards_shared_memory(dev):
    """The route's limit is the card's opt-in shared memory a block; on an
    H100 it is the one assumed where no card is named."""
    optin = KC.smem_optin(torch.cuda.current_device())
    assert optin >= 48 * 1024
    if "H100" in torch.cuda.get_device_name(dev):
        assert optin == KC._SMEM_OPTIN
    K = (optin - KC._STATIC_SMEM) // 4 - 2 * 110
    assert KC.fits(K, 110, dev) and not KC.fits(K + 1, 110, dev)


@pytest.mark.cuda
def test_sparse_sweep_launches_the_kernel_once_a_sweep(dev):
    """One launch a sweep, and one for a fresh cache's counts; the lists
    S1 reads equal the sort's."""
    from repro_torch.kernels.sparse_mh import kernel as KS

    corpus = tcorpus.synthesize_corpus(seed=0, M=200, V=300, K=8, avg_len=40, max_len=80)
    state = tg.init_state(0, corpus, 64, device=dev)
    cache = ts.SparseSweepCache()
    KC.reset_launches()
    KS.reset_launches()
    docs, mask = (torch.as_tensor(x, device=dev) for x in (corpus.docs, corpus.mask))
    for i in range(3):
        state = tg.gibbs_step(state, corpus, sparse=True, sparse_cache=cache)
        torch.cuda.synchronize()
        assert KC.LAUNCHES["sparse_counts"] == i + 2 and KS.LAUNCHES["sparse_mh"] == i + 1
        dt, _ = tg._counts(state.z, docs, mask, 64, corpus.vocab_size)
        want = ts.sparse_counts(dt, min(cache.cap, 64))
        assert torch.equal(cache.counts.ids, want.ids)
        assert torch.equal(cache.counts.cnt, want.cnt)
    with pytest.raises(ValueError):
        KC.sparse_counts(state.z.cpu(), docs.cpu(), mask.cpu(), 64, 300, 8)
