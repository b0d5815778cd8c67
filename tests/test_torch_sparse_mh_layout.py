"""S1's "doc" layout as an exact-order CPU model
(``sparse_mh.ref.mh_sweep_doc_order_torch``) against the plain version
``mh_sweep_torch`` and the reference's XLA ``repro.lda.sparse._mh_sweep``,
on the same numpy inputs run through ``sparse_counts``.

The model makes the kernel's choices token by token: each document's list
as a topic -> count map, the doc-sparse position by an upper-bound binary
search over the float32 prefix ``cc``, and one document a block with its
live positions in order on lanes.  None of these changes a float
operation, so the tolerance is none: z, the word and doc accepts and the
proposal count must be equal.  The cases: every word-proposal mode,
steps 1 and 4, cap 1, 8, 64 and cap = K, supports below cap (zero-count
tails), ``x`` exactly equal to a ``cc`` value, ``t`` exactly at K alpha,
documents fully masked, L not a multiple of 32 and longer than a block,
and row counters that wrap at 2**32.  Also the layout rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rng as jrng
from repro.lda import sparse as js
from repro_torch.kernels import rng as trng
from repro_torch.kernels.sparse_mh import kernel as KS
from repro_torch.kernels.sparse_mh import ref

THREADS = KS.DOC_THREADS


def _inputs(seed, M, L, K, V, cap, dead_docs=(), doc_topic=None):
    """numpy (z, docs, mask, theta, phi) with ragged documents, and the
    reference's sparse counts of z (or of ``doc_topic``) at ``cap``."""
    g = np.random.default_rng(seed)
    theta = g.dirichlet(np.full(K, 0.3), size=M).astype(np.float32)
    phi = np.ascontiguousarray(g.dirichlet(np.full(V, 0.3), size=K).T).astype(np.float32)
    docs = g.integers(0, V, size=(M, L)).astype(np.int32)
    mask = np.arange(L)[None] < g.integers(1, L + 1, size=M)[:, None]
    mask[list(dead_docs)] = False
    z = g.integers(0, K, size=(M, L)).astype(np.int32)
    if doc_topic is None:
        doc_topic, _ = js._counts_scatter(jnp.asarray(z), jnp.asarray(docs),
                                          jnp.asarray(mask), K, V)
    sp = js.sparse_counts(jnp.asarray(doc_topic, jnp.float32), cap)
    return [z, docs, mask, theta, phi, np.array(sp.ids), np.array(sp.cnt)]


def _tables(phi, mode):
    if mode == "cdf":
        return js._phi_cdf(jnp.asarray(phi)), jnp.zeros((1, 1), jnp.int32)
    return js.word_proposal_tables(jnp.asarray(phi), mode)


def _seed(a, b):
    return jrng.fold(jnp.asarray([a, b], jnp.uint32), jrng.TAG_SPARSE_MH)


def _three_way(inp, mode, steps, row0, alpha=0.1, seed=(7, 1), ref_jax=True):
    """The model, the plain version and (``ref_jax``) the reference on one
    input: all equal.  Returns the model's results."""
    L, K = inp[1].shape[1], inp[3].shape[1]
    cap = inp[5].shape[1]
    ta, tb = _tables(inp[4], mode)
    sd = _seed(*seed)
    t = [torch.as_tensor(np.array(x)) for x in (*inp, ta, tb)]
    args = (*t, torch.as_tensor(np.array(sd)).long(), row0, alpha)
    got = ref.mh_sweep_doc_order_torch(*args, steps=steps, cap=cap, mode=mode,
                                       threads=THREADS)
    plain = ref.mh_sweep_torch(*args, steps=steps, cap=cap, mode=mode, chunk=24)
    assert torch.equal(got[0], plain[0])
    assert [int(x) for x in got[1:]] == [int(x) for x in plain[1:]]
    if ref_jax:
        zr, war, dar, pr = js._mh_sweep_jit(steps, cap, mode, 24)(
            *(jnp.asarray(x) for x in inp), ta, tb, sd, jnp.uint32(row0 & 0xFFFFFFFF),
            jnp.float32(alpha))
        assert np.array_equal(got[0].numpy(), np.asarray(zr))
        assert [int(x) for x in got[1:]] == [int(war), int(dar), int(pr)]
    z = torch.as_tensor(inp[0])
    dead = ~torch.as_tensor(inp[2])
    assert torch.equal(got[0][dead], z[dead])            # masked positions keep z
    return got


@pytest.mark.parametrize("cap", [1, 8, 64, 80])
@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("mode", ref.MODES)
def test_doc_order_model_equals_plain_and_reference(mode, steps, cap):
    """K = 80 (cap 80 = K), documents of at most 40 live tokens, so cap 64
    and 80 hold zero-count tails; L = 40 is not a multiple of 32; docs 3,
    9 and 24..47 are masked out."""
    dead = (3, 9, *range(24, 48))
    inp = _inputs(cap * 10 + steps, 96, 40, 80, 120, cap, dead_docs=dead)
    assert (inp[6][:, -1] == 0).any() or cap == 1           # supports below cap
    got = _three_way(inp, mode, steps, 11, seed=(steps, cap))
    assert 0 < int(got[1]) < int(got[3]) and 0 < int(got[2]) < int(got[3])


@pytest.mark.parametrize("mode", ref.MODES)
def test_long_documents_and_wrapping_counters(mode):
    """L = 150 (longer than a block of 128 threads, not a multiple of 32):
    a document takes two rounds of lanes; the row counters wrap at 2**32
    within the sweep, at 2 and at 4 steps."""
    inp = _inputs(5, 12, 150, 24, 60, 16)
    inp[2][:4] = True                                       # full documents
    doc, pos, lane, rnd = ref.doc_schedule(torch.as_tensor(inp[2]), THREADS)
    assert int(rnd.max()) == 1 and int(lane.max()) == THREADS - 1
    live = torch.nonzero(torch.as_tensor(inp[2]).reshape(-1))[:, 0]
    assert torch.equal(doc * 150 + pos, live)
    _three_way(inp, mode, 2, 2**32 - 5)
    _three_way(inp, mode, 4, 2**32 - 7, seed=(3, 8))


def test_t_exactly_at_k_alpha():
    """A token whose doc proposal lands exactly on K alpha (t == Ka): the
    smoothing branch is not taken (t < Ka), the doc-sparse branch searches
    x = 0.  Built from the token's own uniform: u3 = k / 2**24, alpha =
    k / K with K = 16, the document's retained mass 2**24 - k."""
    M, L, K, V, cap, row0 = 6, 8, 16, 30, 8, 3
    sd = _seed(4, 4)
    u3 = trng.uniform(torch.as_tensor(np.array(sd)).long(),
                      torch.tensor([row0 * L]), 3)
    k = int(u3.item() * 2**24)
    assert k > 0
    alpha = k / K
    dt = np.random.default_rng(0).integers(0, 5, size=(M, K)).astype(np.float32)
    dt[0] = 0
    dt[0, 5], dt[0, 9] = 2**24 - k - 1000, 1000
    inp = _inputs(1, M, L, K, V, cap, doc_topic=dt)
    inp[2][0, 0] = True
    cc0 = torch.cumsum(torch.as_tensor(inp[6][0]), 0).to(torch.float32)
    Ka = torch.tensor(float(K)) * torch.tensor(alpha, dtype=torch.float32)
    t = u3 * (Ka + cc0[-1])
    assert float(t) == float(Ka) and float(Ka + cc0[-1]) == 2.0**24
    _three_way(inp, "cdf", 1, row0, alpha=alpha, seed=(4, 4))


def test_x_exactly_on_a_cc_value():
    """Tokens whose doc-sparse offset x = t - K alpha equals cc[0]
    exactly: #{cc <= x} counts it (position 1), as the linear count does.
    Built per document from its first token with u3 >= 1/2: K alpha = 16,
    the retained mass 2**24 - 16, counts (x, mass - x)."""
    M, L, K, V, cap, row0 = 8, 8, 16, 30, 4, 1
    sd = _seed(9, 9)
    ctr = (row0 + torch.arange(M)[:, None]) * L + torch.arange(L)[None]
    u3 = trng.uniform(torch.as_tensor(np.array(sd)).long(), ctr, 3)
    S = 2**24 - 16
    dt = np.zeros((M, K), np.float32)
    first = []
    for d in range(M):
        i = int(torch.nonzero(u3[d] >= 0.5 + 2.0**-20)[0])
        first.append(i)
        x = int(u3[d, i].item() * 2**24) - 16
        dt[d, d % K], dt[d, (d + 3) % K] = x, S - x
    inp = _inputs(2, M, L, K, V, cap, doc_topic=dt)
    inp[2][np.arange(M), first] = True
    cc = torch.cumsum(torch.as_tensor(inp[6]), 1).to(torch.float32)
    Ka = torch.tensor(16.0)
    x = u3[torch.arange(M), first] * (Ka + cc[:, -1]) - Ka
    assert torch.equal(x, cc[:, 0])                         # x on a cc value
    assert torch.equal(ref.count_le(cc, x, cap), torch.ones(M, dtype=torch.int64))
    _three_way(inp, "cdf", 1, row0, alpha=1.0, seed=(9, 9))
    _three_way(inp, "alias", 1, row0, alpha=1.0, seed=(9, 9))


@pytest.mark.parametrize("cap", [1, 2, 3, 8, 37, 64, 70])
def test_count_le_equals_linear_count(cap):
    """The binary search counts #{cc <= x} on non-decreasing rows (zero
    tails included) for x on, between, below and above the values."""
    g = np.random.default_rng(cap)
    cnt = g.integers(0, 4, size=(50, cap))
    cnt[:, cap // 2:] = 0
    cnt[7] = 0
    cc = torch.as_tensor(np.cumsum(cnt, 1)).to(torch.float32)
    xs = torch.cat([cc, cc - 0.5, cc + 0.5, torch.full((50, 2), -1.0),
                    torch.full((50, 1), 1e9)], 1)
    want = (cc[:, None, :] <= xs[..., None]).sum(-1)
    got = ref.count_le(cc[:, None, :].expand(-1, xs.shape[1], -1).contiguous(), xs, cap)
    assert torch.equal(got, want)


def test_layout_rule():
    """The doc layout wherever one document's map, list and positions fit
    48 KB of shared memory (K + 2 cap + L <= 12,276), "position" above."""
    assert KS.mh_layout(240, 64, 107) == "doc"
    assert KS.mh_layout(2048, 64, 307) == "doc"
    assert KS.mh_layout(12276 - 128 - 107, 64, 107) == "doc"
    assert KS.mh_layout(12277 - 128 - 107, 64, 107) == "position"
    assert KS.mh_layout(16384, 64, 107) == "position"
    assert KS.fitting_layouts(240, 64, 107) == ("position", "doc")
    assert KS.fitting_layouts(16384, 64, 107) == ("position",)
    assert KS.fitting_layouts(240, 5000, 107) == ("doc",)
    assert KS.fitting_layouts(16384, 5000, 107) == ()
    assert KS.doc_bytes(240, 64, 107) == 4 * (240 + 128 + 107)
    assert KS.doc_bytes(2048, 64, 107) == 4 * (2048 + 128 + 107)
    with pytest.raises(ValueError):
        KS._mh_sweep(*([torch.zeros((2, 2))] * 9), [1, 2], 0, 0.1, steps=1, mode="cdf",
                     layout="lanes")

