"""Distributed LDA on ``torch.distributed``: documents shard over the
mesh's data axes and phi is replicated (AD-LDA, Newman et al.), the
counterpart of ``repro.lda.distributed``.

A sweep on each rank:

* **z-draw.**  The rank resolves the factored plan of its own (C_loc * N,
  K) workload (``method="auto"``, the default: the tuner's ``|devN``
  bucket for the per-shard shape) and draws its word positions from its
  theta rows and the replicated phi: ``lda_draw_factored_rng`` (K8 on
  the card) with global row counters, ``row_offset = linear index *
  C_loc * N``, so the draws are the same at any rank count and the draw
  issues no collective.  Another u-driven method builds the plan's
  distribution per rank and draws from the same counters.
* **Counts.**  Doc-topic counts stay local.  The word-topic counts are
  the one quantity AD-LDA synchronises: exactly one
  ``torch.distributed.all_reduce`` per sweep, over the data axes.
* **Resample.**  theta rows per rank; phi identically on every rank from
  a stream every rank derives alike and the all-reduced counts, so it
  stays replicated without a broadcast.

Randomness.  The port's state carries a ``torch.Generator``; the sweep
reads one replicated seed from it, the generator's ``initial_seed()`` as
two 32-bit words (so every rank builds its state from the same seed, e.g.
``gibbs.init_state(seed, ...)``), and derives with
:func:`repro_torch.kernels.rng.fold`, for the state's ``step``:

* the z-draw's (2,) seed: ``fold(seed, TAG_LDA_Z, step)`` (the draw folds
  ``TAG_U`` into it, as every seeded draw does);
* theta's stream: ``fold(fold(seed, TAG_LDA_THETA, step), shard)``, the
  shard being the rank's linear index along the data axes (ranks that
  hold the same documents draw the same theta);
* phi's stream: ``fold(seed, TAG_LDA_PHI, step)``.

A derived pair (s0, s1) seeds a ``torch.Generator`` with ``s0 << 32 |
s1``.  The reference splits the sweep's JAX key four ways instead.

``sparse=True`` replaces the z-draw with the MH-alias sweep
(``repro_torch.lda.sparse``): each rank builds its fixed-width sparse
doc-topic counts (``cap``) from its own incoming z, proposes through the
cdf word tables (one cumsum of the replicated phi), and walks
``mh_steps`` MH cycles (S1 on the card) with global document offsets,
``row0 = linear index * C_loc``, on the seed ``fold(fold(seed,
TAG_LDA_Z, step), TAG_SPARSE_MH)``: the single-device sparse sweep's
(``sparse.sweep_seed``), so the z-draw is the same at any rank count.
The draw issues no collective; the word-topic ``all_reduce`` stays the
sweep's only one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.kernels import rng as _rng
from repro_torch.kernels.lda_draw import lda_draw_factored_rng
from repro_torch.lda.gibbs import LDAState, _counts, _update_phi, _update_theta
from repro_torch import sampling
from repro_torch.sampling import distribution as _dist
from repro_torch.sampling import sharded as _sharded


def _data_group(mesh):
    """The process group of the mesh's data axes (the word-topic sum)."""
    axes = _sharded.data_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def make_sharded_gibbs(mesh, K: int, V: int, alpha: float = 0.1, beta: float = 0.05,
                       method: str = "auto", W: Optional[int] = None,
                       sparse: bool = False, cap: int = 32, mh_steps: int = 1):
    """``(place, step)`` over a ``DeviceMesh``: ``place(state, docs, mask)``
    shards an ``LDAState`` and the corpus arrays onto the mesh (theta, z,
    docs and mask by documents as DTensors, phi replicated); ``step(state,
    docs, mask)`` runs one sweep (module docstring) and returns the next
    state, sharded alike.  ``step`` also takes plain tensors holding the
    whole arrays on every rank, of which each rank takes its documents.

    ``method`` is ``"auto"`` (resolved per shard over the factored
    u-driven set) or a u-driven variant (``lda_kernel`` draws straight
    from the factors).  ``sparse=True`` draws z by the MH-alias sweep
    instead (module docstring; ``cap`` and ``mh_steps`` as in
    ``sparse.gibbs_step_sparse``)."""
    if method != "auto" and method not in _dist.U_VARIANTS:
        raise ValueError(
            f"the distributed z-draw takes counter uniforms: method must be 'auto' or "
            f"one of {_dist.U_VARIANTS}, got {method!r}"
        )
    rows = _sharded.row_spec(mesh)
    rep = tuple(Replicate() for _ in rows)
    lay = _sharded._layout(mesh)
    group = _data_group(mesh)

    def place(state: LDAState, docs, mask):
        def put(x, placements):
            return distribute_tensor(torch.as_tensor(x), mesh, placements)

        return (
            LDAState(theta=put(state.theta, rows), phi=put(state.phi, rep),
                     z=put(state.z, rows), key=state.key, step=state.step),
            put(docs, rows),
            put(mask, rows),
        )

    def local(x, what: str) -> torch.Tensor:
        if isinstance(x, DTensor):
            return x.to_local()
        return _sharded._local_rows(lay, x, x.shape[0], what)

    def _dense_draw(theta, phi, docs_l, seed_z, row0: int, shards: int):
        """The factored plan's draw from global row counters (``row0``: the
        shard's first word position)."""
        C, N = docs_l.shape
        B = C * N
        dev = theta.device
        words = docs_l.reshape(-1)
        doc_ids = torch.arange(B, dtype=torch.int32, device=dev) // N
        p = sampling.plan((B, K), method=method, W=W, dtype=theta.dtype, has_key=False,
                          factored=True, devices=shards, backend=dev.type)
        if p.method in _dist.FACTORED_VARIANTS:
            idx = lda_draw_factored_rng(theta, phi, doc_ids, words, seed_z,
                                        row_offset=row0, W=p.W)
        else:
            d = p.build_from_factors(theta, phi, words, doc_ids)
            sd = _rng.fold(seed_z, _rng.TAG_U, 0).to(dev)
            idx = p.draw(d, u=_rng.row_uniforms(sd, row0, B))
        return idx.view(C, N)

    def _sparse_draw(z_old, docs_l, mask_l, theta, phi, seed_z, d0: int):
        """The MH-alias draw from the rank's incoming z (``d0``: the
        shard's first document)."""
        from repro_torch.lda import sparse as _sparse

        cap_eff = min(cap, K)
        doc_topic0, _ = _counts(z_old, docs_l, mask_l, K, V)
        counts = _sparse.sparse_counts(doc_topic0, cap_eff)
        tbl_a, tbl_b = _sparse.word_proposal_tables(phi, "cdf")
        z, _, _, _ = _sparse._mh_sweep(
            z_old, docs_l, mask_l, theta, phi, counts.ids, counts.cnt, tbl_a, tbl_b,
            _rng.fold(seed_z, _rng.TAG_SPARSE_MH), d0, alpha, steps=mh_steps,
            cap=cap_eff, mode="cdf", chunk=min(256, docs_l.shape[0]))
        return z

    def step(state: LDAState, docs, mask) -> LDAState:
        theta = local(state.theta, "theta")
        phi = state.phi.to_local() if isinstance(state.phi, DTensor) else state.phi
        docs_l, mask_l = local(docs, "docs"), local(mask, "mask")
        C, N = docs_l.shape
        B = C * N
        dev = theta.device
        seed = _rng.generator_seed(state.key)
        seed_z = _rng.fold(seed, _rng.TAG_LDA_Z, state.step)
        if sparse:
            z = _sparse_draw(local(state.z, "z"), docs_l, mask_l, theta, phi, seed_z,
                             lay.index * C)
        else:
            z = _dense_draw(theta, phi, docs_l, seed_z, lay.index * B, lay.shards)
        doc_topic, word_topic = _counts(z, docs_l, mask_l, K, V)
        dist.all_reduce(word_topic, group=group)   # AD-LDA's one synchronisation
        g_theta = _rng.seeded_generator(
            _rng.fold(_rng.fold(seed, _rng.TAG_LDA_THETA, state.step), lay.index), dev)
        theta = _update_theta(g_theta, doc_topic, alpha)
        phi = _update_phi(_rng.seeded_generator(
            _rng.fold(seed, _rng.TAG_LDA_PHI, state.step), dev), word_topic, beta)
        phi = DTensor.from_local(phi, mesh, rep, run_check=False, shape=phi.shape,
                                 stride=phi.stride())
        return LDAState(theta=_sharded._from_local(lay, theta), phi=phi,
                        z=_sharded._from_local(lay, z), key=state.key,
                        step=state.step + 1)

    return place, step
