"""Plain PyTorch version of the sparse LDA MH sweep (S1's oracle).

:func:`mh_sweep_torch` is the reference's ``_mh_sweep``
(``repro/lda/sparse.py``) in PyTorch: ``steps`` Metropolis-Hastings
cycles over every word position, a loop over chunks of ``chunk``
documents, with the same float32 operations in the same order, so that
on the same inputs it gives the same topics and accept counts.  It runs
on the CPU (the port's sweep there) and on the card (the plain version
the kernel is held to).

A cycle of a token at document d, position i, word w:

* **Uniforms**: ``u_j = uniform(seed, c, 5*s + j)``, j = 0..4, with the
  token counter ``c = (row0 + d) * L + i`` in uint32 (int64 words masked
  to 32 bits, as ``kernels.rng`` computes).
* **Word proposal** ``k' ~ phi[w, :]``: ``alias``/``alias_device``
  tables (column ``min(int(u0 * K), K - 1)``, kept iff ``u1 < prob``),
  or ``cdf`` (a branchless dyadic descent over the word's inclusive
  partial sums, ``span0 = 2**ceil(log2 K)``: ``log2 K`` scalar gathers);
  accepted iff ``u2 * theta[d, z] < theta[d, k']``.
* **Doc proposal** over the retained sparse counts: ``t = u3 * mass``
  with ``mass = K*alpha + sum(cnt)``; ``t < K*alpha`` takes the smoothing
  branch ``min(int(t / alpha), K - 1)``, else the doc-sparse branch
  ``ids[min(#{cc <= t - K*alpha}, cap - 1)]`` (``cc`` the inclusive
  prefix of ``cnt``); accepted iff ``u4 * den < num`` with
  ``num = theta[d,k'] * phi[w,k'] * (alpha + n(z))`` and
  ``den = theta[d,z] * phi[w,z] * (alpha + n(k'))``, left to right.

The reference pads the last chunk to a full one (theta rows of 1.0, zero
masks); padded rows are masked out and sliced away, so the last chunk
here runs unpadded and gives the same results.  Every intermediate is
(chunk, L) or (chunk, L, cap): no (tokens, K) tensor forms.

The divisor ``alpha`` is a float32 tensor on the inputs' device, never a
host scalar: PyTorch on the card divides by a host scalar through its
reciprocal, which rounds differently from the true quotient that the
kernel and the reference take.

:func:`mh_sweep_doc_order_torch` models S1's ``"doc"`` layout token by
token in its own order: one document a block, its list as a topic ->
count map (the scatter of ``cnt`` at ``ids``) and its float32 prefix
``cc``, the doc-sparse position by the kernel's upper-bound binary
search over ``cc``, and the document's live positions in order, token
``i`` on lane ``i % threads`` in round ``i // threads``.  It gives what :func:`mh_sweep_torch` gives wherever
``cnt >= 0`` (``cc`` non-decreasing, as ``sparse_counts`` produces).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import rng as _rng

_MASK = 0xFFFFFFFF
MODES = ("cdf", "alias", "alias_device")


def ceil_log2(n: int) -> int:
    return max(1, (int(n) - 1).bit_length())


def _word_propose(mode: str, w, u0, u1, tbl_a, tbl_b, K: int, Kf):
    """(C, L) proposed topics from the word tables (rows ``w``)."""
    wrow = w.long() * K
    flat_a = tbl_a.reshape(-1)
    if mode in ("alias", "alias_device"):
        kr = torch.clamp((u0 * Kf).to(torch.int32), max=K - 1).long()
        pw = flat_a[wrow + kr]
        ka = tbl_b.reshape(-1)[wrow + kr].long()
        return torch.where(u1 < pw, kr, ka)
    t = u0 * flat_a[wrow + (K - 1)]
    base = torch.zeros_like(wrow)
    span = 1 << ceil_log2(K)
    while span > 1:
        span //= 2
        cand = base + (span - 1)
        val = flat_a[wrow + torch.clamp(cand, max=K - 1)]
        base = base + torch.where((cand < K) & (val < t), span, 0)
    return torch.clamp(base, max=K - 1)


def count_le(cc, x, cap: int) -> torch.Tensor:
    """``#{j < cap : cc[..., j] <= x}`` by S1's upper-bound binary search
    (``sparse_mh.cu``'s ``count_le``): halving steps from the largest
    power of two <= cap; equal to the linear count where ``cc`` is
    non-decreasing along its last axis."""
    p = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    step = 1 << (int(cap).bit_length() - 1)
    while step:
        q = p + step
        val = torch.gather(cc, -1, (torch.clamp(q, max=cap) - 1).unsqueeze(-1)).squeeze(-1)
        p = torch.where((q <= cap) & (val <= x), q, p)
        step >>= 1
    return p


def _retained(ids_c, cnt_c, k) -> torch.Tensor:
    """(C, L) float32 retained count of topic ``k`` in each doc's list."""
    hit = ids_c[:, None, :] == k[..., None]
    return torch.where(hit, cnt_c[:, None, :], 0).sum(dim=2).to(torch.float32)


def mh_sweep_torch(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed, row0,
                   alpha, *, steps: int, cap: int, mode: str, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``steps`` MH cycles over every token: ``(z, word_accepts,
    doc_accepts, proposals)``, the counts as 0-d int64 tensors.

    z, docs (M, L) int32; mask (M, L); theta (M, K) and phi (V, K)
    float32; ids, cnt (M, cap) int32; tbl_a (V, K) float32 (alias prob,
    or the cdf rows) and tbl_b (V, K) int32 (alias; unused by ``cdf``);
    seed a (2,) seed pair; row0 the first document's global index."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    M, L = docs.shape
    K = theta.shape[-1]
    dev = theta.device
    f32 = torch.float32
    seed = _rng._u32(seed, dev)
    alpha_t = torch.tensor(alpha, dtype=f32, device=dev)
    Kf = torch.tensor(float(K), dtype=f32, device=dev)
    Ka = Kf * alpha_t
    live = mask > 0
    z_out = z.to(torch.int32).clone()
    wa = torch.zeros((), dtype=torch.int64, device=dev)
    da = torch.zeros((), dtype=torch.int64, device=dev)
    chunk = min(chunk, M) if M else chunk
    pos = torch.arange(L, dtype=torch.int64, device=dev)
    for start in range(0, M, chunk):
        end = min(start + chunk, M)
        zc = z_out[start:end].long()
        dc = docs[start:end]
        mc = live[start:end]
        thc = theta[start:end].to(f32)
        idsc = ids[start:end].long()
        cntc = cnt[start:end]
        ccc = torch.cumsum(cntc, dim=1).to(f32)
        mass = Ka + ccc[:, -1]
        dbase = (int(row0) + torch.arange(start, end, dtype=torch.int64, device=dev)) & _MASK
        ctr = (dbase[:, None] * L + pos[None, :]) & _MASK
        wrow = dc.long() * K
        flat_phi = phi.reshape(-1)
        for s in range(steps):
            u = [_rng.uniform(seed, ctr, 5 * s + j) for j in range(5)]
            # word proposal: q ~ phi[w, :], accepted on the theta ratio
            kp = _word_propose(mode, dc, u[0], u[1], tbl_a, tbl_b, K, Kf)
            thz = torch.gather(thc, 1, zc)
            thp = torch.gather(thc, 1, kp)
            acc = (u[2] * thz < thp) & mc
            zc = torch.where(acc, kp, zc)
            wa += acc.sum()
            # doc proposal: smoothing and doc-sparse branches
            t = u[3] * mass[:, None]
            smooth = t < Ka
            ku = torch.clamp((t / alpha_t).to(torch.int32), max=K - 1).long()
            p = (ccc[:, None, :] <= (t - Ka)[..., None]).sum(dim=2)
            ks = torch.gather(idsc, 1, torch.clamp(p, max=cap - 1))
            kp = torch.where(smooth, ku, ks)
            ncur = _retained(idsc, cntc, zc)
            nprop = _retained(idsc, cntc, kp)
            thz = torch.gather(thc, 1, zc)
            thp = torch.gather(thc, 1, kp)
            phz = flat_phi[wrow + zc]
            php = flat_phi[wrow + kp]
            num = thp * php * (alpha_t + ncur)
            den = thz * phz * (alpha_t + nprop)
            acc = (u[4] * den < num) & mc
            zc = torch.where(acc, kp, zc)
            da += acc.sum()
        z_out[start:end] = zc.to(torch.int32)
    return z_out, wa, da, live.sum() * steps


def doc_schedule(mask, threads: int):
    """S1's doc-layout order of the live tokens: ``(doc, pos, lane,
    round)`` int64 tensors, one document a block, its live positions in
    order, token ``i`` of a document on lane ``i % threads`` in round
    ``i // threads``."""
    M, L = mask.shape
    flat = torch.nonzero(mask.reshape(-1) > 0).squeeze(1)
    doc, pos = flat // L, flat % L
    per_doc = torch.bincount(doc, minlength=M)
    first = torch.cumsum(per_doc, 0) - per_doc
    i = torch.arange(flat.numel(), device=mask.device) - first[doc]
    return doc, pos, i % threads, i // threads


def mh_sweep_doc_order_torch(z, docs, mask, theta, phi, ids, cnt, tbl_a, tbl_b, seed,
                             row0, alpha, *, steps: int, cap: int, mode: str,
                             threads: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """S1's ``"doc"`` layout as an exact-order model: the arguments and
    results of :func:`mh_sweep_torch`.  The rounds of the schedule run in
    order, each over every document's token of that round; a token's
    cycles read its document's map and ``cc`` only."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    M, L = docs.shape
    K = theta.shape[-1]
    dev = theta.device
    f32 = torch.float32
    seed = _rng._u32(seed, dev)
    alpha_t = torch.tensor(alpha, dtype=f32, device=dev)
    Kf = torch.tensor(float(K), dtype=f32, device=dev)
    Ka = Kf * alpha_t
    z_out = z.to(torch.int32).clone()
    wa = torch.zeros((), dtype=torch.int64, device=dev)
    da = torch.zeros((), dtype=torch.int64, device=dev)
    # each document's list: the topic -> count map (ids outside [0, K)
    # skipped) and the float32 of the integer prefix
    idsl, cntl = ids.long(), cnt.to(torch.int32)
    keep = (idsl >= 0) & (idsl < K)
    tmap = torch.zeros((M, K), dtype=torch.int32, device=dev)
    rows = torch.arange(M, device=dev)[:, None].expand_as(idsl)
    tmap.index_put_((rows[keep], idsl[keep]), cntl[keep], accumulate=True)
    cc = torch.cumsum(cntl, dim=1, dtype=torch.int32).to(f32)
    mass = Ka + cc[:, cap - 1]
    doc, pos, _, rnd = doc_schedule(mask, threads)
    flat_phi, flat_th = phi.reshape(-1), theta.reshape(-1)
    for r in range(int(rnd.max()) + 1 if rnd.numel() else 0):
        sel = rnd == r
        d, i = doc[sel], pos[sel]
        w = docs[d, i]
        zc = z_out[d, i].long()
        trow, wrow = d * K, w.long() * K
        ctr = (((int(row0) + d) & _MASK) * L + i) & _MASK
        for s in range(steps):
            u0, u2, u3, u4 = (_rng.uniform(seed, ctr, 5 * s + j) for j in (0, 2, 3, 4))
            u1 = _rng.uniform(seed, ctr, 5 * s + 1) if mode != "cdf" else None
            kp = _word_propose(mode, w, u0, u1, tbl_a, tbl_b, K, Kf)
            acc = u2 * flat_th[trow + zc] < flat_th[trow + kp]
            zc = torch.where(acc, kp, zc)
            wa += acc.sum()
            t = u3 * mass[d]
            ku = torch.clamp((t / alpha_t).to(torch.int32), max=K - 1).long()
            p = count_le(cc[d], t - Ka, cap)
            ks = idsl[d, torch.clamp(p, max=cap - 1)]
            kq = torch.where(t < Ka, ku, ks)
            ncur = tmap[d, zc].to(f32)
            nprop = tmap[d, kq].to(f32)
            num = flat_th[trow + kq] * flat_phi[wrow + kq] * (alpha_t + ncur)
            den = flat_th[trow + zc] * flat_phi[wrow + zc] * (alpha_t + nprop)
            acc = u4 * den < num
            zc = torch.where(acc, kq, zc)
            da += acc.sum()
        z_out[d, i] = zc.to(torch.int32)
    return z_out, wa, da, (mask > 0).sum() * steps
