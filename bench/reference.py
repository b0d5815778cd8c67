"""The plain reference of an LDA Gibbs sweep, and the judge of ``correct``.

Plain PyTorch only: this module imports nothing of ``repro_torch`` (nor
JAX), and takes nothing the program made except the outputs it judges.

What it works out again, from the corpus the benchmark made and the seed
it gave the program's ``torch.Generator``:

* **The start** (``init_state``): Dirichlet(1) theta rows and phi
  columns, then uniform topics, drawn from the generator in that order.
* **A dense sweep**: one ``torch.rand(chunk * L)`` per chunk of ``chunk``
  documents (the last chunk drawn full), then the theta and the phi gamma
  draws.  Topic of a position: the first k whose inclusive partial sum of
  ``theta[d] * phi[w]`` exceeds ``u * total``.
* **A sparse sweep**: ``mh_steps`` Metropolis-Hastings cycles per token
  from counter-based Threefry-2x32 uniforms, a word proposal by a descent
  over the word's phi partial sums (``cdf``), a doc proposal over each
  document's top-``cap`` topic counts; then the same gamma draws.  The
  cycle is spelled out in :func:`mh_sweep`.

The judge follows the program sweep by sweep (:class:`Judge`): the
reference's theta and phi of a sweep come from the counts of the
*program's* topics of the sweep before, so one topic drawn differently at
a rounding tie does not carry into later sweeps; every stage is compared
on its own.  Numbers compared (each with a limit in the traffic mix):

* ``z_faults`` (dense): positions whose topic differs from the float32
  reference and where no float32 rounding explains it: some partial sum
  between the two topics lies further than ``2 (K + 1) 2**-24 * total``
  from ``u * total`` in float64.  A different summation order may move a
  draw across a boundary only inside that band.
* ``z_mismatch`` (sparse): positions whose topic differs at all; the MH
  cycle's float32 operations are made in the reference's order, so the
  program's kernel must give the same topics.
* ``theta_err``, ``phi_err``: the largest absolute gap of an entry of
  theta (rows sum to 1) and of phi (columns sum to 1), at the start and
  after each checked sweep.

The control is this reference in bfloat16 put in the program's place
(:func:`control_step`): the dense draw's products and partial sums, the MH
cycle's factors, and the theta and phi it hands on, all in bfloat16.
"""

from __future__ import annotations

import math
from collections import namedtuple
from typing import Dict, List

import torch

_MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))
TAG_SPARSE_MH = 5
TAG_LDA_Z = 6

State = namedtuple("State", "theta phi z key step")


# ---------------------------------------------------------------------------
# Threefry-2x32 (the cipher behind JAX's PRNG), words held in int64
# ---------------------------------------------------------------------------


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """20 rounds; Python integers in, Python integers out, or int64
    tensors (values in [0, 2**32)) broadcast together."""
    if all(type(a) is int for a in (k0, k1, x0, x1)):
        k0, k1, x0, x1 = (a & _MASK for a in (k0, k1, x0, x1))
    else:
        dev = next(a.device for a in (k0, k1, x0, x1) if isinstance(a, torch.Tensor))
        k0, k1, x0, x1 = (_u32(a, dev) for a in (k0, k1, x0, x1))

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _MASK

    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def generator_words(seed: int):
    """The (2,) seed words of a generator seeded with ``seed``."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s >> 32, s & _MASK


def fold(words, a: int, b: int = 0):
    return threefry2x32(words[0], words[1], a, b)


def sweep_words(seed: int, step: int):
    """The sparse sweep's counter seed at ``step``."""
    return fold(fold(generator_words(seed), TAG_LDA_Z, step), TAG_SPARSE_MH)


def uniform(words, c0: torch.Tensor, c1: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) (the top 24 bits of word 0)."""
    b0, _ = threefry2x32(words[0], words[1], _u32(c0), _u32(c1, c0.device))
    return (b0 >> 8).to(torch.float32) * (2.0 ** -24)


# ---------------------------------------------------------------------------
# The start, the counts and the Dirichlet resample
# ---------------------------------------------------------------------------


def dirichlet(g: torch.Generator, conc: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch._standard_gamma(conc, generator=g)
    return x / x.sum(dim=dim, keepdim=True)


def start(g: torch.Generator, M: int, L: int, V: int, K: int, device):
    """(theta, phi, z): Dirichlet(1) theta rows, phi columns, uniform z."""
    theta = dirichlet(g, torch.ones((M, K), device=device), dim=1)
    phi = dirichlet(g, torch.ones((K, V), device=device), dim=1).T.contiguous()
    z = torch.randint(0, K, (M, L), generator=g, device=device, dtype=torch.int32)
    return theta, phi, z


def counts(z, docs, mask, K: int, V: int):
    """float32 (doc_topic (M, K), word_topic (V, K)) of the live positions."""
    M = z.shape[0]
    zl = z.long()
    w = mask.reshape(-1).to(torch.float32)
    dt = torch.zeros(M * K, dtype=torch.float32, device=z.device)
    dt.index_add_(0, (torch.arange(M, device=z.device)[:, None] * K + zl).reshape(-1), w)
    wt = torch.zeros(V * K, dtype=torch.float32, device=z.device)
    wt.index_add_(0, (docs.long() * K + zl).reshape(-1), w)
    return dt.view(M, K), wt.view(V, K)


def resample(g, z, docs, mask, alpha: float, beta: float, K: int, V: int):
    """(theta, phi, doc_topic) after a sweep whose topics are ``z``."""
    dt, wt = counts(z, docs, mask, K, V)
    theta = dirichlet(g, alpha + dt, dim=-1)
    phi = dirichlet(g, beta + wt, dim=0)
    return theta, phi, dt


# ---------------------------------------------------------------------------
# The dense draw
# ---------------------------------------------------------------------------


def chunk_uniforms(g: torch.Generator, M: int, L: int, chunk: int, device) -> torch.Tensor:
    """(M, L) uniforms of a dense sweep: one draw of chunk * L per chunk."""
    chunk = min(chunk, M)
    parts = [torch.rand(chunk * L, generator=g, device=device)
             for _ in range(0, M, chunk)]
    return torch.cat(parts)[: M * L].view(M, L)


def _rows(K: int) -> int:
    """Positions per block of the draw: a (rows, K) float32 block of 256 MB."""
    return max(1024, 1 << (max((1 << 26) // max(K, 1), 1).bit_length() - 1))


def dense_draw(theta, phi, d, w, u, dtype=torch.float32) -> torch.Tensor:
    """Topics of positions (doc ``d``, word ``w``, uniform ``u``), computed
    in ``dtype``, in blocks of rows."""
    K = theta.shape[1]
    th, ph = theta.to(dtype), phi.to(dtype)
    out = torch.empty(d.shape[0], dtype=torch.int32, device=d.device)
    step = _rows(K)
    for s in range(0, d.shape[0], step):
        p = torch.cumsum(th[d[s:s + step]] * ph[w[s:s + step]], dim=1)
        stop = p[:, -1] * u[s:s + step].to(dtype)
        idx = torch.searchsorted(p, stop[:, None], right=True)[:, 0]
        out[s:s + step] = idx.clamp_(max=K - 1)
    return out


def tie_tolerance(K: int) -> float:
    """Relative width of float32 rounding around a boundary, for two
    implementations that sum K terms in different orders."""
    return 2.0 * (K + 1) * 2.0 ** -24


def dense_faults(a, b, theta, phi, d, w, u) -> int:
    """How many draws ``a`` (judged) differ from ``b`` (reference) where no
    float32 rounding explains it (float64 check), or lie outside [0, K)."""
    K = theta.shape[1]
    bad = (a < 0) | (a >= K)
    mis = torch.nonzero((a != b) & ~bad)[:, 0]
    faults = int(bad.sum())
    step = _rows(K) // 4
    for s in range(0, mis.numel(), step):
        i = mis[s:s + step]
        P = torch.cumsum(theta[d[i]].double() * phi[w[i]].double(), dim=1)
        total = P[:, -1]
        stop = total * u[i].double()
        lo = torch.minimum(a[i], b[i]).long()
        hi = torch.maximum(a[i], b[i]).long()
        j = torch.arange(K, device=P.device)[None, :]
        between = (j >= lo[:, None]) & (j < hi[:, None])
        gap = torch.where(between, (P - stop[:, None]).abs(), torch.zeros_like(P))
        faults += int((gap.max(dim=1).values > tie_tolerance(K) * total).sum())
    return faults


# ---------------------------------------------------------------------------
# The sparse MH sweep
# ---------------------------------------------------------------------------


def pow2_capacity(nnz: int, cap_min: int, cap_max: int) -> int:
    n = max(int(nnz), 1)
    return max(cap_min, min(cap_max, 1 << (n - 1).bit_length()))


class Capacity:
    """The retained-list width: a power of two covering the largest
    number of topics a document holds, clamped to [cap_min, cap_max];
    it grows at once and shrinks only once that number falls to a
    quarter of it."""

    def __init__(self, cap_min: int, cap_max: int):
        self.cap_min, self.cap_max, self.cap = cap_min, cap_max, None

    def update(self, doc_topic) -> int:
        nnz = int((doc_topic > 0).sum(dim=1).max()) if doc_topic.shape[0] else 0
        want = pow2_capacity(nnz, self.cap_min, self.cap_max)
        if self.cap is None or want > self.cap or (nnz <= self.cap // 4 and want < self.cap):
            self.cap = want
        return self.cap


def top_counts(doc_topic, cap: int):
    """Each document's ``cap`` largest (topic, count), ties to the lower
    topic: int32 (ids, cnt)."""
    cap = min(cap, doc_topic.shape[-1])
    cnt, ids = torch.sort(doc_topic.to(torch.int32), dim=-1, descending=True, stable=True)
    return ids[:, :cap].to(torch.int32).contiguous(), cnt[:, :cap].contiguous()


def _ceil_log2(n: int) -> int:
    return max(1, (int(n) - 1).bit_length())


def mh_sweep(z, docs, mask, theta, phi, ids, cnt, words, alpha: float, *,
             steps: int, dtype=torch.float32, chunk: int = 4096) -> torch.Tensor:
    """``steps`` MH cycles over every live token from topics ``z``; the
    new (M, L) int32 topics.  A cycle of token (d, i), word w, counter
    c = d * L + i, uniforms u_j = uniform(words, c, 5 s + j):

    * word proposal k' by a descent over phi[w]'s inclusive partial sums
      to the first entry >= u0 * total (u1 unused), accepted iff
      u2 * theta[d, z] < theta[d, k'];
    * doc proposal: t = u3 * (K alpha + sum cnt); t < K alpha gives
      min(int(t / alpha), K - 1), else ids[min(#{cc <= t - K alpha},
      cap - 1)] (cc the prefix sums of cnt); accepted iff
      u4 * theta[d,z] phi[w,z] (alpha + n(k')) < theta[d,k'] phi[w,k']
      (alpha + n(z)), n the retained count, each product left to right.

    Every float operation is made in ``dtype``, in this order."""
    M, L = docs.shape
    K = theta.shape[1]
    cap = ids.shape[1]
    dev = theta.device
    f = dtype
    alpha_t = torch.tensor(alpha, dtype=f, device=dev)
    Kf = torch.tensor(float(K), dtype=f, device=dev)
    Ka = Kf * alpha_t
    th_all, ph = theta.to(f), phi.to(f)
    cdf = torch.cumsum(phi.to(torch.float32), dim=1).to(f).reshape(-1)
    flat_phi = ph.reshape(-1)
    live = mask > 0
    z_out = z.to(torch.int32).clone()
    pos = torch.arange(L, dtype=torch.int64, device=dev)
    levels = _ceil_log2(K)
    for s0 in range(0, M, chunk):
        s1 = min(s0 + chunk, M)
        zc = z_out[s0:s1].long()
        mc = live[s0:s1]
        thc = th_all[s0:s1]
        idsc = ids[s0:s1].long()
        cntc = cnt[s0:s1]
        cc = torch.cumsum(cntc, dim=1).to(f)
        mass = Ka + cc[:, -1]
        ctr = (torch.arange(s0, s1, dtype=torch.int64, device=dev)[:, None] * L
               + pos[None, :]) & _MASK
        wrow = docs[s0:s1].long() * K

        def retained(k):
            hit = idsc[:, None, :] == k[..., None]
            return torch.where(hit, cntc[:, None, :], 0).sum(dim=2).to(f)

        for s in range(steps):
            u = [uniform(words, ctr, 5 * s + j).to(f) for j in range(5)]
            t = u[0] * cdf[wrow + (K - 1)]
            base = torch.zeros_like(wrow)
            span = 1 << levels
            while span > 1:
                span //= 2
                cand = base + (span - 1)
                val = cdf[wrow + torch.clamp(cand, max=K - 1)]
                base = base + torch.where((cand < K) & (val < t), span, 0)
            kp = torch.clamp(base, max=K - 1)
            acc = (u[2] * torch.gather(thc, 1, zc) < torch.gather(thc, 1, kp)) & mc
            zc = torch.where(acc, kp, zc)
            t = u[3] * mass[:, None]
            ku = torch.clamp((t / alpha_t).to(torch.int32), max=K - 1).long()
            p = (cc[:, None, :] <= (t - Ka)[..., None]).sum(dim=2)
            ks = torch.gather(idsc, 1, torch.clamp(p, max=cap - 1))
            kp = torch.where(t < Ka, ku, ks)
            num = torch.gather(thc, 1, kp) * flat_phi[wrow + kp] * (alpha_t + retained(zc))
            den = torch.gather(thc, 1, zc) * flat_phi[wrow + zc] * (alpha_t + retained(kp))
            acc = (u[4] * den < num) & mc
            zc = torch.where(acc, kp, zc)
        z_out[s0:s1] = zc.to(torch.int32)
    return z_out


# ---------------------------------------------------------------------------
# The control: this reference in bfloat16, in the program's place
# ---------------------------------------------------------------------------


def control_step(mix: dict, dtype=torch.bfloat16):
    """A stand-in for ``gibbs_step`` that runs this reference in ``dtype``
    (the control of ``correct``).  It draws from the state's generator
    exactly as the program does, so the judge's replay stays in step."""
    ref = mix["reference"]
    caps: Dict[int, Capacity] = {}

    def step(state, corpus, alpha=0.1, beta=0.05, **_):
        docs, mask = corpus.docs, corpus.mask
        M, L = docs.shape
        K, V = state.theta.shape[1], state.phi.shape[0]
        if ref["draw"] == "dense":
            u = chunk_uniforms(state.key, M, L, ref["chunk"], docs.device)
            d, w, idx = live_positions(docs, mask)
            z = state.z.clone()
            z[mask] = dense_draw(state.theta, state.phi, d, w, u.reshape(-1)[idx], dtype)
        else:
            cap = caps.setdefault(0, Capacity(ref["cap_min"], ref["cap_max"]))
            if cap.cap is None:
                cap.update(counts(state.z, docs, mask, K, V)[0])
            ids, cnt = top_counts(counts(state.z, docs, mask, K, V)[0], cap.cap)
            z = mh_sweep(state.z, docs, mask, state.theta, state.phi, ids, cnt,
                         sweep_words(state.key.initial_seed(), state.step), alpha,
                         steps=ref["mh_steps"], dtype=dtype)
        theta, phi, dt = resample(state.key, z, docs, mask, alpha, beta, K, V)
        if ref["draw"] != "dense":
            caps[0].update(dt)
        theta = theta.to(dtype).to(torch.float32)
        phi = phi.to(dtype).to(torch.float32)
        return State(theta, phi, z, state.key, state.step + 1)

    return step


# ---------------------------------------------------------------------------
# The judge
# ---------------------------------------------------------------------------


def live_positions(docs, mask):
    """(doc, word, flat index) of every live position, in row-major order."""
    idx = torch.nonzero(mask.reshape(-1))[:, 0]
    return idx // docs.shape[1], docs.reshape(-1)[idx].long(), idx


class Judge:
    """Follows the program from the seed, one checked sweep at a time.

    ``snapshots[0]`` is the program's start (theta, phi, z) and
    ``snapshots[i]`` its state after sweep i, as host or device tensors.
    ``mix["reference"]`` names the draw (``dense``: ``chunk``; ``mh``:
    ``mh_steps``, ``cap_min``, ``cap_max``)."""

    def __init__(self, config: dict, mix: dict, docs, mask, state_seed: int, device):
        self.ref = mix["reference"]
        self.K, self.V = int(config["K"]), int(config["V"])
        self.alpha, self.beta = float(config["alpha"]), float(config["beta"])
        self.docs, self.mask = docs, mask
        self.seed = int(state_seed)
        self.dev = torch.device(device)

    def numbers(self, snapshots: List[tuple]) -> Dict[str, float]:
        dev, K, V = self.dev, self.K, self.V
        docs, mask = self.docs, self.mask
        M, L = docs.shape
        g = torch.Generator(device=dev).manual_seed(self.seed)
        theta, phi, z0 = start(g, M, L, V, K, dev)
        dense = self.ref["draw"] == "dense"
        zkey = "z_faults" if dense else "z_mismatch"
        out = {zkey: 0, "theta_err": 0.0, "phi_err": 0.0}

        def gaps(snap, theta, phi):
            pt, pp = (x.to(dev) for x in snap[:2])
            out["theta_err"] = max(out["theta_err"], _gap(pt, theta))
            out["phi_err"] = max(out["phi_err"], _gap(pp, phi))

        gaps(snapshots[0], theta, phi)
        zp = snapshots[0][2].to(dev)
        out[zkey] += int((zp != z0).sum()) if zp.shape == z0.shape else zp.numel()
        d, w, idx = live_positions(docs, mask)
        cap = Capacity(self.ref.get("cap_min", 8), self.ref.get("cap_max", 64))
        if not dense:
            cap.update(counts(zp, docs, mask, K, V)[0])
        for i, snap in enumerate(snapshots[1:]):
            z_prog = snap[2].to(dev)
            if dense:
                uu = chunk_uniforms(g, M, L, self.ref["chunk"], dev).reshape(-1)[idx]
                b = dense_draw(theta, phi, d, w, uu)
                a = z_prog[mask]
                out[zkey] += dense_faults(a, b, theta, phi, d, w, uu)
            else:
                ids, cnt = top_counts(counts(zp, docs, mask, K, V)[0], cap.cap)
                b = mh_sweep(zp, docs, mask, theta, phi, ids, cnt,
                             sweep_words(self.seed, i), self.alpha,
                             steps=self.ref["mh_steps"])
                out[zkey] += int((z_prog[mask] != b[mask]).sum())
            theta, phi, dt = resample(g, z_prog, docs, mask, self.alpha, self.beta, K, V)
            if not dense:
                cap.update(dt)
            gaps(snap, theta, phi)
            zp = z_prog
        return out


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return math.inf
    g = (a.double() - b.double()).abs().max()
    return math.inf if not torch.isfinite(g) else float(g)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number above its limit, or missing,
    makes the run not correct."""
    return {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in limits}
