#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which raises on failure (exit code != 0, no result line):

1. Device: the card's name and power limit (nvidia-smi), then the CUDA
   kernels built from the sources in this checkout (nvcc, sm_90a, one
   process per library, all started together).
2. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes (K=240, V=37,286, one chunk of 256 documents = 27,392
   draws).  The factored draw: the fused draw (K8) through
   ``lda_draw_factored``, the forced two-pass route, pass A (K6) through
   ``lda_build_running`` and pass B (K7) through ``lda_draw_from_running``
   with S=1 and S=4.  The draw on the chunk's given weights: the
   butterfly table (K1, both layouts), the fused draw (K4), the forced
   two-pass route, pass A (K2) and pass B (K3) with S=1 and S=4.  W=32
   and W=16; integer weights (0 mismatches allowed), Dirichlet weights
   (float64-checked boundary ties only), bf16, and the padded last chunk
   with all-zero rows; K1 also at W=4 and W=8, K4 also at K=32,000 x
   B=64.  Each kernel and its plain version are timed with CUDA events
   (and K2's one-call library counterpart).
3. The main paths at the paper's Wikipedia scale (M=43,556 docs,
   V=37,286 words, K=240, ~3.07M tokens, Zipf word ids, made from --seed),
   each run with the launch counts set to 0 just before it and read just
   after: 3 ``gibbs_step`` sweeps with ``method="lda_kernel"``, W=32 (K8,
   one launch per chunk of 256 docs), then ``sample_z`` with 4 draws per
   token (K6 + K7 per chunk); 3 sweeps with ``method="butterfly"`` (K1 per
   chunk) and 3 with ``method="kernel"`` (K2 + K3 per chunk), W=16 (the
   reference's ``default_w(240)``); the given-weights entry points over
   every chunk of the last state (``butterfly_sample``, K4;
   ``build_block_sums`` and ``butterfly_sample_from_sums_rng`` with 4
   draws per token, K2 + K3).  Then one sweep per method under
   ``torch.profiler`` (device time by kernel, the device's busy share) and
   the Figure-3 K-sweep (lda_kernel, butterfly, kernel and prefix),
   printed, no claim made.
4. A planted corpus: 30 ``lda_kernel`` sweeps must bring perplexity below
   0.6 x its initial value.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits 1 before printing a result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.lda import CONFIG  # noqa: E402
from repro_torch.core import butterfly as bfly  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.butterfly_sample import kernel as KB  # noqa: E402
from repro_torch.kernels.butterfly_sample import ops as bops  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import boundary_ties as weight_ties  # noqa: E402
from repro_torch.kernels.butterfly_table import kernel as KT  # noqa: E402
from repro_torch.kernels.lda_draw import kernel as KL  # noqa: E402
from repro_torch.kernels.lda_draw import ops  # noqa: E402
from repro_torch.kernels.lda_draw.ref import boundary_ties  # noqa: E402
from repro_torch.lda import corpus as corpus_mod  # noqa: E402
from repro_torch.lda import gibbs  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
_CSRC = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
_TPU = "src/repro/kernels/{}/kernel.py:{}"
KERNELS = {  # wrapper name -> (kernel-table id, source, TPU kernel it replaces, counts)
    "butterfly_table": ("K1", _CSRC.format("butterfly_table"),
                        _TPU.format("butterfly_table", 56), KT.LAUNCHES),
    "blocksums": ("K2", _CSRC.format("butterfly_sample"),
                  _TPU.format("butterfly_sample", 140), KB.LAUNCHES),
    "walk": ("K3", _CSRC.format("butterfly_sample"),
             _TPU.format("butterfly_sample", 744), KB.LAUNCHES),
    "fused_draw": ("K4", _CSRC.format("butterfly_sample"),
                   _TPU.format("butterfly_sample", 183), KB.LAUNCHES),
    "lda_blocksums": ("K6", _CSRC.format("lda_draw"), _TPU.format("lda_draw", 125),
                      KL.LAUNCHES),
    "lda_walk": ("K7", _CSRC.format("lda_draw"), _TPU.format("lda_draw", 178),
                 KL.LAUNCHES),
    "lda_fused_draw": ("K8", _CSRC.format("lda_draw"), _TPU.format("lda_draw", 61),
                       KL.LAUNCHES),
}


def reset_counts() -> None:
    for mod in (KT, KB, KL):
        mod.reset_launches()


def read_counts() -> dict:
    return {name: k[3][name] for name, k in KERNELS.items()}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def paper_corpus(seed: int, M: int, V: int, avg_len=70.5, max_len=307,
                 zipf=1.05) -> corpus_mod.Corpus:
    """A corpus at the paper's scale, vectorised from a seed: Poisson doc
    lengths clipped to [1, max_len], Zipf-distributed word ids (id = rank)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(avg_len, size=M), 1, max_len).astype(np.int32)
    maxN = int(lengths.max())
    p = np.arange(1, V + 1, dtype=np.float64) ** -zipf
    cdf = np.cumsum(p) / p.sum()
    words = np.searchsorted(cdf, rng.random(int(lengths.sum())), side="right")
    mask = np.arange(maxN)[None, :] < lengths[:, None]
    docs = np.zeros((M, maxN), np.int32)
    docs[mask] = np.minimum(words, V - 1)
    return corpus_mod.Corpus(docs=docs, lengths=lengths, mask=mask, vocab_size=V)


def factors(kind: str, C: int, V: int, K: int, g: torch.Generator, dev):
    if kind == "int":
        th = torch.randint(1, 100, (C, K), generator=g, device=dev).float()
        ph = torch.randint(1, 100, (V, K), generator=g, device=dev).float()
        return th, ph
    th = torch._standard_gamma(torch.full((C, K), 0.3, device=dev), generator=g)
    ph = torch._standard_gamma(torch.full((V, K), 0.3, device=dev), generator=g)
    return th / th.sum(1, keepdim=True), ph / ph.sum(0, keepdim=True)


class Tally:
    """Per-kernel comparison results over every case of phase 2."""

    def __init__(self):
        self.t = {n: {"cases": 0, "mismatches": 0, "ties": 0, "max_abs_err": 0.0}
                  for n in KERNELS}

    def _indices(self, name, case, a, b, res, exact: bool):
        t = self.t[name]
        t["cases"] += 1
        t["mismatches"] += res["mismatches"] if exact else 0
        t["ties"] += 0 if exact else res["ties"]
        t["max_abs_err"] = max(t["max_abs_err"],
                               float((a.long() - b.long()).abs().max()) if exact else 0.0)
        bad = res["mismatches"] if exact else res["faults"]
        log(f"  {name:15s} {case:34s} mismatches={res['mismatches']} "
            f"ties={res['ties']} faults={res['faults']}")
        if bad:
            raise AssertionError(f"{name} disagrees with its plain version: {case} {res}")

    def indices(self, name, case, a, b, th, ph, d, w, u, exact: bool):
        """Draws from the factors theta[d] * phi[w]."""
        self._indices(name, case, a, b, boundary_ties(a, b, th, ph, d, w, u), exact)

    def weights(self, name, case, a, b, wts, u, exact: bool):
        """Draws from given (B, K) weights."""
        self._indices(name, case, a, b, weight_ties(a, b, wts, u), exact)

    def running(self, name, case, a, b, exact: bool):
        t = self.t[name]
        t["cases"] += 1
        err = float((a - b).abs().max())
        rel = err / float(b.abs().max())
        log(f"  {name:15s} {case:34s} max_abs_err={err:.3g} rel={rel:.3g}")
        if exact and err:
            raise AssertionError(f"{name} running sums differ on integer weights: {err}")
        if rel > 240 * 2.0 ** -23:
            raise AssertionError(f"{name} running sums off by {rel:.3g} relative")
        if exact:
            t["max_abs_err"] = max(t["max_abs_err"], err)

    def table(self, name, case, got, want, W, exact: bool):
        """Butterfly tables in the (G, nb, W, W) layout: rows 0..W-2 of
        every block equal; the running row W-1 equal on integer weights,
        else within nb fp32 roundings (the kernel carries it in order,
        the plain version takes torch.cumsum)."""
        t = self.t[name]
        t["cases"] += 1
        nb = got.shape[1]
        seg = int((got[..., : W - 1, :] != want[..., : W - 1, :]).sum())
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30))[..., W - 1, :].max())
        log(f"  {name:15s} {case:34s} segment mismatches={seg} "
            f"max_abs_err={err:.3g} running rel={rel:.3g}")
        if seg or (exact and err) or rel > nb * 2.0 ** -22:
            raise AssertionError(f"{name} table differs from its plain version: {case}")
        if exact:
            t["max_abs_err"] = max(t["max_abs_err"], err)


def rows_to_blocks(t, W):
    """(B, K) butterfly table -> its (G, nb, W, W) layout."""
    B, K = t.shape
    return t.view(B // W, W, K // W, W).transpose(1, 2)


def phase_kernels(corpus, dev, seed: int):
    K, V, C = CONFIG.K, corpus.vocab_size, 256
    g = torch.Generator(device=dev).manual_seed(seed)
    docs_c = torch.as_tensor(corpus.docs[:C], device=dev)
    N = docs_c.shape[1]
    Bt = C * N
    d = (torch.arange(Bt, device=dev, dtype=torch.int32) // N).contiguous()
    w = docs_c.reshape(-1).contiguous()
    u = torch.rand(Bt, generator=g, device=dev)
    u4 = torch.rand((4, Bt), generator=g, device=dev)
    log(f"phase 2: kernels vs plain at C={C} docs x maxN={N} = {Bt} draws, K={K}, V={V}")
    tally = Tally()
    for W in (32, 16):
        for kind in ("int", "dirichlet"):
            exact = kind == "int"
            th, ph = factors(kind, C, V, K, g, dev)
            case = f"W={W} {kind}"
            plain = ops.lda_draw_factored(th, ph, d, w, u, W=W, impl="torch")
            fused = ops.lda_draw_factored(th, ph, d, w, u, W=W)
            tally.indices("lda_fused_draw", case, fused, plain, th, ph, d, w, u, exact)
            two = KL.lda_draw_docs(th, ph, d, w, u, W, route="two_pass")
            tally.indices("lda_walk", case + " two-pass route", two, plain,
                          th, ph, d, w, u, exact)
            _, _, run = ops.lda_build_running(th, ph, d, w, W=W)
            _, _, run_p = ops.lda_build_running(th, ph, d, w, W=W, impl="torch")
            tally.running("lda_blocksums", case, run, run_p, exact)
            for S, uu in ((1, u), (4, u4)):
                a = ops.lda_draw_from_running(th, ph, run, uu, d, w, K=K, W=W)
                b = ops.lda_draw_from_running(th, ph, run, uu, d, w, K=K, W=W, impl="torch")
                tally.indices("lda_walk", f"{case} S={S}", a, b, th, ph, d, w, uu, exact)
    # bf16 factors (integer values < 256 are exact in bf16)
    th, ph = (x.to(torch.bfloat16) for x in factors("int", C, V, K, g, dev))
    tally.indices("lda_fused_draw", "W=32 bf16",
                  ops.lda_draw_factored(th, ph, d, w, u, W=32),
                  ops.lda_draw_factored(th, ph, d, w, u, W=32, impl="torch"),
                  th.float(), ph.float(), d, w, u, True)
    # the sweep's last chunk: padded with all-zero theta rows
    th, ph = factors("dirichlet", corpus.docs.shape[0], V, K, g, dev)
    docs = torch.as_tensor(corpus.docs, device=dev)
    *_, (start, end, th_c, docs_p) = gibbs._chunks(th, docs, C)
    log(f"  last chunk: docs {start}..{end}, {C - (end - start)} all-zero theta rows")
    wz = docs_p.reshape(-1).contiguous()
    a = ops.lda_draw_factored(th_c, ph, d, wz, u, W=32)
    b = ops.lda_draw_factored(th_c, ph, d, wz, u, W=32, impl="torch")
    tally.indices("lda_fused_draw", "W=32 zero rows", a, b, th_c, ph, d, wz, u, False)
    if int(a.min()) < 0 or int(a.max()) >= K:
        raise AssertionError("zero-row chunk drew an index outside [0, K)")
    return tally, (d, w, u, u4)


def chunk_weights(th, ph, d, w):
    """The (C*N, K) weights of one chunk, as the sweep forms them."""
    return (th[d.long()] * ph[w.long()]).contiguous()


def check_table(tally, case, wts, W, exact):
    """K1 in both layouts against its plain version; the sweep pads K to a
    multiple of W as ``core.butterfly._prep`` does."""
    wp, _ = bfly.pad_to_multiple(wts, axis=1, mult=W)
    for layout in KT.LAYOUTS:
        got = KT.butterfly_table_cuda(wp, W, layout)
        want = KT.butterfly_table_torch(wp, W, layout)
        if layout == "rows":
            got, want = rows_to_blocks(got, W), rows_to_blocks(want, W)
        tally.table("butterfly_table", f"{case} {layout}", got, want, W, exact)


def phase_given_kernels(corpus, dev, seed: int, tally, inputs):
    """K1-K4 against their plain versions on the chunk's given weights."""
    d, w, u, u4 = inputs
    K, V, C = CONFIG.K, corpus.vocab_size, 256
    B = d.numel()
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    log(f"phase 2b: given-weight kernels vs plain at B={B} x K={K}")
    for W in (32, 16):
        for kind in ("int", "dirichlet"):
            exact = kind == "int"
            wts = chunk_weights(*factors(kind, C, V, K, g, dev), d, w)
            case = f"W={W} {kind}"
            check_table(tally, case, wts, W, exact)
            plain = bops.butterfly_sample(wts, u, W=W, impl="torch")
            tally.weights("fused_draw", case, bops.butterfly_sample(wts, u, W=W, route="fused"),
                          plain, wts, u, exact)
            two = bops.butterfly_sample(wts, u, W=W, route="two_pass")
            tally.weights("walk", case + " two-pass route", two, plain, wts, u, exact)
            _, run = bops.build_block_sums(wts, W=W)
            _, run_p = bops.build_block_sums(wts, W=W, impl="torch")
            tally.running("blocksums", case, run, run_p, exact)
            for S, uu in ((1, u), (4, u4)):
                a = bops.butterfly_sample_from_sums(wts, run, uu, K=K, W=W)
                b = bops.butterfly_sample_from_sums(wts, run, uu, K=K, W=W, impl="torch")
                tally.weights("walk", f"{case} S={S}", a, b, wts, uu, exact)
    for W in (8, 4):
        check_table(tally, f"W={W} int", chunk_weights(*factors("int", C, V, K, g, dev), d, w),
                    W, True)
    # bf16 weights (the integer products are integers in bf16 too)
    wb = chunk_weights(*factors("int", C, V, K, g, dev), d, w).to(torch.bfloat16)
    check_table(tally, "W=16 bf16", wb, 16, True)
    for route in ("fused", "two_pass"):
        tally.weights("fused_draw" if route == "fused" else "walk", f"W=16 bf16 {route}",
                      bops.butterfly_sample(wb, u, W=16, route=route),
                      bops.butterfly_sample(wb, u, W=16, impl="torch"), wb.float(), u, True)
    # the sweep's last chunk: padded with all-zero rows
    th, ph = factors("dirichlet", corpus.docs.shape[0], V, K, g, dev)
    docs = torch.as_tensor(corpus.docs, device=dev)
    *_, (start, end, th_c, docs_p) = gibbs._chunks(th, docs, C)
    wz = chunk_weights(th_c, ph, d, docs_p.reshape(-1))
    zero = d >= end - start
    for route in ("fused", "two_pass"):
        a = bops.butterfly_sample(wz, u, W=16, route=route)
        b = bops.butterfly_sample(wz, u, W=16, impl="torch")
        tally.weights("fused_draw" if route == "fused" else "walk", f"W=16 zero rows {route}",
                      a, b, wz, u, False)
        if int(a.min()) < 0 or int(a.max()) >= K or not bool((a[zero] == K - 1).all()):
            raise AssertionError("zero-row chunk drew outside [0, K) or not K-1")
    check_table(tally, "W=16 zero rows", wz, 16, False)
    # a large K: the port's switch picks the route; the forced two-pass
    # route must agree with it
    Kl, Bl = 32000, 64
    Wl = runtime.default_w(Kl)
    nbl = KB.num_blocks(Kl, Wl)
    wl = torch._standard_gamma(torch.full((Bl, Kl), 0.3, device=dev), generator=g)
    ul = torch.rand(Bl, generator=g, device=dev)
    route = "fused" if KB.fused_fits(nbl, Wl) else "two_pass"
    log(f"  K={Kl} B={Bl} W={Wl}: the switch picks the {route} route")
    a = bops.butterfly_sample(wl, ul, W=Wl)
    tally.weights("fused_draw" if route == "fused" else "walk", f"K={Kl} W={Wl} {route}",
                  a, bops.butterfly_sample(wl, ul, W=Wl, impl="torch"), wl, ul, False)
    if not torch.equal(a, bops.butterfly_sample(wl, ul, W=Wl, route="two_pass")):
        raise AssertionError(f"K={Kl}: the fused and two-pass routes disagree")
    if not torch.equal(bops.butterfly_sample(wts, u, W=16, route="fused"),
                       bops.butterfly_sample(wts, u, W=16, route="two_pass")):
        raise AssertionError("the fused and two-pass routes disagree on the chunk")
    return tally


def bounds(name, th, ph, d, w, out_idx, W, nb, S=1):
    """Least bytes / flops for one call on this run's data (each input
    row read once, each output written once) -> (bound_ms, bound_by)."""
    K = th.shape[1]
    el = th.element_size()
    ids = d.numel() * 4 * 2
    if name == "lda_walk":
        blk = (out_idx.long().reshape(-1) // W)
        dd, ww = d.long().repeat(S), w.long().repeat(S)
        tb = torch.unique(dd * nb + blk).numel() * W * el
        pb = torch.unique(ww * nb + blk).numel() * W * el
        nbytes = tb + pb + d.numel() * nb * 4 + S * d.numel() * (4 + 4 * 3 + 4)
        flops = S * d.numel() * (3 * W + nb)
    else:
        rows = (torch.unique(d).numel() + torch.unique(w).numel()) * K * el
        outb = d.numel() * (nb * 4 if name == "lda_blocksums" else 4)
        ub = d.numel() * 4 if name == "lda_fused_draw" else 0
        nbytes = rows + ids + ub + outb
        flops = d.numel() * 2 * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(calls):
    """CUDA-event times of each kernel (the faster of two runs, taken
    around its plain version's), its plain version and, where given, its
    one-call library counterpart, with the bound for this call's work.
    ``calls``: name -> (kernel, plain, library or None, bound(out))."""
    out = {}
    for name, (kern, plain, lib, bound) in calls.items():
        ms = cuda_ms(kern)
        pms = cuda_ms(plain, reps=5, warmup=1)
        lms = cuda_ms(lib) if lib else None
        ms2 = cuda_ms(kern)
        bms, by = bound(kern())
        out[name] = {"ms": min(ms, ms2), "plain_ms": pms, "bound_ms": bms,
                     "bound_by": by, "library_ms": lms}
        log(f"  {name:15s} kernel {ms:.4f}/{ms2:.4f} ms  plain {pms:.4f} ms  "
            f"library {lms} ms  bound {bms * 1e3:.2f} us ({by})")
    return out


def phase_timing(corpus, dev, seed, inputs):
    """K6-K8 at the lda_kernel path's W=32 shapes (Dirichlet factors);
    K7 with S=4 draws per sample."""
    d, w, u, u4 = inputs
    K, V, C, W = CONFIG.K, corpus.vocab_size, 256, 32
    nb = -(-K // W)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    th, ph = factors("dirichlet", C, V, K, g, dev)
    Bt = d.numel()
    S = 4
    run = KL.lda_blocksums(th, ph, d, w, W, nb)
    rows4 = torch.arange(Bt, dtype=torch.int32, device=dev).repeat(S)
    d4, w4, uf = d.repeat(S), w.repeat(S), u4.reshape(-1).contiguous()

    def bound(name, s=1):
        return lambda idx: bounds(name, th, ph, d, w, idx, W, nb, S=s)

    return time_kernels({
        "lda_fused_draw": (lambda: KL.lda_fused_draw(th, ph, d, w, u, W),
                           lambda: KL.lda_fused_draw_torch(th, ph, d, w, u, W), None,
                           bound("lda_fused_draw")),
        "lda_blocksums": (lambda: KL.lda_blocksums(th, ph, d, w, W, nb),
                          lambda: KL.lda_blocksums_torch(th, ph, d, w, W, nb), None,
                          bound("lda_blocksums")),
        "lda_walk": (lambda: KL.lda_walk(th, ph, run, uf, rows4, d4, w4, W),
                     lambda: KL.lda_walk_torch(th, ph, run, uf, rows4, d4, w4, W), None,
                     bound("lda_walk", S)),
    })


def given_bounds(name, wts, W, nb, out_idx, rows):
    """Least bytes / flops of one given-weights kernel call on this run's
    data -> (bound_ms, bound_by).  Each input row read once, each output
    written once; K3 reads only the W-blocks and running rows it uses."""
    B, K = wts.shape
    el = wts.element_size()
    if name == "butterfly_table":
        nbytes = B * K * (el + 4)
        flops = B * K // 2 * (W.bit_length() - 1) + B * nb
    elif name == "blocksums":
        nbytes = B * K * el + B * nb * 4
        flops = B * K + B * nb
    elif name == "fused_draw":
        nbytes = B * K * el + B * 8
        flops = B * (K + nb + W + W.bit_length())
    else:  # walk: S draws per row through ``rows``
        r = rows.long()
        blk = out_idx.long() // W
        nbytes = (torch.unique(r * nb + blk).numel() * W * el
                  + torch.unique(r).numel() * nb * 4 + r.numel() * 12)
        flops = r.numel() * (nb + W + W.bit_length())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_given_timing(corpus, dev, seed, inputs):
    """K1-K4 at the butterfly and kernel sweeps' shapes: one chunk's
    Dirichlet weights, W=16 (the reference's default_w(240)); K3 with S=4
    draws per row.  K2's library counterpart is PyTorch's per-block sum
    then running sum."""
    d, w, u, u4 = inputs
    K, V, C, W = CONFIG.K, corpus.vocab_size, 256, 16
    nb = KB.num_blocks(K, W)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    wts = chunk_weights(*factors("dirichlet", C, V, K, g, dev), d, w)
    B, S = wts.shape[0], 4
    run = KB.blocksums(wts, W, nb)
    rows4 = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
    uf = u4.reshape(-1).contiguous()

    def bound(name):
        return lambda idx: given_bounds(name, wts, W, nb, idx, rows4)

    return time_kernels({
        "butterfly_table": (lambda: KT.butterfly_table_cuda(wts, W, "blocks"),
                            lambda: KT.butterfly_table_torch(wts, W, "blocks"), None,
                            bound("butterfly_table")),
        "blocksums": (lambda: KB.blocksums(wts, W, nb),
                      lambda: KB.blocksums_torch(wts, W, nb),
                      lambda: torch.cumsum(wts.view(B, nb, W).sum(-1), dim=1),
                      bound("blocksums")),
        "walk": (lambda: KB.walk(wts, run, uf, rows4, W),
                 lambda: KB.walk_torch(wts, run, uf, rows4, W), None, bound("walk")),
        "fused_draw": (lambda: KB.fused_draw(wts, u, W),
                       lambda: KB.fused_draw_torch(wts, u, W), None, bound("fused_draw")),
    })


def sweep_seconds(state, corpus, method, W, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(state, corpus, method=method, W=W, chunk=256)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times


def check_path(path, counts, expect):
    """Fail unless each kernel of ``expect`` was launched exactly as often
    as expected on the path just run."""
    log(f"  launches on the {path} path: "
        f"{ {n: c for n, c in counts.items() if c} }")
    for name, n in expect.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{path}: {name} launched {counts[name]}x, expected {n}x")


def check_state(state, K, *zs):
    rows = state.theta.sum(dim=1)
    if not torch.allclose(rows, torch.ones_like(rows), atol=1e-4):
        raise AssertionError("theta rows do not sum to 1")
    for z in (state.z, *zs):
        if int(z.min()) < 0 or int(z.max()) >= K:
            raise AssertionError("a topic outside [0, K)")


def phase_main(corpus, dev, seed):
    K, M, chunk, W = CONFIG.K, corpus.docs.shape[0], 256, 32
    nchunks = -(-M // chunk)
    log(f"phase 3: main path, M={M} V={corpus.vocab_size} K={K} "
        f"tokens={corpus.total_words} maxN={corpus.docs.shape[1]} chunks={nchunks}")
    state = gibbs.init_state(seed, corpus, K, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, times = sweep_seconds(state, corpus, "lda_kernel", W, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = gibbs.sample_z(state, corpus, num_samples=4, W=W, chunk=chunk)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_path("lda_kernel", launches, {"lda_fused_draw": 3 * nchunks,
                                        "lda_blocksums": nchunks, "lda_walk": nchunks})
    check_state(state, K, zs)
    ppl = gibbs.perplexity(state, corpus)
    if not np.isfinite(ppl):
        raise AssertionError("perplexity is not finite")
    log(f"  seconds per sweep (lda_kernel, W={W}): {times}")
    log(f"  sample_z (4 draws/token): {t_sample:.4f} s   perplexity {ppl:.2f}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    return state, launches, {"sweep_s": times, "sample_z_s": t_sample,
                             "perplexity": ppl, "peak_bytes": peak,
                             "tokens": corpus.total_words}


def phase_table_paths(state, corpus, dev, seed):
    """The paths this slice brings, at the same scale, from the
    lda_kernel path's last state: 3 ``butterfly`` sweeps (K1 per chunk),
    3 ``kernel`` sweeps (K2 + K3 per chunk), then the given-weights entry
    points over every chunk (K4, then K2 + K3 with 4 draws per token)."""
    K, M, chunk = CONFIG.K, corpus.docs.shape[0], 256
    W = runtime.default_w(K)
    nchunks = -(-M // chunk)
    res, launches = {}, {}
    for method, expect in (("butterfly", {"butterfly_table": 3 * nchunks}),
                           ("kernel", {"blocksums": 3 * nchunks, "walk": 3 * nchunks})):
        torch.cuda.synchronize()
        reset_counts()
        state, times = sweep_seconds(state, corpus, method, None, 3)
        counts = read_counts()
        check_path(method, counts, expect)
        check_state(state, K)
        ppl = gibbs.perplexity(state, corpus)
        if not np.isfinite(ppl):
            raise AssertionError(f"{method}: perplexity is not finite")
        log(f"  seconds per sweep ({method}, W={W}): {times}   perplexity {ppl:.2f}")
        res[method] = {"sweep_s": times, "perplexity": ppl, "launches": counts}
        for name, n in expect.items():
            launches[name] = launches.get(name, 0) + n
    # the given-weights entry points, one chunk's weights at a time
    docs = torch.as_tensor(corpus.docs, device=dev)
    maxN = docs.shape[1]
    z1 = torch.empty((M, maxN), dtype=torch.int32, device=dev)
    z4 = torch.empty((4, M, maxN), dtype=torch.int32, device=dev)
    pair = np.array([seed, 12345], np.uint32)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for start, end, theta_c, docs_c in gibbs._chunks(state.theta, docs, chunk):
        C, N = docs_c.shape
        wts = (theta_c[:, None, :] * state.phi[docs_c.long()]).reshape(C * N, K)
        u = torch.rand(C * N, generator=state.key, device=dev)
        z1[start:end] = bops.butterfly_sample(wts, u, W=W).view(C, N)[: end - start]
        wp, run = bops.build_block_sums(wts, W=W)
        zs = bops.butterfly_sample_from_sums_rng(wp, run, pair, B=C * N, K=K, S=4,
                                                 row_offset=start * N, W=W)
        z4[:, start:end] = zs.view(4, C, N)[:, : end - start]
    torch.cuda.synchronize()
    t_given = time.perf_counter() - t0
    counts = read_counts()
    expect = {"fused_draw": nchunks, "blocksums": nchunks, "walk": nchunks}
    check_path("given-weights", counts, expect)
    check_state(state, K, z1, z4)
    log(f"  given-weights entry points over {nchunks} chunks (1 + 4 draws/token): "
        f"{t_given:.4f} s")
    res["given_weights"] = {"seconds": t_given, "launches": counts}
    for name, n in expect.items():
        launches[name] = launches.get(name, 0) + n
    return state, launches, res


def phase_profile(state, corpus, method, W):
    """One more sweep of ``method`` under torch.profiler (after the
    counted runs): device time by kernel and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(state, corpus, method=method, W=W, chunk=256)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an aten op's row repeats the device time of its kernels
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"phase 3c: profiled {method} sweep wall {wall:.4f} s, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}%)")
    for us, n, key in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    return state, {"wall_s": wall, "device_busy_s": busy,
                   "top": [{"ms": us / 1e3, "count": n, "name": key[:120]}
                           for us, n, key in rows[:10]]}


def phase_fig3(corpus, dev, seed):
    log("phase 3b: Figure-3 K-sweep (1 warm-up + 2 timed sweeps each, W=default_w(K)), "
        "printed only")
    rows = []
    for K in range(16, 241, 32):
        for method in ("lda_kernel", "butterfly", "kernel", "prefix"):
            state = gibbs.init_state(seed, corpus, K, device=dev)
            state, _ = sweep_seconds(state, corpus, method, None, 1)
            state, t = sweep_seconds(state, corpus, method, None, 2)
            row = {"K": K, "method": method, "sweep_s": t}
            rows.append(row)
            log("  fig3 " + json.dumps(row))
            del state
    return rows


def phase_planted(dev, seed):
    corpus = corpus_mod.synthesize_corpus(seed=0, M=96, V=120, K=8, avg_len=40, max_len=80)
    state = gibbs.init_state(seed, corpus, 8, device=dev)
    p0 = gibbs.perplexity(state, corpus)
    for _ in range(30):
        state = gibbs.gibbs_step(state, corpus, method="lda_kernel", W=8)
    p1 = gibbs.perplexity(state, corpus)
    log(f"phase 4: planted corpus perplexity {p0:.3f} -> {p1:.3f} after 30 sweeps")
    if not (np.isfinite(p1) and p1 < 0.6 * p0):
        raise AssertionError(f"planted corpus: perplexity {p0} -> {p1}, not below 0.6x")
    return {"p0": p0, "p1": p1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="write every result as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels run only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 1: kernels built in {build_s:.2f} s")
    for name, text in _build.build_log.items():
        log(f"  nvcc {name}:\n" + "\n".join("    " + x for x in text.strip().splitlines()))

    t0 = time.perf_counter()
    corpus = paper_corpus(args.seed, CONFIG.M, CONFIG.V)
    log(f"corpus built in {time.perf_counter() - t0:.2f} s")
    tally, inputs = phase_kernels(corpus, dev, args.seed)
    phase_given_kernels(corpus, dev, args.seed, tally, inputs)
    log("phase 2c: kernel times (CUDA events)")
    timing = phase_timing(corpus, dev, args.seed, inputs)
    timing.update(phase_given_timing(corpus, dev, args.seed, inputs))
    dev_corpus = corpus_mod.Corpus(
        docs=torch.as_tensor(corpus.docs, device=dev),
        lengths=corpus.lengths,
        mask=torch.as_tensor(corpus.mask, device=dev),
        vocab_size=corpus.vocab_size,
    )
    state, lda_counts, main_res = phase_main(dev_corpus, dev, args.seed)
    state, launches, main_res["table_paths"] = phase_table_paths(
        state, dev_corpus, dev, args.seed)
    launches.update({n: lda_counts[n] for n in ("lda_fused_draw", "lda_blocksums",
                                                 "lda_walk")})
    main_res["profile"] = {}
    for method, W in (("lda_kernel", 32), ("butterfly", None), ("kernel", None)):
        state, main_res["profile"][method] = phase_profile(state, dev_corpus, method, W)
    del state
    fig3 = phase_fig3(dev_corpus, dev, args.seed)
    planted = phase_planted(dev, args.seed)

    kernels = []
    for name, (kid, src, replaces, _) in KERNELS.items():
        t, tm = tally.t[name], timing[name]
        kernels.append({
            "name": name, "id": kid, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm.get("library_ms"), "bound_us": tm["bound_ms"] * 1e3,
            "mismatches": t["mismatches"], "ties": t["ties"], "cases": t["cases"],
        })
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "build_s": build_s, "kernels": kernels, "main": main_res,
            "fig3": fig3, "planted": planted, "tally": tally.t,
        }, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
