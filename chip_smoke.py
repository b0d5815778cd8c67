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
   B=64.  K1 also at W=64 and W=128 (integer, Dirichlet, bf16).  The
   truncated draws (phase 2d): K9, K11 and K12 (S=1 and S=4) and both
   routes forced, at (8, 256000), (64, 256000), (64, 128256) and (24, 300);
   integer and peaked-softmax weights, bf16, zero rows, gemma2-9b's and
   per-row params with disabled stages; real-weight mismatches are ties
   only where float64 shows them within the rounding of sums as deep as
   the card's (``butterfly_sample.ref.cuda_sum_depth``).  The alias
   assembly (phase 2e):
   K13 at phi (37,286 x 240) and (64, 4096), alias positions equal, prob
   within ``alias_build.ref.prob_tolerance``, and the induced mass of the
   device build.  Each kernel and its plain version are timed with CUDA
   events (and, where one PyTorch computation does the same work, its
   library yardstick); the truncated routes end to end at (64, 256000),
   and K9 with its rows staged in shared memory against rows read from
   L2 at (64, 32000) and (64, 56000).
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
5. The sampling API, each path with the launch counts set to 0 just
   before it and read just after: decode at gemma2-9b's width, 20 steps of
   ``plan((64, 256000), method="kernel", transforms="kp").sample_logits``
   with top-k 64 / top-p 0.95, then per-row params (K9 once per step),
   then four tokens per row (K11 and K12 once per step), and the same at a
   32,000-token vocabulary; ``sample_from_logits`` at (64, 256000) once
   per explicit method (``alias`` at (64, 4096)), including ``butterfly``
   (K1 at W=128) and ``alias_device`` (K13 at Kp=262,144); the butterfly
   ``Categorical`` at (64, 256000) against its plain table;
   ``Categorical.from_weights(phi, method="alias_device")`` with 16 draws
   per row and its induced mass; one paper-scale sweep each with
   ``gumbel`` and ``alias``.

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

from repro_torch import sampling  # noqa: E402
from repro_torch.configs import gemma2_9b  # noqa: E402
from repro_torch.configs.lda import CONFIG  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import butterfly as bfly  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.alias_build import kernel as KA  # noqa: E402
from repro_torch.kernels.alias_build import ops as aops  # noqa: E402
from repro_torch.kernels.alias_build.ref import prob_tolerance  # noqa: E402
from repro_torch.kernels.butterfly_sample import kernel as KB  # noqa: E402
from repro_torch.kernels.butterfly_sample import ops as bops  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import boundary_ties as weight_ties  # noqa: E402
from repro_torch.kernels.butterfly_sample.ref import (  # noqa: E402
    cuda_sum_depth, trunc_boundary_ties)
from repro_torch.kernels.butterfly_table import kernel as KT  # noqa: E402
from repro_torch.kernels.lda_draw import kernel as KL  # noqa: E402
from repro_torch.kernels.lda_draw import ops  # noqa: E402
from repro_torch.kernels.lda_draw.ref import boundary_ties  # noqa: E402
from repro_torch.lda import corpus as corpus_mod  # noqa: E402
from repro_torch.lda import gibbs  # noqa: E402
from repro_torch.sampling import reference as sref  # noqa: E402
from repro_torch.sampling import transforms as tr  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
_CSRC = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
_TPU = "src/repro/kernels/{}/kernel.py:{}"
_TRUNC_SRC = "src/repro_torch/kernels/butterfly_sample/csrc/butterfly_trunc.cu"
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
    "fused_trunc_draw": ("K9", _TRUNC_SRC, _TPU.format("butterfly_sample", 389),
                         KB.LAUNCHES),
    "masked_blocksums": ("K11", _TRUNC_SRC, _TPU.format("butterfly_sample", 484),
                         KB.LAUNCHES),
    "walk_trunc": ("K12", _TRUNC_SRC, _TPU.format("butterfly_sample", 522), KB.LAUNCHES),
    "alias_assemble": ("K13", _CSRC.format("alias_build"), _TPU.format("alias_build", 115),
                       KA.LAUNCHES),
}
# decode widths: gemma2-9b's vocabulary (top-k 64, top-p 0.95), whose
# rows K9 reads from L2, and the 32,000-token vocabulary of the repo's
# arctic-480b config (the llama-2 tokenizer's), whose rows K9 stages in
# shared memory
DECODE_B = 64
DECODE_VOCABS = (gemma2_9b.VOCAB_SIZE, 32000)


def reset_counts() -> None:
    for mod in (KT, KB, KL, KA):
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

    def running(self, name, case, a, b, exact: bool, rel_tol=240 * 2.0 ** -23):
        t = self.t[name]
        t["cases"] += 1
        err = float((a - b).abs().max())
        rel = err / max(float(b.abs().max()), 1e-30)
        log(f"  {name:15s} {case:34s} max_abs_err={err:.3g} rel={rel:.3g}")
        if exact and err:
            raise AssertionError(f"{name} running sums differ on integer weights: {err}")
        if rel > rel_tol:
            raise AssertionError(f"{name} running sums off by {rel:.3g} relative")
        if exact:
            t["max_abs_err"] = max(t["max_abs_err"], err)

    def trunc(self, name, case, a, b, wts, u, params, exact: bool):
        """Truncated draws from given weights (float64 tau and stop ties,
        with the rounding of sums as deep as the card's)."""
        res = trunc_boundary_ties(a, b, wts, u, params, depth=cuda_sum_depth(wts.shape[1]))
        self._indices(name, case, a, b, res, exact)

    def assemble(self, name, case, got, want, tol):
        """K13: alias positions equal, prob within ``tol``."""
        t = self.t[name]
        t["cases"] += 1
        mis = int((got[1] != want[1]).sum())
        err = float((got[0] - want[0]).abs().max())
        log(f"  {name:15s} {case:34s} apos mismatches={mis} prob max_abs_err={err:.3g} "
            f"(bound {tol:.3g})")
        if mis or err > tol:
            raise AssertionError(f"{name} disagrees with its plain version: {case}")
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
    for W in (8, 4, 64, 128):
        check_table(tally, f"W={W} int", chunk_weights(*factors("int", C, V, K, g, dev), d, w),
                    W, True)
    check_table(tally, "W=128 dirichlet", chunk_weights(*factors("dirichlet", C, V, K, g,
                                                                 dev), d, w), 128, False)
    # bf16 weights (the integer products are integers in bf16 too)
    wb = chunk_weights(*factors("int", C, V, K, g, dev), d, w).to(torch.bfloat16)
    check_table(tally, "W=16 bf16", wb, 16, True)
    check_table(tally, "W=128 bf16", wb, 128, True)
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
    as expected on the path just run, and no other kernel was."""
    log(f"  launches on the {path} path: "
        f"{ {n: c for n, c in counts.items() if c} }")
    for name, n in expect.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{path}: {name} launched {counts[name]}x, expected {n}x")
    extra = {n: c for n, c in counts.items() if c and n not in expect}
    if extra:
        raise AssertionError(f"{path}: unexpected launches {extra}")


def add_counts(total: dict, counts: dict) -> None:
    """Add the launch counts read after one path to the run's totals."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


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
        add_counts(launches, counts)
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
    add_counts(launches, counts)
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


# ---------------------------------------------------------------------------
# Truncated draws (K9, K11, K12), the alias assembly (K13) and the sampling API
# ---------------------------------------------------------------------------


def trunc_weights(kind: str, B: int, K: int, g: torch.Generator, dev, zero_rows=()):
    """(B, K) weights: integers in [1, 100) (every fp32 sum exact while the
    row total stays below 2**24) or a peaked softmax of N(0, 4^2) logits."""
    if kind == "int":
        w = torch.randint(1, 100, (B, K), generator=g, device=dev).float()
    else:
        z = 4.0 * torch.randn((B, K), generator=g, device=dev)
        w = torch.exp(z - z.max(dim=1, keepdim=True).values)
    for r in zero_rows:
        w[r] = 0
    return w.contiguous()


def trunc_params(kind: str, B: int, g: torch.Generator, dev) -> torch.Tensor:
    """(B, 3) [top_k, top_p, min_p]: gemma2-9b's (64, 0.95, 0) on every row,
    or per-row values with row r % 4 disabling top-k, top-p, min-p, or all
    three."""
    if kind == "uniform":
        s = gemma2_9b.SAMPLER
        return torch.tensor([[float(s.top_k), s.top_p, s.min_p]], device=dev).repeat(B, 1)
    k = torch.randint(1, 200, (B,), generator=g, device=dev).float()
    p = 0.5 + 0.5 * torch.rand((B,), generator=g, device=dev)
    m = 0.05 * torch.rand((B,), generator=g, device=dev)
    r = torch.arange(B, device=dev) % 4
    k = torch.where((r == 0) | (r == 3), 0.0, k)
    p = torch.where((r == 1) | (r == 3), 1.0, p)
    m = torch.where((r == 2) | (r == 3), 0.0, m)
    return torch.stack([k, p, m], dim=1).contiguous()


def phase_trunc_kernels(dev, seed: int, tally):
    """K9, K11 and K12 against their plain versions: (8, 256000) (the serve
    batch of the reference's ServeSpec.max_slots), (64, 256000), (64,
    128256) (llama3-8b's vocabulary) and (24, 300); integer and
    peaked-softmax weights, bf16, zero rows, gemma2-9b's and per-row
    params, both routes forced, K12 with S=1 and S=4."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    log("phase 2d: truncated-draw kernels vs plain (K9, K11, K12)")
    cases = [(8, 256000, "int", "uniform", torch.float32, (0, 5)),
             (64, 256000, "softmax", "uniform", torch.float32, ()),
             (64, 256000, "softmax", "hetero", torch.float32, (7,)),
             (64, 128256, "int", "hetero", torch.float32, ()),
             (64, 128256, "softmax", "uniform", torch.bfloat16, ()),
             (24, 300, "int", "hetero", torch.float32, (3,)),
             (24, 300, "softmax", "hetero", torch.float32, ())]
    for B, K, kind, pk, dtype, zero in cases:
        W = runtime.default_w(K)
        nb = KB.num_blocks(K, W)
        w = trunc_weights(kind, B, K, g, dev, zero).to(dtype)
        prm = trunc_params(pk, B, g, dev)
        u = torch.rand(B, generator=g, device=dev)
        exact = kind == "int"
        case = f"({B},{K}) W={W} {kind} {pk} {str(dtype)[6:]}"
        a = KB.fused_trunc_draw(w, u, prm, W)
        b = KB.fused_trunc_draw_torch(w, u, prm, W)
        tally.trunc("fused_trunc_draw", case, a, b, w, u, prm, exact)
        if zero and not bool((a[list(zero)].clamp(max=K - 1) == K - 1).all()):
            raise AssertionError(f"{case}: an all-zero row did not draw K-1")
        tau = tr.thresholds_from_params(w, prm).contiguous()
        run = KB.masked_blocksums(w, tau, W, nb)
        tally.running("masked_blocksums", case, run, KB.masked_blocksums_torch(w, tau, W, nb),
                      exact, rel_tol=(W + nb) * 2.0 ** -23)
        wm = KB._mask(w.float(), tau)
        for S in (1, 4):
            us = torch.rand((S, B), generator=g, device=dev)
            rows = torch.arange(B, dtype=torch.int32, device=dev).repeat(S)
            uf = us.reshape(-1).contiguous()
            tally.weights("walk_trunc", f"{case} S={S}", KB.walk_trunc(w, run, uf, tau, rows, W),
                          KB.walk_trunc_torch(w, run, uf, tau, rows, W), wm, uf, exact)
        # both routes forced through the entry point
        fused = bops.butterfly_sample_truncated(w, u, prm, W=W, route="fused")
        two = bops.butterfly_sample_truncated(w, u, prm, W=W, route="two_pass")
        tally.trunc("fused_trunc_draw", case + " fused vs two-pass", fused, two, w, u, prm,
                    exact)
        if int(fused.min()) < 0 or int(fused.max()) >= K:
            raise AssertionError(f"{case}: an index outside [0, K)")
    return tally


def induced_mass_err(w, prob, alias) -> float:
    """max |mass - w / sum(w)| of a (prob, alias) table, in float64 on the
    card: mass[c] = (prob[c] + sum_{alias[k]=c} (1 - prob[k])) / K."""
    p = prob.double()
    K = p.shape[1]
    mass = p.clone().scatter_add_(1, alias.long(), 1.0 - p) / K
    wd = w.double()
    tot = wd.sum(dim=1, keepdim=True)
    target = torch.where(tot > 0, wd / tot.clamp(min=1e-300), torch.full_like(wd, 1.0 / K))
    return float((mass - target).abs().max())


def phase_alias_kernels(dev, seed: int, tally, phi):
    """K13 against its plain version at phi (V x K = 37,286 x 240, Kp = 256)
    and at (64, 4096) peaked-softmax weights; the induced mass of the full
    device build against the weights."""
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    log("phase 2e: alias assembly (K13) vs plain")
    for case, w in (("phi 37286x240", phi), ("(64,4096) softmax",
                                            trunc_weights("softmax", 64, 4096, g, dev))):
        s_sorted, _order, _inv, nL = aops._partition(w)
        K = w.shape[1]
        Kp = aops._next_pow2(K)
        sp = torch.nn.functional.pad(s_sorted, (0, Kp - K), value=1.0).contiguous()
        rank = aops._merged_rank(sp, nL).contiguous()
        got = KA.alias_assemble(sp, nL, rank)
        tally.assemble("alias_assemble", case, got, KA.alias_assemble_torch(sp, nL, rank),
                       prob_tolerance(Kp))
        t = aops.build_alias_tables_device(w)
        err = induced_mass_err(w, t.prob, t.alias)
        log(f"  alias_device {case}: induced mass max_abs_err={err:.3g}")
        if err > 5e-6:
            raise AssertionError(f"alias_device {case}: induced mass off by {err}")
    return tally


def trunc_bounds(name, w, W, nb, S=1):
    """Least bytes / operations of one truncated-draw kernel call on this
    run's data -> (bound_ms, bound_by).  K9: the weights, u and params read
    once and the draws written once; the function's operations (the max, a
    threshold select, the mask, the draw: a few per weight) take far less
    time than the bytes.  The 66 passes over a row of its bisection are
    this kernel's algorithm, not work the function needs: a radix select
    finds the same tau in 4 passes."""
    B, K = w.shape
    el = w.element_size()
    if name == "fused_trunc_draw":
        nbytes = B * K * el + B * (4 + 12 + 4)
        flops = 4 * B * K
    elif name == "masked_blocksums":
        nbytes = B * K * el + B * 4 + B * nb * 4
        flops = 2 * B * K + B * nb
    else:  # walk_trunc: one running row and one W-block per draw
        nbytes = B * nb * 4 + S * B * (W * el + 4 * 4)
        flops = S * B * (nb + 3 * W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_new_timing(dev, seed, phi):
    """K9 (forced fused), K11 and K12 (S=1) at (64, 256000), W = default_w;
    K13 at phi (37,286 x 256); K1 at (128, 256000), W=128 (the butterfly
    state of 64 rows, padded to a group of 128).  Library yardsticks: the
    sort-based truncated draw (several calls) for K9, where + view-sum +
    cumsum for K11."""
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    B, K = DECODE_B, gemma2_9b.VOCAB_SIZE
    W = runtime.default_w(K)
    nb = KB.num_blocks(K, W)
    w = trunc_weights("softmax", B, K, g, dev)
    prm = trunc_params("uniform", B, g, dev)
    u = torch.rand(B, generator=g, device=dev)
    tau = tr.thresholds_from_params(w, prm).contiguous()
    run = KB.masked_blocksums(w, tau, W, nb)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    chain = (sampling.TopK(prm[:, 0]), sampling.TopP(prm[:, 1]))
    out = time_kernels({
        "fused_trunc_draw": (lambda: KB.fused_trunc_draw(w, u, prm, W),
                             lambda: KB.fused_trunc_draw_torch(w, u, prm, W),
                             lambda: sref.draw_truncated_sorted(w, u, chain),
                             lambda idx: trunc_bounds("fused_trunc_draw", w, W, nb)),
        "masked_blocksums": (lambda: KB.masked_blocksums(w, tau, W, nb),
                             lambda: KB.masked_blocksums_torch(w, tau, W, nb),
                             lambda: torch.cumsum(torch.where(w >= tau[:, None], w, 0.0)
                                                  .view(B, nb, W).sum(-1), dim=1),
                             lambda idx: trunc_bounds("masked_blocksums", w, W, nb)),
        "walk_trunc": (lambda: KB.walk_trunc(w, run, u, tau, rows, W),
                       lambda: KB.walk_trunc_torch(w, run, u, tau, rows, W), None,
                       lambda idx: trunc_bounds("walk_trunc", w, W, nb)),
    })
    # the two routes end to end, and tau in PyTorch alone
    routes = {
        "fused (K9)": lambda: bops.butterfly_sample_truncated(w, u, prm, W=W, route="fused"),
        "two-pass (tau + K11 + K12)": lambda: bops.butterfly_sample_truncated(
            w, u, prm, W=W, route="two_pass"),
        "tau (plain PyTorch)": lambda: tr.thresholds_from_params(w, prm),
    }
    out["routes"] = {}
    for name, fn in routes.items():
        ms = cuda_ms(fn, reps=5, warmup=1)
        out["routes"][name] = ms
        log(f"  ({B},{K}) {name:28s} {ms:.4f} ms")
    # K9's two row sources where a row fits shared memory
    for Ks in (32000, 56000):
        ws = trunc_weights("softmax", B, Ks, g, dev)
        Ws = runtime.default_w(Ks)
        for staged in (True, False, False, True):
            ms = cuda_ms(lambda: KB._fused_trunc_draw(ws, u, prm, Ws, 32, staged))
            key = f"fused (K9) at ({B},{Ks}) row {'staged' if staged else 'from L2'}"
            out["routes"].setdefault(key, []).append(ms)
            log(f"  {key} {ms:.4f} ms")
    # K13 at phi
    s_sorted, _o, _i, nL = aops._partition(phi)
    Kp = aops._next_pow2(phi.shape[1])
    sp = torch.nn.functional.pad(s_sorted, (0, Kp - phi.shape[1]), value=1.0).contiguous()
    rank = aops._merged_rank(sp, nL).contiguous()
    nbytes = sp.numel() * 16 + nL.numel() * 4
    out.update(time_kernels({
        "alias_assemble": (lambda: KA.alias_assemble(sp, nL, rank),
                           lambda: KA.alias_assemble_torch(sp, nL, rank), None,
                           lambda _: (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")),
    }))
    # K1 at W=128 on the butterfly state's (128, 256000)
    wt = trunc_weights("softmax", 128, K, g, dev)
    t1 = {"ms": cuda_ms(lambda: KT.butterfly_table_cuda(wt, 128, "blocks")),
          "plain_ms": cuda_ms(lambda: KT.butterfly_table_torch(wt, 128, "blocks"), reps=3,
                              warmup=1),
          "bound_ms": 128 * K * 8 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"  butterfly_table W=128 (128,{K}) kernel {t1['ms']:.4f} ms  plain "
        f"{t1['plain_ms']:.4f} ms  bound {t1['bound_ms'] * 1e3:.2f} us (bytes)")
    out["butterfly_table_w128"] = t1
    return out


def step_seconds(fn, n: int):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_decode(dev, seed, steps: int = 20):
    """The decode main path: ``plan((64, V), method="kernel",
    transforms="kp").sample_logits(logits, generator, transforms=(TopK(64),
    TopP(0.95)))`` for ``steps`` steps at each of DECODE_VOCABS: gemma2-9b's
    params on every row, then per-row params (one token per row: K9 once
    per step), then gemma2-9b's params with num_samples=4 (four candidate
    tokens per row: K11 and K12 once per step).  Logits from --seed on the
    card; every drawn token is among its row's top-k logits."""
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    res, launches = {}, {}
    spec = gemma2_9b.SAMPLER
    for V in DECODE_VOCABS:
        B = DECODE_B
        p = sampling.plan((B, V), method="kernel", transforms="kp")
        logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
        ks = torch.randint(8, 128, (B,), generator=g, device=dev).float()
        ps = 0.8 + 0.2 * torch.rand((B,), generator=g, device=dev)
        gemma = (sampling.TopK(spec.top_k), sampling.TopP(spec.top_p))
        for name, chain, S in (("uniform", gemma, 1),
                               ("per-row", (sampling.TopK(ks), sampling.TopP(ps)), 1),
                               ("uniform S=4", gemma, 4)):
            toks = []
            torch.cuda.synchronize()
            reset_counts()
            times = step_seconds(lambda: toks.append(p.sample_logits(
                logits, g, num_samples=S, transforms=chain)), steps)
            counts = read_counts()
            route = "fused" if S == 1 else "two_pass"
            expect = ({"fused_trunc_draw": steps} if route == "fused"
                      else {"masked_blocksums": steps, "walk_trunc": steps})
            check_path(f"decode ({B},{V}) {name}", counts, expect)
            kk = torch.as_tensor(chain[0].k, device=dev).float().expand(B)
            kth = torch.gather(torch.sort(logits, dim=1, descending=True).values, 1,
                               (kk.long() - 1)[:, None])
            tok = torch.stack(toks).long().reshape(-1, B)
            if not bool((torch.gather(logits, 1, tok.T) >= kth).all()):
                raise AssertionError(f"decode ({B},{V}) {name}: a token outside its top-k")
            log(f"  decode ({B},{V}) {name} route={route}: seconds per step {times}")
            res[f"{V} {name}"] = {"route": route, "step_s": times, "launches": counts}
            add_counts(launches, counts)
    return launches, res


def phase_methods(dev, seed):
    """``sample_from_logits`` at (64, 256000) once per explicit method
    (``alias`` at (64, 4096): its pairing is K sequential steps per row);
    the butterfly Categorical at (64, 256000) against its plain table."""
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    B, V = DECODE_B, gemma2_9b.VOCAB_SIZE
    logits = 4.0 * torch.randn((B, V), generator=g, device=dev)
    expects = {"butterfly": {"butterfly_table": 1}, "kernel": {"blocksums": 1, "walk": 1},
               "alias_device": {"alias_assemble": 1}}
    res, launches = {}, {}
    for m in api.METHODS[1:]:
        x = logits[:, :4096].contiguous() if m == "alias" else logits
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        idx = api.sample_from_logits(x, g, method=m)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        counts = read_counts()
        check_path(f"sample_from_logits {m} {tuple(x.shape)}", counts,
                   expects.get(m, {}))
        if int(idx.min()) < 0 or int(idx.max()) >= x.shape[1]:
            raise AssertionError(f"{m}: an index outside [0, V)")
        log(f"  sample_from_logits {m:13s} {tuple(x.shape)}: {t:.4f} s")
        res[m] = {"shape": list(x.shape), "seconds": t, "launches": counts}
        add_counts(launches, counts)
    # Categorical(method="butterfly") at vocabulary width (K1 at W=128)
    w = sampling.logits_to_weights(logits[:, :V])
    reset_counts()
    dist = sampling.Categorical.from_weights(w, method="butterfly")
    u = torch.rand(B, generator=g, device=dev)
    got = dist.draw(u=u)
    counts = read_counts()
    check_path("Categorical butterfly (64,256000)", counts, {"butterfly_table": 1})
    add_counts(launches, counts)
    wp, _, _ = bfly._prep(w, dist.W, group_pad=True)
    plain_table = KT.butterfly_table_torch(wp, dist.W, "blocks")
    want = bfly.draw_butterfly_from_table(plain_table, u, W=dist.W, B=B, K=V)
    r = weight_ties(got, want, w, u)
    log(f"  Categorical butterfly W={dist.W} (64,{V}) vs plain table: {r}")
    if r["faults"]:
        raise AssertionError(f"butterfly Categorical disagrees with its plain version: {r}")
    res["butterfly_categorical"] = r
    return launches, res


def phase_alias_phi(dev, seed, phi):
    """``Categorical.from_weights(phi, method="alias_device")`` at the paper
    corpus' phi (37,286 x 240): K13 once, S=16 draws per row, the induced
    mass against the weights."""
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dist = sampling.Categorical.from_weights(phi, method="alias_device")
    z = dist.draw(generator=g, num_samples=16)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check_path("alias_device on phi", counts, {"alias_assemble": 1})
    err = induced_mass_err(phi, dist.state["prob"], dist.state["alias"])
    drawn = torch.gather(phi, 1, z.T.long())
    log(f"  alias_device phi {tuple(phi.shape)}: build + 16 draws/row {secs:.4f} s, "
        f"induced mass max_abs_err={err:.3g}")
    if err > 5e-6 or z.shape != (16, phi.shape[0]) or not bool((drawn > 0).all()):
        raise AssertionError("alias_device on phi: mass off or a zero-weight draw")
    return counts, {"seconds": secs, "mass_err": err}


def phase_gibbs_new(state, corpus):
    """One paper-scale sweep each with ``gumbel`` and ``alias``."""
    res = {}
    K = CONFIG.K
    for method in ("gumbel", "alias"):
        state, times = sweep_seconds(state, corpus, method, None, 1)
        check_state(state, K)
        ppl = gibbs.perplexity(state, corpus)
        if not np.isfinite(ppl):
            raise AssertionError(f"{method}: perplexity is not finite")
        log(f"  seconds per sweep ({method}): {times}   perplexity {ppl:.2f}")
        res[method] = {"sweep_s": times, "perplexity": ppl}
    return state, res


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
    phi = factors("dirichlet", 1, CONFIG.V, CONFIG.K,
                  torch.Generator(device=dev).manual_seed(args.seed + 4), dev)[1]
    phase_trunc_kernels(dev, args.seed, tally)
    phase_alias_kernels(dev, args.seed, tally, phi)
    log("phase 2c: kernel times (CUDA events)")
    timing = phase_timing(corpus, dev, args.seed, inputs)
    timing.update(phase_given_timing(corpus, dev, args.seed, inputs))
    timing.update(phase_new_timing(dev, args.seed, phi))
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
    log("phase 5: the sampling API on the card")
    for fn in (lambda: phase_decode(dev, args.seed), lambda: phase_methods(dev, args.seed),
               lambda: phase_alias_phi(dev, args.seed, state.phi)):
        counts, res = fn()
        main_res.setdefault("api", []).append(res)
        add_counts(launches, counts)
    state, main_res["gibbs_new"] = phase_gibbs_new(state, dev_corpus)
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
            "card": smi, "build_s": build_s, "kernels": kernels, "timing": timing,
            "main": main_res,
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
