#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which raises on failure (exit code != 0, no result line):

1. Device: the card's name and power limit (nvidia-smi), then the CUDA
   kernels built from the sources in this checkout (nvcc, sm_90a).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (K=240, V=37,286, one chunk of 256 documents): the fused
   draw (K8) through ``lda_draw_factored``, the forced two-pass route, pass
   A (K6) through ``lda_build_running`` and pass B (K7) through
   ``lda_draw_from_running`` with S=1 and S=4; W=32 and W=16; integer
   weights (0 mismatches allowed), Dirichlet weights (float64-checked
   boundary ties only), bf16, and a padded chunk with all-zero theta rows.
   Each kernel and its plain version are timed with CUDA events.
3. The main path at the paper's Wikipedia scale (M=43,556 docs,
   V=37,286 words, K=240, ~3.07M tokens, Zipf word ids, made from --seed):
   ``init_state``, 3 ``gibbs_step`` sweeps with ``method="lda_kernel"``,
   W=32 (K8, one launch per chunk of 256 docs), then ``sample_z`` with 4
   draws per token (K6 + K7 per chunk).  The launch counts are read from
   this run only.  Then one more sweep under ``torch.profiler`` (device
   time by kernel, the device's busy share) and the Figure-3 K-sweep
   (lda_kernel vs prefix), printed, no claim made.
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lda_draw import kernel as KL  # noqa: E402
from repro_torch.kernels.lda_draw import ops  # noqa: E402
from repro_torch.kernels.lda_draw.ref import boundary_ties  # noqa: E402
from repro_torch.lda import corpus as corpus_mod  # noqa: E402
from repro_torch.lda import gibbs  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SRC = "src/repro_torch/kernels/lda_draw/csrc/lda_draw.cu"
TPU = "src/repro/kernels/lda_draw/kernel.py"
KERNELS = {  # wrapper name -> (kernel-table id, TPU kernel it replaces)
    "lda_fused_draw": ("K8", f"{TPU}:61"),
    "lda_blocksums": ("K6", f"{TPU}:125"),
    "lda_walk": ("K7", f"{TPU}:178"),
}


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

    def indices(self, name, case, a, b, th, ph, d, w, u, exact: bool):
        res = boundary_ties(a, b, th, ph, d, w, u)
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


def phase_timing(corpus, dev, seed, inputs):
    """CUDA-event times of each kernel and its plain version at the main
    path's W=32 shapes (Dirichlet factors)."""
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
    calls = {
        "lda_fused_draw": (lambda: KL.lda_fused_draw(th, ph, d, w, u, W),
                           lambda: KL.lda_fused_draw_torch(th, ph, d, w, u, W), 1),
        "lda_blocksums": (lambda: KL.lda_blocksums(th, ph, d, w, W, nb),
                          lambda: KL.lda_blocksums_torch(th, ph, d, w, W, nb), 1),
        "lda_walk": (lambda: KL.lda_walk(th, ph, run, uf, rows4, d4, w4, W),
                     lambda: KL.lda_walk_torch(th, ph, run, uf, rows4, d4, w4, W), S),
    }
    out = {}
    for name, (kern, plain, s) in calls.items():
        ms = cuda_ms(kern)
        pms = cuda_ms(plain, reps=5, warmup=1)
        ms2 = cuda_ms(kern)
        bms, by = bounds(name, th, ph, d, w, kern(), W, nb, S=s)
        out[name] = {"ms": min(ms, ms2), "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        log(f"  {name:15s} kernel {ms:.4f}/{ms2:.4f} ms  plain {pms:.4f} ms  "
            f"bound {bms * 1e3:.2f} us ({by})  draws={s * Bt}")
    return out


def sweep_seconds(state, corpus, method, W, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gibbs.gibbs_step(state, corpus, method=method, W=W, chunk=256)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return state, times


def phase_main(corpus, dev, seed):
    K, M, chunk, W = CONFIG.K, corpus.docs.shape[0], 256, 32
    nchunks = -(-M // chunk)
    log(f"phase 3: main path, M={M} V={corpus.vocab_size} K={K} "
        f"tokens={corpus.total_words} maxN={corpus.docs.shape[1]} chunks={nchunks}")
    state = gibbs.init_state(seed, corpus, K, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KL.reset_launches()
    times = []
    for i in range(3):
        before = KL.LAUNCHES["lda_fused_draw"]
        state, t = sweep_seconds(state, corpus, "lda_kernel", W, 1)
        times += t
        grew = KL.LAUNCHES["lda_fused_draw"] - before
        if grew != nchunks:
            raise AssertionError(f"sweep {i}: fused draw launched {grew}x, not {nchunks}x")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = gibbs.sample_z(state, corpus, num_samples=4, W=W, chunk=chunk)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    launches = dict(KL.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = state.theta.sum(dim=1)
    if not torch.allclose(rows, torch.ones_like(rows), atol=1e-4):
        raise AssertionError("theta rows do not sum to 1")
    for name, z in (("z", state.z), ("sample_z", zs)):
        if int(z.min()) < 0 or int(z.max()) >= K:
            raise AssertionError(f"{name} outside [0, K)")
    ppl = gibbs.perplexity(state, corpus)
    if not np.isfinite(ppl):
        raise AssertionError("perplexity is not finite")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    log(f"  seconds per sweep (lda_kernel, W={W}): {times}")
    log(f"  sample_z (4 draws/token): {t_sample:.4f} s   perplexity {ppl:.2f}")
    log(f"  peak device memory {peak / 2**30:.3f} GiB   launches {launches}")
    return state, launches, {"sweep_s": times, "sample_z_s": t_sample,
                             "perplexity": ppl, "peak_bytes": peak,
                             "tokens": corpus.total_words}


def phase_profile(state, corpus):
    """One more lda_kernel sweep under torch.profiler (after the counted
    run): device time by kernel and the device's busy share of the sweep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gibbs.gibbs_step(state, corpus, method="lda_kernel", W=32, chunk=256)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an aten op's row repeats the device time of its kernels
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"phase 3c: profiled sweep wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    for us, n, key in rows[:10]:
        log(f"  {us / 1e3:9.3f} ms  x{n:<5d} {key[:90]}")
    return {"wall_s": wall, "device_busy_s": busy,
            "top": [{"ms": us / 1e3, "count": n, "name": key[:120]}
                    for us, n, key in rows[:10]]}


def phase_fig3(corpus, dev, seed):
    log("phase 3b: Figure-3 K-sweep (1 warm-up + 2 timed sweeps each), printed only")
    rows = []
    for K in range(16, 241, 32):
        for method in ("lda_kernel", "prefix"):
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
    timing = phase_timing(corpus, dev, args.seed, inputs)
    dev_corpus = corpus_mod.Corpus(
        docs=torch.as_tensor(corpus.docs, device=dev),
        lengths=corpus.lengths,
        mask=torch.as_tensor(corpus.mask, device=dev),
        vocab_size=corpus.vocab_size,
    )
    state, launches, main_res = phase_main(dev_corpus, dev, args.seed)
    main_res["profile"] = phase_profile(state, dev_corpus)
    del state
    fig3 = phase_fig3(dev_corpus, dev, args.seed)
    planted = phase_planted(dev, args.seed)

    kernels = []
    for name, (kid, replaces) in KERNELS.items():
        t = tally.t[name]
        kernels.append({
            "name": name, "id": kid, "route": "cuda", "source": SRC,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], **timing[name], "library_ms": None,
            "bound_us": timing[name]["bound_ms"] * 1e3,
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
