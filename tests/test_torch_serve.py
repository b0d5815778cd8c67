"""The port's serving layer (repro_torch.serve) against the reference's
(repro.serve), on the same weights (the reference's float32 parameters
carried across by ``params_from_numpy``), and its own behaviour.

* ``ContinuousBatchingEngine``: the same requests give the same tokens
  per request as ``repro.serve.ContinuousBatchingEngine`` — the per-slot
  uniforms are bit-exact counter draws in both.  A request may part from
  the reference only at a step where u * total lies within 1e-5 * total
  of the boundary between the two tokens drawn, in float64 over the
  port's own logits (the two models' logits differ by ~1e-6), or at a
  greedy step whose top two logits lie within 1e-5; each such tie is
  counted and the rest of that request is not compared.
* ``generate`` with ``temperature=0``: the reference's tokens.
* Sampled draws elsewhere take a ``torch.Generator``, so they are checked
  in the port alone (recycling bit-identity, shapes, truncation).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import base as jbase
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import init_params as jinit
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSP
from repro.serve.engine import generate as jgenerate
from repro_torch import sampling
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as tget
from repro_torch.kernels import rng as trng
from repro_torch.kernels.butterfly_sample import kernel as KB
from repro_torch.models import build_model as tbuild
from repro_torch.models import init_params, params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.sampling import transforms as ttr
from repro_torch.serve import (
    ContinuousBatchingEngine,
    FinishReason,
    QueueFullError,
    Request,
    RequestState,
    SamplingParams,
    generate,
    make_decode_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.serve.engine import _pad_caches_to

TINY = dict(name="tiny-serve", family="dense", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, vocab_size=64)
TIE_TOL = 1e-5


def _pair(kind: str, method: str = None, **over):
    """(reference model, port model, reference params, port params);
    ``over`` replaces config fields in both."""
    if kind == "tiny":
        jc = jbase.ModelConfig(**TINY, sampler=jbase.SamplerSpec(method=method or "fenwick", W=8))
        tc = tbase.ModelConfig(**TINY, sampler=tbase.SamplerSpec(method=method or "fenwick", W=8))
    else:
        jc, tc = jget(kind, smoke=True), tget(kind, smoke=True)
        if method:
            jc = dataclasses.replace(jc, sampler=dataclasses.replace(
                jc.sampler or jbase.SamplerSpec(), method=method))
            tc = dataclasses.replace(tc, sampler=dataclasses.replace(
                tc.sampler or tbase.SamplerSpec(), method=method))
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jinit(jax.random.PRNGKey(0), jm.specs, jnp.float32)
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    _, tm, _, tp = _pair("tiny")
    return tm, tp


def _req(i, plen=3, max_new=4, **sp):
    return Request(prompt=np.arange(1, 1 + plen, dtype=np.int32), max_new_tokens=max_new,
                   seed=100 + i, sampling=SamplingParams(**sp) if sp else SamplingParams())


MIX = [dict(temperature=0.0), dict(temperature=0.7, top_k=5, top_p=0.9),
       dict(temperature=1.0, min_p=0.05, top_k=20), dict(temperature=1.3, top_p=0.8),
       dict(temperature=1.0, top_k=1), dict()]


def _mixed(R, SP, V, n=10, seed=1):
    rng = np.random.default_rng(seed)
    return [R(prompt=rng.integers(0, V, int(rng.integers(1, 12))).astype(np.int32),
              max_new_tokens=int(rng.integers(1, 10)), seed=100 + i,
              sampling=SP(**MIX[i % len(MIX)])) for i in range(n)]


def _u(seed: int, t: int) -> float:
    s = trng.fold(trng.seed_from_key(seed), trng.TAG_U)
    bits, _ = trng.threefry2x32(int(s[0]), int(s[1]), t, 0)
    return float(trng.bits_to_uniform(torch.tensor([bits]))[0])


def _tie(tm, tp, req, t, a, b) -> bool:
    """Whether step t of ``req`` (tokens ``a`` vs ``b``) is a boundary tie
    in float64 over the port's logits."""
    seq = np.concatenate([req.prompt, np.asarray(req.output_tokens[:t], np.int32)])
    logits = tm.apply(tp, {"tokens": torch.as_tensor(seq[None])})[0][0, -1].double()
    temp = req.effective_temperature(1.0)
    if temp == 0:
        top2 = torch.topk(logits, 2).values
        return float(top2[0] - top2[1]) <= TIE_TOL
    w64 = torch.softmax(logits / temp, dim=-1)
    sp = req.sampling
    kpm = torch.tensor([[float(sp.top_k or 0), float(sp.top_p), float(sp.min_p)]])
    w32 = w64.float()[None]
    keep = w32[0] >= ttr.thresholds_from_params(w32, kpm)[0]
    cdf = torch.cumsum(w64 * keep, dim=0)
    total = float(cdf[-1])
    return abs(_u(req.seed, t) * total - float(cdf[min(a, b)])) <= TIE_TOL * total


def _compare_engines(kind, method, slots=3, n=10, jmesh=None, tmesh=None, **over):
    jm, tm, jp, tp = _pair(kind, method, **over)
    V = tm.cfg.vocab_size
    want = [r.output_tokens for r in JEngine(jm, jp, max_slots=slots, max_len=32,
                                             mesh=jmesh).run(_mixed(JRequest, JSP, V, n))]
    eng = ContinuousBatchingEngine(tm, tp, max_slots=slots, max_len=32, mesh=tmesh)
    got = eng.run(_mixed(Request, SamplingParams, V, n))
    ties = 0
    for r, w in zip(got, want):
        g = r.output_tokens
        assert r.state is RequestState.FINISHED and len(g) == len(w)
        d = next((t for t, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if d is not None:
            assert _tie(tm, tp, r, d, g[d], w[d]), (r.seed, d, g, w)
            ties += 1
    assert ties <= 1, ties
    return eng


def test_engine_matches_reference_fenwick():
    eng = _compare_engines("tiny", "fenwick")
    assert eng.plan.method == "fenwick"


def test_engine_matches_reference_kernel_route(monkeypatch):
    """gemma2-9b SMOKE, method "kernel": the fused truncated draw (K9's
    plain version on the CPU), once per decode step."""
    calls = []
    real = KB.fused_trunc_draw_torch
    monkeypatch.setattr(KB, "fused_trunc_draw_torch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    import repro_torch.kernels.butterfly_sample.ops as bops
    monkeypatch.setattr(bops, "fused_trunc_draw_torch", KB.fused_trunc_draw_torch)
    eng = _compare_engines("gemma2-9b", "kernel")
    assert eng.plan.method == "kernel"
    assert len(calls) == eng.stats()["steps"] > 0


@pytest.mark.parametrize("kind", ["minicpm3-4b", "granite-moe-1b-a400m", "mamba2-370m",
                                  "hymba-1.5b"])
def test_engine_matches_reference_families(kind):
    """MLA, MoE, SSM and hybrid SMOKE configs through both engines (hymba's
    without its meta tokens, which the reference's engine refuses; the
    port's serves them, ``test_engine_serves_meta_tokens``).  MoE's rows
    share capacity, in both."""
    _compare_engines(kind, "fenwick", **({"meta_tokens": 0} if kind == "hymba-1.5b" else {}))


@pytest.mark.parametrize("kind", ["tiny", "gemma2-9b"])
def test_greedy_generate_matches_reference(kind):
    jm, tm, jp, tp = _pair(kind)
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab_size, (3, 10)).astype(np.int32)
    want = jgenerate(jm, jp, {"tokens": jnp.asarray(toks)}, max_new_tokens=6, temperature=0.0)
    got = generate(tm, tp, {"tokens": torch.as_tensor(toks)}, max_new_tokens=6,
                   temperature=0.0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_len == want.prefill_len == 10 and got.steps == 6


@pytest.mark.parametrize("kind", ["pixtral-12b", "seamless-m4t-medium"])
def test_greedy_generate_matches_reference_prefixed(kind):
    """The vlm with its stub patch embeddings, and the enc-dec with its
    source frames and target tokens (``generate`` reads ``tgt_tokens``)."""
    jm, tm, jp, tp = _pair(kind)
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    emb = (rng.normal(size=(3, cfg.frontend_len or 5, cfg.d_model)) * 0.02).astype(np.float32)
    batch = ({"src_embeds": emb, "tgt_tokens": toks} if cfg.encoder_layers
             else {"tokens": toks, "frontend_embeds": emb})
    want = jgenerate(jm, jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_new_tokens=5,
                     temperature=0.0)
    got = generate(tm, tp, {k: torch.as_tensor(v) for k, v in batch.items()},
                   max_new_tokens=5, temperature=0.0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_len == want.prefill_len == 6 + (cfg.frontend_len or 0)


def test_greedy_generate_matches_argmax_rollout(tiny):
    tm, tp = tiny
    toks = np.random.default_rng(0).integers(0, 64, (3, 10)).astype(np.int32)
    r = generate(tm, tp, {"tokens": torch.as_tensor(toks)}, max_new_tokens=4, temperature=0.0)
    cur = toks
    for t in range(4):
        logits, _ = tm.apply(tp, {"tokens": torch.as_tensor(cur)})
        nxt = logits[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(nxt, r.tokens[:, t], err_msg=f"step {t}")
        cur = np.concatenate([cur, nxt[:, None].astype(np.int32)], axis=1)


@pytest.mark.parametrize("method", ["fenwick", "butterfly", "prefix", "kernel", "gumbel"])
def test_generate_methods_sample_in_range(method):
    _, tm, _, tp = _pair("tiny", method)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 64, (3, 8)), dtype=torch.int32)
    a = generate(tm, tp, {"tokens": toks}, max_new_tokens=5,
                 generator=torch.Generator().manual_seed(4))
    b = generate(tm, tp, {"tokens": toks}, max_new_tokens=5,
                 generator=torch.Generator().manual_seed(4))
    assert a.tokens.shape == (3, 5) and ((a.tokens >= 0) & (a.tokens < 64)).all()
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_padded_vocab_never_sampled():
    cfg = tbase.ModelConfig(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
                            num_kv_heads=2, d_ff=64, vocab_size=50, pad_vocab_multiple=16,
                            sampler=tbase.SamplerSpec(method="fenwick", W=8))
    m = tbuild(cfg)
    p = init_params(3, m.specs, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 50, (3, 8)), dtype=torch.int32)
    r = generate(m, p, {"tokens": toks}, max_new_tokens=12, temperature=1.5)
    assert (r.tokens < 50).all()


def test_eos_stops_generate(tiny):
    tm, tp = tiny
    toks = torch.ones((2, 4), dtype=torch.int32)
    first = generate(tm, tp, {"tokens": toks}, max_new_tokens=1, temperature=0.0).tokens
    eos = int(first[0, 0])
    r = generate(tm, tp, {"tokens": toks[:1]}, max_new_tokens=8, temperature=0.0, eos_id=eos)
    # as the reference: the first decode step that emits eos ends the loop
    assert r.steps < 8 and r.tokens[0, -1] == eos and (r.tokens[0, 1:-1] != eos).all()
    assert generate(tm, tp, {"tokens": toks}, max_new_tokens=8, temperature=0.0,
                    eos_id=10 ** 9).steps == 8


# -- make_decode_step ----------------------------------------------------------


def _step_inputs(tm, B):
    caches = init_params(0, tm.cache_specs(B, 8), device="cpu")
    return caches, torch.arange(1, B + 1, dtype=torch.int32)[:, None]


def test_decode_step_explicit_none_matches_default_plain(tiny):
    tm, tp = tiny
    step = make_decode_step(tm, temperature=0.9, batch_size=2)
    caches, tok = _step_inputs(tm, 2)
    a, _, _ = step(tp, caches, tok, 0, torch.Generator().manual_seed(1))
    b, _, _ = step(tp, caches, tok, 0, torch.Generator().manual_seed(1), sampling=None)
    assert a.shape == (2, 1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_decode_step_no_stale_params_across_calls(tiny):
    tm, tp = tiny
    step = make_decode_step(tm, temperature=0.9, batch_size=2)
    caches, tok = _step_inputs(tm, 2)
    base, logits, _ = step(tp, caches, tok, 0, torch.Generator().manual_seed(1))
    g, _, _ = step(tp, caches, tok, 0, torch.Generator().manual_seed(1),
                   sampling=SamplingParams(top_k=1))
    np.testing.assert_array_equal(g[:, 0].numpy(), logits.argmax(-1).numpy())
    again, _, _ = step(tp, caches, tok, 0, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(again.numpy(), base.numpy())


def test_decode_step_heterogeneous_rows_one_workload(tiny):
    tm, tp = tiny
    step = make_decode_step(tm, batch_size=3)
    caches, tok = _step_inputs(tm, 3)
    g = torch.Generator().manual_seed(4)
    spa = SamplingParams(top_k=torch.tensor([1, 5, 0]), top_p=torch.tensor([1.0, 0.9, 0.8]))
    spb = SamplingParams(top_k=torch.tensor([3, 0, 2]), top_p=torch.tensor([0.7, 1.0, 0.9]))
    a, logits, _ = step(tp, caches, tok, 0, g, sampling=spa)
    assert int(a[0, 0]) == int(logits[0].argmax())
    step(tp, caches, tok, 0, g, sampling=spb)
    assert step.trunc_cache_size() == 1 and step.plain_cache_size() == 0
    step(tp, caches, tok, 0, g, sampling=SamplingParams(min_p=0.1))
    assert step.trunc_cache_size() == 2


def test_decode_step_num_samples_runs_the_two_pass_route(monkeypatch):
    """``num_samples=4`` under a chain with a ``kernel`` plan: tau, then
    K11 and K12 (their plain versions here), one launch each."""
    _, tm, _, tp = _pair("gemma2-9b", "kernel")
    import repro_torch.kernels.butterfly_sample.ops as bops
    calls = {"masked_blocksums": 0, "walk_trunc": 0}
    for name in calls:
        real = getattr(bops, f"{name}_torch")
        monkeypatch.setattr(bops, f"{name}_torch",
                            lambda *a, _r=real, _n=name, **k: calls.__setitem__(_n, calls[_n] + 1)
                            or _r(*a, **k))
    step = make_decode_step(tm, batch_size=3, num_samples=4)
    caches, tok = _step_inputs(tm, 3)
    out, logits, _ = step(tp, caches, tok, 0, torch.Generator().manual_seed(5),
                          sampling=SamplingParams(top_k=8, top_p=0.9))
    assert out.shape == (3, 4) and calls == {"masked_blocksums": 1, "walk_trunc": 1}
    kth = torch.sort(logits, dim=1, descending=True).values[:, 7:8]
    assert bool((torch.gather(logits, 1, out.long()) >= kth).all())


def test_serve_and_prefill_steps(tiny):
    tm, tp = tiny
    toks = torch.ones((2, 5), dtype=torch.int32)
    first, caches = make_prefill_step(tm, temperature=0.0)(tp, {"tokens": toks})
    logits, _ = tm.apply(tp, {"tokens": toks})
    np.testing.assert_array_equal(first.numpy(), logits[:, -1].argmax(-1).numpy())
    caches = _pad_caches_to(caches, 8)
    nxt, caches = make_serve_step(tm, temperature=0.0, sampling_params=SamplingParams(top_k=3))(
        tp, caches, first[:, None], 5)
    assert nxt.shape == (2,) and nxt.dtype == torch.int32


def test_pad_caches_noop_returns_identity(tiny):
    tm, _ = tiny
    caches = init_params(0, tm.cache_specs(2, 8), device="cpu")
    grown = _pad_caches_to(caches, 16)
    assert grown is not caches and grown["attn"]["k"].shape[2] == 16
    assert _pad_caches_to(grown, 16) is grown
    assert _pad_caches_to(grown, 12) is grown
    assert _pad_caches_to(caches, 8) is caches


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo_serve") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        sampling.reset_plans()
        dist.destroy_process_group()


def test_decode_step_on_a_mesh_uses_the_counter_key(mesh1):
    """``mesh=``: the per-shard counter draw; a fixed key gives fixed
    tokens, whole (not sharded) on the way out."""
    _, tm, _, tp = _pair("tiny", "kernel")
    step = make_decode_step(tm, batch_size=2, mesh=mesh1)
    caches, tok = _step_inputs(tm, 2)
    sp = SamplingParams(top_k=5)
    a, _, _ = step(tp, caches, tok, 0, [1, 2], sampling=sp)
    b, _, _ = step(tp, caches, tok, 0, [1, 2], sampling=sp)
    c, _, _ = step(tp, caches, tok, 0, [1, 2], sampling=None)
    assert isinstance(a, torch.Tensor) and a.shape == (2, 1) and c.shape == (2, 1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    r = generate(tm, tp, {"tokens": tok.repeat(1, 3)}, max_new_tokens=3, mesh=mesh1, key=7)
    assert r.tokens.shape == (2, 3)


# -- ContinuousBatchingEngine, the port alone ---------------------------------


@pytest.mark.parametrize("method", ["fenwick", "butterfly", "kernel"])
def test_recycling_bit_identity_vs_sequential(method):
    """3 requests churning through 2 slots give the tokens of one-at-a-time
    runs with the same seeds: the counter-RNG slot isolation."""
    _, tm, _, tp = _pair("tiny", method)

    def reqs():
        return [_req(i, plen=2 + i, max_new=4 + i, temperature=0.8, top_p=0.95)
                for i in range(3)]

    batched = [r.output_tokens for r in
               ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32).run(reqs())]
    solo = [ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32).run([r])[0].output_tokens
            for r in reqs()]
    assert batched == solo


def test_lifecycle_and_single_token_prompt(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32)
    out = eng.run([_req(i, plen=1 + i, max_new=3 + i) for i in range(3)])
    for i, r in enumerate(out):
        assert r.state is RequestState.FINISHED and r.finish_reason is FinishReason.LENGTH
        assert len(r.output_tokens) == 3 + i
        assert all(0 <= t < 64 for t in r.output_tokens)
    st = eng.stats()
    assert st["submitted"] == 3 and st["finished"] == 3 and eng.scheduler.idle
    assert eng.compile_stats()["prefill_buckets"] == [0, 1, 2]


def test_recycled_slot_rows_are_reset(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32)
    eng.run([_req(0, plen=9, max_new=6)])
    eng.run([_req(1, plen=1, max_new=1)])
    k = eng._caches["attn"]["k"]
    assert (k[:, 0, 1:] == 0).all() and (k[:, 0, 0] != 0).any()


def test_eos_early_finish(tiny):
    tm, tp = tiny
    first = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32).run(
        [_req(0, max_new=1, temperature=0.8)])[0].output_tokens[0]
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32, eos_id=first)
    r = eng.run([_req(0, max_new=8, temperature=0.8)])[0]
    assert r.finish_reason is FinishReason.EOS and r.output_tokens == [first]


def test_greedy_and_top_k_one_rows_are_argmax(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=3, max_len=32)
    out = eng.run([_req(0, max_new=5, temperature=1.0, top_k=1),
                   _req(1, max_new=5, temperature=1.3, top_p=0.8),
                   _req(2, max_new=5, temperature=0.0)])
    greedy = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32).run(
        [_req(0, max_new=5, temperature=0.0)])[0].output_tokens
    assert out[0].output_tokens == greedy == out[2].output_tokens


def test_admission_rejects_beyond_max_waiting(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32, max_waiting=2)
    eng.submit_nowait(_req(0))
    eng.submit_nowait(_req(1))
    late = _req(2)
    with pytest.raises(QueueFullError):
        eng.submit_nowait(late)
    assert late.state is RequestState.REJECTED and late.finish_reason is FinishReason.REJECTED
    assert eng.stats()["rejected"] == 1
    assert eng.run([]) == [] and eng.stats()["finished"] == 2


def test_rejects_over_budget_request(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=8)
    bad = Request(prompt=np.arange(5), max_new_tokens=10, seed=0)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit_nowait(bad)
    assert bad.state is RequestState.REJECTED


def test_request_validation():
    with pytest.raises(ValueError, match="empty prompt"):
        Request(prompt=np.array([], np.int32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(prompt=np.array([1]), max_new_tokens=0)
    with pytest.raises(ValueError, match="concrete scalar"):
        Request(prompt=np.array([1]), sampling=SamplingParams(top_p=np.ones(4)))


def test_asyncio_tokens_match_sync(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32)

    async def main():
        await eng.start()
        reqs = [await eng.submit(_req(i, max_new=4, temperature=0.8)) for i in range(4)]
        done = await asyncio.wait_for(asyncio.gather(*(r.future for r in reqs)), 60)
        await eng.drain()
        await eng.stop()
        return done

    done = asyncio.run(main())
    for r in done:
        assert r.state is RequestState.FINISHED and len(r.output_tokens) == 4
        assert r.ttft >= 0 and r.e2e_latency >= r.ttft
    want = [r.output_tokens for r in ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32)
            .run([_req(i, max_new=4, temperature=0.8) for i in range(4)])]
    assert [r.output_tokens for r in done] == want


def test_warmup_resets_metrics_and_plans_once(tiny):
    tm, tp = tiny
    sampling.reset_plans()
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32)
    eng.warmup(max_prompt_len=8)
    base = eng.compile_stats()
    assert eng.stats()["steps"] == 0 and base["prefill_buckets"] == [1, 2, 4, 8]
    eng.run([_req(i, plen=2 + i % 5, max_new=3) for i in range(6)])
    after = eng.compile_stats()
    assert after["plan_stats"]["plan_misses"] == base["plan_stats"]["plan_misses"] == 1


def test_engine_waiting_slices_raise(tiny, mesh1):
    """The mesh case is the reference's
    ``test_mesh_requires_divisible_slots``: 3 slots do not divide over a
    (2, 1) mesh's 2 data shards (a mesh description; no collective runs
    before the check).  Encoder/frontend configs still raise."""
    from torch.distributed.device_mesh import DeviceMesh

    tm, tp = tiny
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1), mesh_dim_names=("data", "model"),
                      _init_backend=False)
    with pytest.raises(ValueError, match="divide"):
        ContinuousBatchingEngine(tm, tp, max_slots=3, mesh=mesh)
    for arch in ("pixtral-12b", "seamless-m4t-medium"):
        m = tbuild(tget(arch, smoke=True))
        with pytest.raises(ValueError, match="encoder/frontend"):
            ContinuousBatchingEngine(m, init_params(0, m.specs, device="cpu"), max_slots=2)


def test_recycled_ssm_slot_takes_the_new_state():
    """mamba2 SMOKE: requests churning through 2 slots give the tokens of
    one-at-a-time runs, and a slot recycled from a long request holds
    exactly a fresh slot's SSM state (the state leaves have no sequence
    axis: the insert writes them whole, or zeroes them for a single-token
    prompt)."""
    _, tm, _, tp = _pair("mamba2-370m", "fenwick")

    def reqs():
        return [_req(i, plen=2 + 3 * i, max_new=3 + i, temperature=0.8) for i in range(3)]

    batched = [r.output_tokens for r in
               ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32).run(reqs())]
    solo = [ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32).run([r])[0].output_tokens
            for r in reqs()]
    assert batched == solo
    for plen in (1, 5):
        eng = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32)
        eng.run([_req(0, plen=9, max_new=6)])
        eng.run([_req(1, plen=plen, max_new=1)])
        fresh = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=32)
        fresh.run([_req(1, plen=plen, max_new=1)])
        for name, leaf in eng._caches["ssm"].items():
            assert torch.equal(leaf, fresh._caches["ssm"][name]), (plen, name)


def test_ssm_slot_state_absorbs_the_bucket_pad_as_the_reference():
    """ROADMAP queue 3: an engine prefills a prompt's prefix padded with
    token 0 up to its power-of-two bucket.  Attention masks the pad; an SSM
    state absorbs it.  The reference's engine does so, and the port's
    matches it: after a 4-token prompt (prefix 3, bucket 4) the slot's state
    equals the reference's, not the state of the prompt itself."""
    jm, tm, jp, tp = _pair("mamba2-370m", "fenwick")
    prompt = np.array([5, 9, 2, 7], np.int32)
    je = JEngine(jm, jp, max_slots=1, max_len=16)
    je.run([JRequest(prompt=prompt, max_new_tokens=1, seed=0, sampling=JSP(temperature=0.0))])
    te = ContinuousBatchingEngine(tm, tp, max_slots=1, max_len=16)
    te.run([Request(prompt=prompt, max_new_tokens=1, seed=0,
                    sampling=SamplingParams(temperature=0.0))])
    got = te._caches["ssm"]["h"].numpy()
    np.testing.assert_allclose(got, np.asarray(je._caches["ssm"]["h"]), rtol=1e-4, atol=1e-4)
    _, exact = tm.prefill(tp, {"tokens": torch.as_tensor(prompt[None])})
    assert not np.allclose(got, exact["ssm"]["h"].numpy(), rtol=1e-3, atol=1e-3)


def test_engine_serves_meta_tokens():
    """hymba SMOKE with its 8 meta tokens: every prefill prepends them and a
    slot's positions count from them, so greedy engine tokens equal
    ``generate``'s (prefixes of a power of two: no bucket pad)."""
    _, tm, _, tp = _pair("hymba-1.5b", "fenwick")
    assert tm.cfg.meta_tokens == 8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32) for n in (1, 2, 3, 5, 9)]
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=32)
    assert eng._caches["attn"]["k"].shape[2] == 32 + 8
    out = eng.run([Request(prompt=p, max_new_tokens=4, seed=i,
                           sampling=SamplingParams(temperature=0.0))
                   for i, p in enumerate(prompts)])
    for p, r in zip(prompts, out):
        want = generate(tm, tp, {"tokens": torch.as_tensor(p[None])}, max_new_tokens=4,
                        temperature=0.0).tokens[0].tolist()
        assert r.output_tokens == want, (len(p), r.output_tokens, want)
    assert eng.compile_stats()["prefill_buckets"] == [0, 1, 2, 4, 8]


def test_engine_state_lives_on_the_params_device(tiny):
    tm, tp = tiny
    eng = ContinuousBatchingEngine(tm, tp, max_slots=2, max_len=16)
    assert eng.device.type == "cpu"
    assert all(x.device.type == "cpu" and x.dtype == torch.float32
               for x in tree_leaves(eng._caches))


def test_engine_on_a_one_rank_mesh_equals_the_engine_without(mesh1):
    """``mesh=`` on a one-rank ("data",) mesh: the per-shard unfused draw
    (threshold, mask, the u-driven plan on the per-slot counter uniforms)
    gives the tokens of the engine without a mesh, for a ``kernel`` plan
    (K9 without a mesh, K2 + K3 on the masked weights with one) and a
    ``butterfly`` one; the 2-rank case is in test_torch_launch.py."""
    for method in ("kernel", "butterfly"):
        _, tm, _, tp = _pair("tiny", method)

        def reqs():
            return [_req(i, plen=2 + i % 3, max_new=4, temperature=0.8, top_p=0.9)
                    for i in range(6)]

        got = [r.output_tokens for r in
               ContinuousBatchingEngine(tm, tp, max_slots=8, max_len=32, mesh=mesh1).run(reqs())]
        want = [r.output_tokens for r in
                ContinuousBatchingEngine(tm, tp, max_slots=8, max_len=32).run(reqs())]
        assert got == want, method


def test_engine_on_a_mesh_matches_reference_on_a_mesh(mesh1, monkeypatch):
    """Both engines' ``mesh=`` routes on the same weights and requests: the
    port's on its one-rank mesh (this rank's logits rows, threshold, mask,
    the per-shard ``butterfly`` plan) against the reference's on a
    one-device (1, 1) jax Mesh (the same draw inside ``shard_map``), with
    the boundary ties of ``_compare_engines``.  The installed
    ``jax.shard_map`` names the reference's ``check_rep`` argument
    ``check_vma`` (ROADMAP queue 3), so the reference's call is handed
    that name here; its code runs as it is."""
    import repro.serve.batching as jbatching
    from jax.sharding import Mesh

    monkeypatch.setattr(jbatching, "_shard_map",
                        lambda f, *, check_rep=True, **kw: jax.shard_map(
                            f, check_vma=check_rep, **kw))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    eng = _compare_engines("tiny", "butterfly", slots=8, jmesh=jmesh, tmesh=mesh1)
    assert eng.mesh is mesh1 and eng._lay is not None
    assert eng.plan.method == "butterfly" and eng.plan.devices == 1
