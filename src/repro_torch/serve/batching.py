"""Continuous-batching serve engine, the counterpart of
``repro.serve.batching``: one decode step of a fixed shape, with churning
requests expressed entirely as per-slot *data*.

* **Fixed decode batch.**  ``max_slots`` rows, always.  A request is a
  slot assignment; EOS / length-exhausted slots are released and refilled
  from the bounded waiting queue between steps (FCFS,
  :mod:`repro_torch.serve.scheduler`), their KV rows reset in place by the
  insert.
* **Per-slot positions.**  Every slot decodes at its own sequence length:
  ``cache_pos`` is a (B,) tensor threaded down through ``lm_decode`` /
  ``gqa_attend`` (per-row RoPE angles, per-row cache writes, per-row
  prefix masks), so sequences of different lengths share one step.
* **Per-slot sampling params.**  temperature / top-k / top-p / min-p ride
  in as (B,) / (B, 3) operands; truncation is the per-row threshold of
  ``repro_torch.sampling.transforms`` (K9 fuses it into the draw for a
  ``kernel`` plan), so a heterogeneous batch runs the same step as a
  homogeneous one.
* **Per-slot counter-RNG streams.**  The uniform drawing request r's t-th
  token is ``threefry(seed_r, t)`` (``repro_torch.kernels.rng``,
  bit-exact with the reference) — a function of the request, not of the
  slot, the batch or the step count.  A request's tokens are therefore
  bit-identical to a one-at-a-time run with the same seed.
* **Prefill/decode interleaving.**  Prompts prefill one request at a time
  into power-of-two bucketed lengths, at most ``prefill_chunk`` per decode
  step, so admission never starves the running batch.
* **Every decoder-only family.**  Attention caches are written at a
  slot's sequence positions; the SSM state and conv tails (no sequence
  axis) are written whole.  Learned meta tokens (hymba) lead every slot:
  each prefill prepends them, and a slot's positions count from them (the
  reference's engine refuses such configs).

Nothing is traced or compiled: :meth:`ContinuousBatchingEngine.compile_stats`
reports ``sampling.plan_stats()`` (plans resolve once per workload) and the
prefill buckets seen.  A sharded engine (``mesh=``) comes with
``repro_torch.dist`` (ROADMAP.md queue 1, slice 14).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import sampling
from repro_torch.kernels import rng as _rng
from repro_torch.kernels.butterfly_sample import ops as _kops
from repro_torch.models.model import Model
from repro_torch.models.params import init_params
from repro_torch.sampling import distribution as _dist
from repro_torch.sampling import transforms as _tr
from repro_torch.serve.engine import _params_device
from repro_torch.serve.request import FinishReason, Request, RequestState
from repro_torch.serve.scheduler import QueueFullError, Scheduler

__all__ = ["ContinuousBatchingEngine", "QueueFullError"]

# kpm block of a request that does not truncate: top_k=0, top_p=1, min_p=0
_KPM_OFF = np.array([0.0, 1.0, 0.0], np.float32)


def _bucket(n: int) -> int:
    """Smallest power of two >= n (prefill length buckets: log2(max_len)
    distinct prefill shapes)."""
    return 1 << max(0, int(n - 1).bit_length())


# cache leaves with a (L, B, S, ...) sequence axis (axis 2 when stacked);
# every other leaf (the SSM state and conv tails) is per-row state
# without one
_SEQ_LEAF_NAMES = frozenset({"k", "v", "c_kv", "k_pe"})


def _insert(caches, prefix, slot: int, name=None) -> None:
    """Write one request's prefilled prefix (a (L, 1, ...) tree, or None
    for no prefix) into ``slot`` of the (L, B, ...) caches, in place.  A
    sequence leaf takes the prefix's first positions and zeros after them,
    so no KV of the slot's previous occupant survives recycling; any other
    leaf takes the prefix's state whole (zeros for no prefix)."""
    if isinstance(caches, dict):
        for k in caches:
            _insert(caches[k], None if prefix is None else prefix[k], slot, k)
        return
    row = caches[:, slot]
    if prefix is None:
        row.zero_()
    elif name in _SEQ_LEAF_NAMES:
        n = prefix.shape[2]
        row[:, :n] = prefix[:, 0]
        row[:, n:] = 0
    else:
        row.copy_(prefix[:, 0])


class ContinuousBatchingEngine:
    """Serve engine over a fixed, slot-recycled decode batch.

    Synchronous core (``submit_nowait`` / ``run``) for tests and batch
    jobs; asyncio surface (``start`` / ``submit`` / ``drain`` / ``stop``)
    for open-loop serving.  The engine runs on the params' device."""

    def __init__(
        self,
        model: Model,
        params,
        *,
        max_slots: Optional[int] = None,
        max_len: Optional[int] = None,
        max_waiting: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        temperature: float = 1.0,
        eos_id: Optional[int] = None,
        mesh=None,
        cache_dtype=torch.float32,
    ):
        cfg = model.cfg
        if mesh is not None:
            raise NotImplementedError(
                "a sharded continuous-batching engine (mesh=) comes with "
                "repro_torch.dist, ROADMAP.md queue 1, slice 14")
        if cfg.encoder_layers > 0 or cfg.frontend_len > 0:
            raise ValueError(
                "continuous batching serves decoder-only families; "
                f"config {cfg.name!r} has encoder/frontend prefixes whose "
                "slot layout is not implemented"
            )
        serve = cfg.serve_spec
        self.model = model
        self.params = params
        self.device = _params_device(params)
        # learned meta tokens (hymba) lead every slot's sequence: each
        # prefill prepends them, and a slot's positions count from them
        self._meta = cfg.meta_tokens
        self.max_slots = int(max_slots or serve.max_slots)
        self.max_len = int(max_len or serve.max_len)
        self.prefill_chunk = serve.prefill_chunk if prefill_chunk is None else prefill_chunk
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.scheduler = Scheduler(
            self.max_slots, serve.max_waiting if max_waiting is None else max_waiting)

        B, V = self.max_slots, cfg.padded_vocab
        self.plan = self._resolve_plan(B, V)

        # the decode cache: (L, B, S, ...) leaves, zero-initialized once;
        # slot rows are reset in place on every admit
        self._caches = init_params(0, model.cache_specs(B, self.max_len), cache_dtype,
                                   self.device)

        # per-slot host state, sent to the device each step (fixed shapes)
        self._token = np.zeros((B,), np.int32)
        self._pos = np.zeros((B,), np.int32)
        self._seeds = np.zeros((B, 2), np.int64)
        self._draw_idx = np.zeros((B,), np.int64)
        self._temp = np.ones((B,), np.float32)
        self._kpm = np.tile(_KPM_OFF, (B, 1))
        self._active = np.zeros((B,), bool)

        # metrics
        self.step_times: List[Dict] = []     # {"dt": s, "active": n, "tokens": n}
        self.prefill_times: List[Dict] = []  # {"dt": s, "bucket": n}
        self._buckets = set()
        self._steps = 0
        self._tokens_out = 0

        # asyncio surface
        self._running = False
        self._loop_task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None

    # -- planning ----------------------------------------------------------

    def _resolve_plan(self, B: int, V: int):
        """A u-driven sampler plan for the (B, V) decode workload.

        The per-slot RNG streams hand the draw an explicit (B,) uniform
        vector, so key-driven variants (gumbel / alias) and factored ones
        can't serve here; an autotune resolution landing on one falls back
        to butterfly."""
        spec = self.model.cfg.sampler_spec

        def uplan(method):
            return sampling.plan((B, V), method=method, W=spec.W or None, dtype="float32",
                                 draws=1, has_key=False, backend=self.device.type)

        p = uplan(spec.method)
        if p.method in _dist.KEY_VARIANTS or p.table_method in _dist.FACTORED_VARIANTS:
            p = uplan("butterfly")
        return p

    # -- the step's pieces ---------------------------------------------------

    def _draw(self, w, u, kpm):
        """One token per row from (B, V) weights, (B,) uniforms and the
        (B, 3) [top_k, top_p, min_p] block."""
        plan = self.plan
        if plan.method in ("kernel", "kernel_trunc"):
            # one fused kernel (K9): threshold + mask + draw
            return _kops.butterfly_sample_truncated(w, u, kpm, W=plan.W)
        tau = _tr.thresholds_from_params(w, kpm)
        wm = torch.where(w >= tau[:, None], w, torch.zeros_like(w))
        return _dist.draw(plan.build(wm), u=u)

    def _step(self, token, pos, seeds, draw_idx, temp, kpm):
        logits, self._caches = self.model.decode(self.params, self._caches,
                                                 token[:, None], pos)
        # per-slot stream: uniform for (request seed, token index) —
        # independent of slot id and batch mix
        bits, _ = _rng.threefry2x32(seeds[:, 0], seeds[:, 1], draw_idx,
                                    torch.zeros_like(draw_idx))
        u = _rng.bits_to_uniform(bits)
        safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
        w = _dist.logits_to_weights(logits, safe_t).to(torch.float32)
        sampled = self._draw(w, u, kpm).to(torch.int32)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.where(temp > 0, sampled, greedy)

    @staticmethod
    def _seed_pair(seed: int) -> np.ndarray:
        return _rng.fold(_rng.seed_from_key(int(seed)), _rng.TAG_U).numpy()

    # -- submission --------------------------------------------------------

    def submit_nowait(self, req: Request) -> Request:
        """Admit a request (synchronous).  Raises ``ValueError`` when the
        request can't fit a slot's KV budget, :class:`QueueFullError`
        when admission control rejects it."""
        if req.total_budget > self.max_len:
            req.state = RequestState.REJECTED
            req.finish_reason = FinishReason.REJECTED
            raise ValueError(
                f"request needs {req.total_budget} KV positions "
                f"(prompt {req.prompt_len} + max_new {req.max_new_tokens}) "
                f"> engine max_len {self.max_len}"
            )
        if req.arrival_time < 0:
            req.arrival_time = time.perf_counter()
        try:
            return self.scheduler.submit(req)
        except QueueFullError:
            req.finish_reason = FinishReason.REJECTED
            if req.future is not None and not req.future.done():
                req.future.set_result(req)
            raise

    async def submit(self, req: Request) -> Request:
        """Asyncio admission: attaches a future resolved at finish."""
        loop = asyncio.get_running_loop()
        req.future = loop.create_future()
        self.submit_nowait(req)
        if self._wake is not None:
            self._wake.set()
        return req

    # -- the scheduling loop ------------------------------------------------

    def _admit(self) -> int:
        """Refill free slots from the queue head; at most ``prefill_chunk``
        prefills per call (0 = no cap) so decode latency stays bounded."""
        admitted = 0
        budget = self.prefill_chunk or self.max_slots
        for slot in self.scheduler.free_slots():
            if admitted >= budget:
                break
            req = self.scheduler.next_waiting()
            if req is None:
                break
            self._prefill_into(slot, req)
            self.scheduler.bind(slot, req)
            admitted += 1
        return admitted

    def _prefill_into(self, slot: int, req: Request) -> None:
        req.state = RequestState.PREFILLING
        t0 = time.perf_counter()
        prefix = req.prompt[:-1]
        if prefix.size or self._meta:
            sb = _bucket(prefix.size) if prefix.size else 0
            toks = np.zeros((1, sb), np.int32)
            toks[0, : prefix.size] = prefix
            pre = self.model.prefill(self.params,
                                     {"tokens": torch.as_tensor(toks, device=self.device)})[1]
        else:
            # single-token prompt: no prefix — the insert still resets the
            # slot's rows
            sb, pre = 0, None
        _insert(self._caches, pre, slot)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        req.prefill_time = time.perf_counter()
        self._buckets.add(sb)
        self.prefill_times.append({"dt": req.prefill_time - t0, "bucket": sb})
        # slot state: the prompt's LAST token runs through the decode step
        # at position prompt_len-1 (writes its own KV, yields the first
        # sampled token) — prefill logits are never consumed
        self._token[slot] = int(req.prompt[-1])
        self._pos[slot] = self._meta + req.prompt_len - 1
        self._seeds[slot] = self._seed_pair(req.seed)
        self._draw_idx[slot] = 0
        sp = req.sampling
        self._temp[slot] = req.effective_temperature(self.temperature)
        self._kpm[slot] = (
            float(sp.top_k or 0),
            float(1.0 if sp.top_p is None else sp.top_p),
            float(sp.min_p or 0.0),
        )
        self._active[slot] = True

    def _device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def step_once(self) -> int:
        """One batched decode step over every slot.  Returns the number of
        live tokens produced (0 when no slot is active)."""
        if not self._active.any():
            return 0
        t0 = time.perf_counter()
        nxt = self._step(
            self._device(self._token), self._device(self._pos),
            self._device(self._seeds), self._device(self._draw_idx),
            self._device(self._temp), self._device(self._kpm),
        )
        nxt_np = nxt.cpu().numpy()  # host sync: the step's wall-clock edge
        now = time.perf_counter()
        live = int(self._active.sum())
        self.step_times.append({"dt": now - t0, "active": live, "tokens": live})
        self._steps += 1
        self._tokens_out += live
        for slot in np.nonzero(self._active)[0]:
            req = self.scheduler.bound(int(slot))
            tok = int(nxt_np[slot])
            if not req.output_tokens:
                req.first_token_time = now
            req.output_tokens.append(tok)
            req.token_times.append(now)
            self._token[slot] = tok
            self._pos[slot] += 1
            self._draw_idx[slot] += 1
            eos = req.eos_id if req.eos_id is not None else self.eos_id
            if eos is not None and tok == eos:
                self._finish(int(slot), FinishReason.EOS)
            elif len(req.output_tokens) >= req.max_new_tokens:
                self._finish(int(slot), FinishReason.LENGTH)
        return live

    def _finish(self, slot: int, reason: FinishReason) -> None:
        req = self.scheduler.release(slot)
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        self._active[slot] = False
        self._token[slot] = 0
        self._pos[slot] = 0
        self._draw_idx[slot] = 0
        self._temp[slot] = 1.0
        self._kpm[slot] = _KPM_OFF
        if req.future is not None and not req.future.done():
            req.future.set_result(req)

    def run(self, requests: Sequence[Request] = ()) -> List[Request]:
        """Synchronous drain: submit, then interleave admission and decode
        steps until queue and slots are empty."""
        out = [self.submit_nowait(r) for r in requests]
        while not self.scheduler.idle:
            self._admit()
            self.step_once()
        return out

    # -- asyncio surface ---------------------------------------------------

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._wake = asyncio.Event()
        self._loop_task = asyncio.create_task(self._serve_loop())

    async def stop(self) -> None:
        self._running = False
        if self._wake is not None:
            self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None

    async def drain(self) -> None:
        """Wait until every admitted request has finished."""
        while not self.scheduler.idle:
            await asyncio.sleep(0.001)

    async def _serve_loop(self) -> None:
        while self._running:
            if self.scheduler.idle:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.02)
                except asyncio.TimeoutError:
                    pass
                continue
            self._admit()
            self.step_once()
            # the step blocks this coroutine; yield so submissions whose
            # arrival times passed during it get admitted next iteration
            await asyncio.sleep(0)

    # -- introspection ------------------------------------------------------

    def warmup(self, max_prompt_len: int = 16, max_new_tokens: int = 2) -> None:
        """Run every prefill bucket up to ``max_prompt_len`` and a few
        decode steps (plans resolved, the card's first launches done), then
        reset the metrics."""
        lens, n = [], 1
        while n < max(1, max_prompt_len - 1):
            lens.append(n + 1)  # prefix of length n -> bucket n
            n *= 2
        lens.append(max(1, max_prompt_len))
        self.run([
            Request(prompt=np.zeros((ln,), np.int32), max_new_tokens=max_new_tokens, seed=i)
            for i, ln in enumerate(lens)
        ])
        self.reset_metrics()

    def reset_metrics(self) -> None:
        self.step_times.clear()
        self.prefill_times.clear()
        self._steps = 0
        self._tokens_out = 0

    def compile_stats(self) -> Dict:
        """The plan counters (``sampling.plan_stats()``: one autotune
        resolution per workload) and the prefill buckets seen.  Nothing is
        compiled here; the reference counts its jit caches in this place."""
        return {
            "prefill_buckets": sorted(self._buckets),
            "plan_stats": sampling.plan_stats(),
        }

    def stats(self) -> Dict:
        sched = self.scheduler.stats
        return {
            **sched,
            "steps": self._steps,
            "tokens_out": self._tokens_out,
            "waiting": self.scheduler.waiting_depth,
            "active": self.scheduler.active_slots,
            "max_slots": self.max_slots,
        }
