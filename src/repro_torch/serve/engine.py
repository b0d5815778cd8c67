"""Serving engine: batched prefill + decode with the butterfly sampler, the
counterpart of ``repro.serve.engine``.

Token sampling from a vocab-sized categorical per sequence is the paper's
setting (K = vocab, one distribution per batch row, each table used once).
The engine draws through a :class:`repro_torch.sampling.SamplerPlan`:
``ModelConfig.sampler_spec`` is resolved through ``repro_torch.autotune``
once per (B, vocab) workload, and every step draws through the plan.  A
``kernel`` plan with a truncation chain runs the truncated draw of
``kernels.butterfly_sample``: K9 for one token a row, tau then K11 and K12
for several (``num_samples > 1``).

Sharded decode (``make_decode_step(..., mesh=mesh)``) row-shards the
sequences over the mesh's data axes and samples per shard with counter
uniforms (K5, or K10 under a chain, for a ``kernel`` plan): no collective
on the draw path, and the tokens gathered back whole.

Differences from the reference, kept deliberately: key-driven draws take
a ``torch.Generator`` (a sharded step a counter-RNG ``key``: a (2,)
uint32 pair or an int); nothing is traced or compiled, so
``step.plain_cache_size`` / ``step.trunc_cache_size`` count the distinct
(shape, truncation signature) workloads the step has seen; a decode step
writes into the caches it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import sampling
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import whole
from repro_torch.kernels import rng as _rng
from repro_torch.models.model import Model
from repro_torch.sampling import transforms as _tr


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, max_new)
    steps: int
    prefill_len: int


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode sampling controls.  Each field is a scalar or a
    per-row (B,) tensor (request i gets its own top-p).

    ``temperature=None`` (the default) defers to the engine's
    ``temperature`` argument; a value overrides it and must be > 0 (greedy
    decode is the engine's ``temperature=0``).  ``top_k=0`` /
    ``top_p=1.0`` / ``min_p=0.0`` disable the respective truncation — per
    row, when tensors."""

    temperature: object = None
    top_k: object = 0
    top_p: object = 1.0
    min_p: object = 0.0

    def transforms(self):
        """The truncation chain (canonical top-k -> top-p -> min-p; the
        temperature is threaded separately so greedy stays decidable)."""
        return _tr.chain(top_k=self.top_k, top_p=self.top_p, min_p=self.min_p)


def _sp_sig(sp: Optional[SamplingParams]) -> str:
    """The transforms signature a SamplingParams actually runs (statically
    disabled stages are dropped by ``transforms.chain``), for the plan memo
    key and the autotune bucket."""
    if sp is None:
        return ""
    return _tr.signature(sp.transforms())


def default_sampling_params(cfg: ModelConfig) -> Optional[SamplingParams]:
    """The config's model-card decode defaults lifted into
    ``SamplingParams`` — ``None`` when the spec doesn't truncate (plain
    temperature decode keeps the untruncated path)."""
    spec = cfg.sampler_spec
    if not spec.truncates:
        return None
    return SamplingParams(top_k=spec.top_k, top_p=spec.top_p, min_p=spec.min_p)


def _logits_plan(cfg: ModelConfig, B: int, V: int, dtype_name: str, draws: int = 1,
                 mesh=None, transforms: str = "", backend: Optional[str] = None):
    """The config's sampler spec, planned for a (B, V) logits workload.

    ``sampling.plan`` memoizes process-wide: the first sighting of a
    workload resolves autotune, later ones are a dictionary hit.
    ``draws`` is the per-distribution reuse hint (multi-draw decode);
    ``mesh`` makes the plan sharded; ``transforms`` is the truncation
    chain's signature (it joins the autotune bucket; values stay out);
    ``backend`` is the logits' device type (``None``: the card if present)."""
    spec = cfg.sampler_spec
    return sampling.plan(
        (B, V), method=spec.method, W=spec.W or None, dtype=dtype_name,
        draws=max(spec.draws, draws), has_key=True, mesh=mesh,
        transforms=transforms, backend=backend,
    )


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


# sentinel distinguishing "``sampling`` not given -> factory defaults"
# from an explicit ``sampling=None`` -> plain untruncated decode
_SP_UNSET = object()


def _chain_for(sp: SamplingParams, sig: str):
    """The truncation chain matching the signature ``sig``, carrying this
    call's parameter values; stages outside the signature are dropped."""
    out = []
    if "k" in sig:
        out.append(_tr.TopK(sp.top_k))
    if "p" in sig:
        out.append(_tr.TopP(sp.top_p))
    if "m" in sig:
        out.append(_tr.MinP(sp.min_p))
    return tuple(out)


def make_decode_step(
    model: Model,
    temperature: float = 1.0,
    batch_size: Optional[int] = None,
    num_samples: int = 1,
    mesh=None,
    sampling_params: Optional[SamplingParams] = None,
):
    """Decode step: ``step(params, caches, token, pos, rng[, sampling])`` ->
    (next_token(s), logits, caches).

    ``rng`` is a ``torch.Generator`` on the logits' device (``None``: the
    default generator); with ``mesh`` it is the counter-RNG key of the
    sharded draw (a (2,) uint32 pair or an int).  When ``batch_size`` is
    known up front the sampler plan (and autotune) is resolved before the
    first step.

    ``num_samples > 1`` draws that many candidate tokens per sequence from
    one distribution: the step returns (B, num_samples), the plan is
    resolved with the reuse hint ``draws=num_samples``, and a ``kernel``
    plan under a chain walks all B * num_samples draws in one K12 launch.

    ``sampling``: omitted, the step falls back to ``sampling_params``
    (else the config's ``SamplerSpec`` top_k / top_p / min_p defaults,
    else plain untruncated decode); ``sampling=None`` forces the plain
    path for that call; a :class:`SamplingParams` runs truncated decode
    with that call's parameters (scalars or per-row (B,) tensors).  The
    chain's stages are derived from each call's parameters, never carried
    over from an earlier call."""
    cfg = model.cfg
    sp0 = sampling_params if sampling_params is not None else default_sampling_params(cfg)
    if batch_size is not None:
        _logits_plan(cfg, batch_size, cfg.padded_vocab, "float32", draws=num_samples,
                     mesh=mesh, transforms=_sp_sig(sp0))
    seen = {"plain": set(), "trunc": set()}

    def _shape(nxt, logits, caches):
        nxt = whole(nxt).to(torch.int32)
        if num_samples == 1:
            return nxt[:, None], logits, caches
        return nxt.T, logits, caches  # (B, num_samples)

    def _draw(p, logits, rng, temp, tr):
        if mesh is not None:
            return p.sample_logits(logits, temperature=temp, num_samples=num_samples,
                                   transforms=tr, key=rng)
        return p.sample_logits(logits, rng, temperature=temp, num_samples=num_samples,
                               transforms=tr)

    def step(params, caches, token, pos, rng=None, sampling=_SP_UNSET):
        sp = sp0 if sampling is _SP_UNSET else sampling
        sig = _sp_sig(sp) if sp is not None else ""
        logits, caches = model.decode(params, caches, token, pos)
        if mesh is None:   # an unsharded draw takes DTensor logits whole
            logits = whole(logits)
        p = _logits_plan(cfg, logits.shape[0], logits.shape[1], _dtype_name(logits),
                         draws=num_samples, mesh=mesh, transforms=sig,
                         backend=logits.device.type)
        workload = (tuple(token.shape), _dtype_name(logits), sig)
        if sp is None:
            seen["plain"].add(workload)
            return _shape(_draw(p, logits, rng, temperature, None), logits, caches)
        seen["trunc"].add(workload)
        temp = sp.temperature if sp.temperature is not None else temperature
        tr = _chain_for(sp, sig)
        return _shape(_draw(p, logits, rng, temp, tr or None), logits, caches)

    step.plain_cache_size = lambda: len(seen["plain"])
    step.trunc_cache_size = lambda: len(seen["trunc"])
    return step


# cache leaves with a (L, B, S, ...) sequence axis (axis 2)
_SEQ_CACHE_LEAVES = frozenset({"k", "v", "c_kv", "k_pe", "self_k", "self_v"})


def _seq_leaves(tree, name=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _seq_leaves(v, k)
    elif name in _SEQ_CACHE_LEAVES:
        yield tree


def _pad_caches_to(caches, target_len: int):
    """Grow attention caches (L, B, S, ...) along the seq axis to target.

    Caches already at (or beyond) ``target_len`` are returned as they are —
    the identical tree — so callers can re-pad unconditionally."""
    if all(leaf.shape[2] >= target_len for leaf in _seq_leaves(caches)):
        return caches

    def pad(tree, name=None):
        if isinstance(tree, dict):
            return {k: pad(v, k) for k, v in tree.items()}
        if name in _SEQ_CACHE_LEAVES and tree.shape[2] < target_len:
            pads = [0, 0] * (tree.dim() - 3) + [0, target_len - tree.shape[2]]
            return F.pad(tree, pads)
        return tree

    return pad(caches)


def _params_device(params) -> torch.device:
    leaf = params
    while isinstance(leaf, dict):
        leaf = leaf[sorted(leaf)[0]]
    return leaf.device


def generate(
    model: Model,
    params,
    batch: Dict,
    max_new_tokens: int = 16,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
    eos_id: Optional[int] = None,
    mesh=None,
    key=0,
) -> GenerationResult:
    """Prefill the prompt batch, then decode ``max_new_tokens`` greedily or
    by sampling, one step at a time.

    Draws come from ``generator`` (a ``torch.Generator`` on the params'
    device; ``None``: one seeded with 0).  ``mesh`` shards the decode
    sampler like :func:`make_decode_step`; its draws come from the counter
    RNG, step t's key ``fold(key, t)``.  The prompt batch must divide by
    the data-shard count."""
    cfg = model.cfg
    dev = _params_device(params)
    if generator is None and mesh is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    seed = _rng.seed_from_key(key)

    def rng(t):
        return generator if mesh is None else _rng.fold(seed, t)

    last_logits, caches = model.prefill(params, batch)
    toks = batch["tgt_tokens"] if "tgt_tokens" in batch else batch["tokens"]
    B, S = toks.shape
    prefix = cfg.meta_tokens + (
        batch["frontend_embeds"].shape[1] if "frontend_embeds" in batch else 0)
    prefill_len = S + prefix
    caches = _pad_caches_to(caches, prefill_len + max_new_tokens)

    step_fn = make_decode_step(model, temperature, batch_size=B, mesh=mesh)
    sp0 = default_sampling_params(cfg)  # model-card truncation, if any
    first_plan = _logits_plan(cfg, last_logits.shape[0], last_logits.shape[1],
                              _dtype_name(last_logits), mesh=mesh, transforms=_sp_sig(sp0),
                              backend=last_logits.device.type)
    tr = sp0.transforms() if sp0 else None
    if mesh is None:
        first = first_plan.sample_logits(last_logits, rng(0), temperature=temperature,
                                         transforms=tr)
    else:
        first = first_plan.sample_logits(last_logits, temperature=temperature,
                                         transforms=tr, key=rng(0))
    token = whole(first).to(torch.int32)[:, None]

    out = [token.cpu().numpy()]
    done = np.zeros((B,), bool)
    for t in range(max_new_tokens - 1):
        token, _, caches = step_fn(params, caches, token, prefill_len + t, rng(t + 1))
        arr = token.cpu().numpy()
        out.append(arr)
        if eos_id is not None:
            done |= arr[:, 0] == eos_id
            if done.all():
                break
    tokens = np.concatenate(out, axis=1)
    return GenerationResult(tokens=tokens, steps=tokens.shape[1], prefill_len=prefill_len)


def make_serve_step(
    model: Model, temperature: float = 1.0, batch_size: Optional[int] = None,
    mesh=None, sampling_params: Optional[SamplingParams] = None,
):
    """One fused decode+sample step as a function
    (params, caches, token, pos, rng) -> (next_token, caches).
    ``mesh`` shards the sampler like :func:`make_decode_step` (``rng`` is
    then the counter-RNG key); ``sampling_params`` (explicit only: the
    config's defaults are not applied here) bakes a truncation chain into
    the step."""
    cfg = model.cfg
    sig = _sp_sig(sampling_params)
    if batch_size is not None:
        _logits_plan(cfg, batch_size, cfg.padded_vocab, "float32", mesh=mesh,
                     transforms=sig)

    def serve_step(params, caches, token, pos, rng=None):
        logits, caches = model.decode(params, caches, token, pos)
        if mesh is None:   # an unsharded draw takes DTensor logits whole
            logits = whole(logits)
        p = _logits_plan(cfg, logits.shape[0], logits.shape[1], _dtype_name(logits),
                         mesh=mesh, transforms=sig, backend=logits.device.type)
        temp, tr = temperature, None
        if sampling_params is not None:
            if sampling_params.temperature is not None:
                temp = sampling_params.temperature
            tr = sampling_params.transforms() or None
        if mesh is None:
            nxt = p.sample_logits(logits, rng, temperature=temp, transforms=tr)
        else:
            nxt = p.sample_logits(logits, temperature=temp, transforms=tr, key=rng)
        return whole(nxt).to(torch.int32), caches

    return serve_step


def make_prefill_step(model: Model, temperature: float = 1.0,
                      batch_size: Optional[int] = None, mesh=None):
    """Prefill target: (params, batch, generator) -> (first_token, caches).
    ``mesh`` shards the first draw like :func:`make_serve_step` (the third
    argument is then the counter-RNG key)."""
    cfg = model.cfg
    if batch_size is not None:
        _logits_plan(cfg, batch_size, cfg.padded_vocab, "float32", mesh=mesh)

    def prefill_step(params, batch, generator=None):
        last_logits, caches = model.prefill(params, batch)
        if mesh is None:   # an unsharded draw takes DTensor logits whole
            last_logits = whole(last_logits)
        p = _logits_plan(cfg, last_logits.shape[0], last_logits.shape[1],
                         _dtype_name(last_logits), mesh=mesh,
                         backend=last_logits.device.type)
        if mesh is None:
            nxt = p.sample_logits(last_logits, generator, temperature=temperature)
        else:
            nxt = p.sample_logits(last_logits, temperature=temperature, key=generator)
        return whole(nxt).to(torch.int32), caches

    return prefill_step
