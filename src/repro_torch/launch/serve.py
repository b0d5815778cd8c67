"""Serving driver: batched request decoding with the butterfly sampler, the
counterpart of ``repro.launch.serve``.

    python -m repro_torch.launch.serve --arch qwen3-4b --smoke --requests 8
    python -m repro_torch.launch.serve --smoke --dp 2 --tp 2   # sharded decode
    python -m repro_torch.launch.serve --smoke --continuous    # slot-recycled engine

``--dp/--tp`` build a (data, model) mesh (``smallest_fitting_mesh``),
place the params through the ``repro_torch.dist.sharding`` rules, arm
activation constraints, and draw through the sharded counter-RNG path
(``sampling.plan(mesh=...)``): tokens are the same at any ``--dp`` for a
fixed key.  Without ``--dp`` the draws come from a ``torch.Generator``
(the port's unsharded stream; ROADMAP.md deliberate differences).

``--continuous`` serves the same requests through the continuous-batching
engine (``repro_torch.serve.batching``) instead of lockstep ``generate``:
varying prompt/output lengths and per-request sampling params churn
through ``ServeSpec.max_slots`` recycled slots.  Composes with
``--dp/--tp`` (decoder-only archs only).

As in the reference, ``--smoke`` defaults to True, and ``--sampler``
sets the config's legacy ``sampler_method``, which a config with a
``SamplerSpec`` (``sampler=``) does not read.  :func:`run` is what the CLI
calls; a caller may hand it another config (the full one).  The run's
device is ``$REPRO_TORCH_DEVICE`` (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import multihost
from repro_torch.dist import sharding as shd


def parser() -> argparse.ArgumentParser:
    """The reference's flags, one for one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--sampler", default="butterfly",
                    choices=["butterfly", "fenwick", "two_level", "kernel", "prefix", "gumbel"])
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel degree (0 = no mesh, single device)")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel degree")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(slot recycling, per-request sampling params)")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots for --continuous (0 = ServeSpec default)")
    return ap


def requests(args, cfg):
    """The ``--continuous`` request mix (the reference's, from seed 0)."""
    from repro_torch.serve import Request, SamplingParams

    rng = np.random.default_rng(0)
    mix = (
        SamplingParams(temperature=0.0),
        SamplingParams(temperature=args.temperature, top_k=40),
        SamplingParams(temperature=args.temperature, top_p=0.9),
        SamplingParams(temperature=args.temperature, min_p=0.05),
    )
    return [
        Request(prompt=rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(1, args.prompt_len + 1))).astype(np.int32),
                max_new_tokens=int(rng.integers(1, args.max_new + 1)), seed=i,
                sampling=mix[i % len(mix)])
        for i in range(args.requests)
    ]


def run(args, cfg=None, params=None):
    """Serve ``args.requests`` requests; returns a dict of the results
    (``tokens`` per request, ``seconds``, ``steps``, ``mesh``, the engine
    or the generation result).  ``cfg`` defaults to
    ``get_config(args.arch, smoke=args.smoke)``; ``params`` to
    ``init_params(0, ...)`` in float32 (the reference's)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import smallest_fitting_mesh
    from repro_torch.models import build_model, init_params, logical_axes
    from repro_torch.serve.engine import generate

    multihost.init_from_env()
    device = multihost.launch_device()
    base = cfg or get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(base, sampler_method=args.sampler,
                              sampler_W=8 if args.smoke else 32)
    model = build_model(cfg)
    if params is None:
        params = init_params(0, model.specs, torch.float32, device)
    rng = np.random.default_rng(0)
    B = args.requests

    mesh = None
    ctx = contextlib.nullcontext()
    if args.dp > 0:
        if B % args.dp:
            raise SystemExit(f"--requests {B} must divide by --dp {args.dp}")
        mesh = smallest_fitting_mesh(data=args.dp, model=args.tp, device=device)
        params = shd.device_put(params, shd.tree_shardings(params, logical_axes(model.specs),
                                                           mesh))
        shd.set_activation_sharding(mesh)
        ctx = implicit_replication()
        print(f"mesh: {shd.mesh_shape(mesh)}", flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if args.continuous:
        from repro_torch.serve import ContinuousBatchingEngine

        reqs = requests(args, cfg)
        eng = ContinuousBatchingEngine(
            model, params, max_slots=args.slots or None,
            max_len=args.prompt_len + args.max_new, max_waiting=B,
            temperature=args.temperature, mesh=mesh)
        eng.warmup(max_prompt_len=args.prompt_len)
        sync()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        sync()
        dt = time.perf_counter() - t0
        toks = sum(len(r.output_tokens) for r in done)
        st = eng.stats()
        print(f"served {len(done)} requests ({toks} tokens) through {eng.max_slots} slots "
              f"in {dt:.2f}s ({toks / dt:.0f} tok/s, {st['steps']} steps); "
              f"prefill buckets: {eng.compile_stats()['prefill_buckets']}", flush=True)
        print(f"first request: {done[0].output_tokens}", flush=True)
        return {"tokens": [list(r.output_tokens) for r in done], "seconds": dt,
                "steps": st["steps"], "tokens_out": toks, "engine": eng, "mesh": mesh,
                "model": model, "params": params}

    if cfg.encoder_layers > 0:
        batch = {
            "src_embeds": torch.as_tensor(rng.normal(size=(B, 8, cfg.d_model)),
                                          dtype=torch.float32, device=device),
            "tgt_tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, args.prompt_len)),
                                          dtype=torch.int32, device=device),
        }
    elif cfg.frontend_len > 0:
        batch = {
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, args.prompt_len)),
                                      dtype=torch.int32, device=device),
            "frontend_embeds": torch.as_tensor(
                rng.normal(size=(B, cfg.frontend_len, cfg.d_model)), dtype=torch.float32,
                device=device),
        }
    else:
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                        (B, args.prompt_len)),
                                           dtype=torch.int32, device=device)}

    sync()
    t0 = time.perf_counter()
    with ctx:
        res = generate(model, params, batch, max_new_tokens=args.max_new,
                       temperature=args.temperature, mesh=mesh, key=1)
    sync()
    dt = time.perf_counter() - t0
    print(f"served {B} requests x {res.steps} tokens in {dt:.2f}s "
          f"(sampler={args.sampler}); first request: {res.tokens[0].tolist()}", flush=True)
    return {"tokens": res.tokens.tolist(), "seconds": dt, "steps": res.steps,
            "tokens_out": int(res.tokens.size), "result": res, "mesh": mesh, "model": model,
            "params": params}


def main(argv=None):
    """CLI: run a small closed-loop serve session and print stats."""
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
