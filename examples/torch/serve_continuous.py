"""Continuous batching on the PyTorch/CUDA port: mixed per-request sampling
parameters through one decode step.

Ten requests (different prompt lengths, token budgets, seeds, and sampling
settings: greedy, top-k, nucleus, min-p) are submitted to a 2-layer toy
model's engine over asyncio, churn through 4 recycled decode slots, and
finish with per-request TTFT and latency.  The plan counters at the end
show one sampler resolution per workload, whatever the mix.

    PYTHONPATH=src python examples/torch/serve_continuous.py [--device cpu]
"""

import argparse
import asyncio

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SamplerSpec
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.serve import ContinuousBatchingEngine, Request, SamplingParams

CFG = ModelConfig(
    name="toy", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256,
    sampler=SamplerSpec(method="butterfly", W=16),
)


async def serve(dev):
    model = build_model(CFG)
    params = init_params(0, model.specs, torch.float32, device=dev)
    engine = ContinuousBatchingEngine(model, params, max_slots=4, max_len=64, eos_id=None)
    engine.warmup(max_prompt_len=16)

    mix = [
        ("greedy", SamplingParams(temperature=0.0)),
        ("top-k 20", SamplingParams(temperature=0.8, top_k=20)),
        ("nucleus .9", SamplingParams(temperature=1.0, top_p=0.9)),
        ("min-p .05", SamplingParams(temperature=1.2, min_p=0.05)),
        ("hot + tight", SamplingParams(temperature=1.5, top_k=10, top_p=0.8)),
    ]
    rng = np.random.default_rng(0)
    await engine.start()
    reqs = []
    for i in range(10):
        label, sp = mix[i % len(mix)]
        req = Request(prompt=rng.integers(0, CFG.vocab_size, int(rng.integers(1, 12))),
                      max_new_tokens=int(rng.integers(4, 16)), seed=i, sampling=sp)
        reqs.append((label, await engine.submit(req)))
    await asyncio.gather(*(r.future for _, r in reqs))
    await engine.stop()

    for label, r in reqs:
        print(f"req {r.id:2d} [{label:>11s}] prompt {r.prompt_len:2d} "
              f"ttft {r.ttft * 1e3:6.1f} ms  e2e {r.e2e_latency * 1e3:6.1f} ms  "
              f"-> {r.output_tokens}")
    cs = engine.compile_stats()
    print(f"\n{engine.stats()['finished']} requests through {engine.max_slots} slots; "
          f"prefill buckets {cs['prefill_buckets']}; plans {cs['plan_stats']}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    asyncio.run(serve(resolve_device(ap.parse_args().device)))


if __name__ == "__main__":
    main()
