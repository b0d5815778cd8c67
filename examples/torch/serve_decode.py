"""Serve a small LM on the PyTorch/CUDA port with batched requests: prefill
plus a decode loop whose token sampler IS the paper's technique (butterfly
partial sums over the vocabulary's categorical).

    PYTHONPATH=src python examples/torch/serve_decode.py [--arch qwen3-4b] [--new 24] [--device cpu]

Uses the reduced smoke config of the chosen arch.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SamplerSpec
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.serve import generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--method", default="butterfly")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # the engine plans this spec once per (batch, vocab) workload and each
    # decode step draws through the plan
    cfg = dataclasses.replace(get_config(args.arch, smoke=True),
                              sampler=SamplerSpec(method=args.method, W=8))
    model = build_model(cfg)
    params = init_params(0, model.specs, torch.float32, device=dev)
    rng = np.random.default_rng(0)

    def tokens(n):
        return torch.tensor(rng.integers(0, cfg.vocab_size, (args.batch, n)), dtype=torch.int32,
                            device=dev)

    def embeds(n):
        return torch.tensor(rng.normal(size=(args.batch, n, cfg.d_model)), dtype=torch.float32,
                            device=dev)

    if cfg.encoder_layers > 0:
        batch = {"src_embeds": embeds(8), "tgt_tokens": tokens(args.prompt_len)}
    elif cfg.frontend_len > 0:
        batch = {"tokens": tokens(args.prompt_len), "frontend_embeds": embeds(cfg.frontend_len)}
    else:
        batch = {"tokens": tokens(args.prompt_len)}

    t0 = time.perf_counter()
    result = generate(model, params, batch, max_new_tokens=args.new,
                      temperature=args.temperature,
                      generator=torch.Generator(device=dev).manual_seed(1))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} sampler={args.method} device={dev.type}")
    print(f"generated {tuple(result.tokens.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s, first calls included)")
    for b in range(args.batch):
        print(f"  seq {b}: {result.tokens[b].tolist()}")


if __name__ == "__main__":
    main()
