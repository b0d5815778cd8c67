"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter LM
(llama3 geometry at 12L x 768) with the production loop: AdamW and its
schedule, full remat, async checkpoints, a preemption hook, resume.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300 [--device cpu]
    # kill it mid-run and run it again: it resumes from the last checkpoint.

``--smoke`` trains a 2-layer, 64-wide model of the same family instead.
Checkpoints go to ``--ckpt-dir``, by default ``checkpoints/train_lm/<the
model's name>`` under the working directory, so the two models never
restore each other's; give each run that must not resume another its own
directory.
"""

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.dist.fault import CheckpointManager, install_preemption_handler, preempted
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import build_model, init_params, param_count
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step

CFG_100M = ModelConfig(
    name="llama-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
    rope_theta=500_000.0, tie_embeddings=True,
)
SMOKE = dataclasses.replace(CFG_100M, name="llama-smoke", num_layers=2, d_model=64,
                            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                            vocab_size=512)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: checkpoints/train_lm/<the model's name>")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="a 2-layer, 64-wide model")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = SMOKE if args.smoke else CFG_100M
    model = build_model(cfg)
    print(f"model: {cfg.name}, {param_count(model.specs) / 1e6:.1f}M params on {dev.type}")
    shape = ShapeConfig("cli", seq_len=args.seq_len, global_batch=args.batch, kind="train")
    params = init_params(0, model.specs, torch.float32, device=dev)
    opt = make_optimizer("adamw", lr=6e-4, warmup=50, total_steps=args.steps)
    opt_state = opt.init(params)
    pipe = TokenPipeline(cfg, shape, seed=0)
    step_fn = make_train_step(model, opt, remat="full")
    mgr = CheckpointManager(args.ckpt_dir or os.path.join("checkpoints", "train_lm", cfg.name),
                            keep=2)
    install_preemption_handler()

    start = 0
    if mgr.latest_step() is not None:
        restored, extra = mgr.restore(like={"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        pipe.restore(extra["cursor"])
        start = extra["step"]
        print(f"resumed from step {start}")

    t_start = time.perf_counter()
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.next_batch().items()}
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        if step % 20 == 0 or step == args.steps - 1:
            loss = float(m.loss)   # syncs the step
            dt = (time.perf_counter() - t_start) / max(step - start + 1, 1)
            print(f"step {step:4d} loss {loss:.4f} gnorm {float(m.grad_norm):6.2f} "
                  f"{dt * 1e3:6.0f} ms/step")
        if (step > start and step % args.ckpt_every == 0) or preempted():
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"cursor": pipe.cursor(), "step": step + 1})
            if preempted():
                mgr.wait()
                print(f"preempted; checkpoint committed at step {step + 1}")
                return
    mgr.save(args.steps, {"params": params, "opt": opt_state},
             extra={"cursor": pipe.cursor(), "step": args.steps}, block=True)
    print("done")


if __name__ == "__main__":
    main()
