"""Training driver, the counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch llama3-8b --steps 200 \\
        --ckpt-dir /tmp/ckpt --smoke            # CPU-sized model
    python -m repro_torch.launch.train --app lda      # the paper's application
    python -m repro_torch.launch.train --coordinator 127.0.0.1:8765 ...
                                                      # one of N processes

Wires together: config registry -> model -> sharding rules -> optimizer ->
fault-tolerant checkpoint loop (async save, preemption hook, straggler
monitor, deterministic pipeline cursor).  Multi-process runs bring up
``torch.distributed`` through :func:`repro_torch.dist.multihost.init_from_env`
(``--coordinator`` or the ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` env contract); every rank runs this same loop, takes
its own rows of each batch, writes its own checkpoint shards and beats its
own heartbeat mailbox; rank 0 also polls the mailboxes to drive the
:class:`~repro_torch.dist.monitor.StepMonitor`.  With no coordinator the
same code runs on a one-rank group (``launch.mesh.make_host_mesh``).

The run's device is ``$REPRO_TORCH_DEVICE`` (``cuda`` by default; ``cpu``
runs gloo groups and the plain kernel versions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import multihost
from repro_torch.dist import sharding as shd
from repro_torch.dist.fault import CheckpointManager, install_preemption_handler, preempted
from repro_torch.dist.heartbeat import MonitorFeeder, open_mailbox
from repro_torch.dist.monitor import StepMonitor


def host_float(x) -> float:
    """A 0-d tensor or DTensor as a host float."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return float(x)


def batch_on_mesh(mesh, batch, device):
    """This rank's rows of a global numpy batch, as global tensors
    row-sharded over the mesh's data axes (every rank's pipeline makes
    the same global batch)."""
    from repro_torch.sampling import sharded

    lay = sharded._layout(mesh)
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // lay.shards
        rows = torch.as_tensor(v[lay.index * n:(lay.index + 1) * n], device=device)
        out[k] = multihost.host_local_rows_to_global(mesh, rows)
    return out


def train_lm(args, on_step=None, on_restore=None):
    """The LM training loop: build, place, restore-if-possible, step.

    Every rank executes this identical loop; DTensor collectives,
    per-rank checkpoint shards and heartbeat mailboxes keep them coherent,
    with no rank-specific branch beyond "rank 0 prints and polls the
    monitor".  ``on_step(step, batch, metrics)`` and ``on_restore(tree, extra)`` are
    hooks for a caller that inspects the run.  Returns a dict: the final
    ``params`` and ``opt`` state, ``start`` step, per-step ``losses`` and
    ``step_s``, checkpoint ``saves`` / ``restore`` figures, the monitor
    ``summary`` and ``preempted``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model, init_params, logical_axes
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import make_train_step

    info = multihost.init_from_env(coordinator=args.coordinator or None)
    is_lead = info.process_index == 0
    device = multihost.launch_device()

    def say(*a):
        if is_lead:
            print(*a, flush=True)

    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", seq_len=args.seq_len, global_batch=args.batch, kind="train")
    model = build_model(cfg)
    mesh = make_host_mesh(model=args.tp, device=device)
    params = init_params(args.seed, model.specs, torch.float32, device)
    opt = make_optimizer(args.optimizer, lr=args.lr, warmup=args.warmup,
                         total_steps=args.steps)
    opt_state = opt.init(params)

    # Place params/optimizer state through the rules engine; the same
    # sharding trees make restore elastic (repro_torch.dist.fault).
    param_axes = logical_axes(model.specs)
    param_sh = shd.tree_shardings(params, param_axes, mesh)
    opt_sh = shd.tree_shardings(opt_state, shd.optimizer_state_axes(args.optimizer, param_axes),
                                mesh)
    params = shd.device_put(params, param_sh)
    opt_state = shd.device_put(opt_state, opt_sh)
    shd.set_activation_sharding(mesh if mesh.size() > 1 else None)

    pipe = TokenPipeline(cfg, shape, seed=args.seed)
    step_fn = make_train_step(model, opt, remat=args.remat)

    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    monitor = StepMonitor(num_hosts=info.process_count,
                          heartbeat_timeout=args.heartbeat_timeout)
    # heartbeats go through shared storage only in a multi-process run;
    # otherwise the in-process mailbox (same code path)
    hb_dir = args.heartbeat_dir or (
        os.path.join(args.ckpt_dir, "heartbeats")
        if args.ckpt_dir and info.is_multiprocess else "")
    mailbox = open_mailbox(hb_dir or None, host=info.process_index)
    feeder = MonitorFeeder(monitor, mailbox) if is_lead else None
    install_preemption_handler()

    out = {"losses": {}, "step_s": {}, "saves": [], "restore": None, "preempted": False}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def save(step, block=False):
        t0 = time.perf_counter()
        mgr.save(step, {"params": params, "opt": opt_state},
                 extra={"cursor": pipe.cursor(), "step": step}, block=block, mesh=mesh)
        if block:
            mgr.wait()
        d = mgr._step_dir(step) if block else None
        out["saves"].append({
            "step": step, "seconds": time.perf_counter() - t0, "blocking": bool(block),
            "bytes": sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            if d and os.path.isdir(d) else None,
            "files": sorted(os.listdir(d)) if d and os.path.isdir(d) else None})

    start = 0
    if mgr and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        restored, extra = mgr.restore(like={"params": params, "opt": opt_state},
                                      shardings={"params": param_sh, "opt": opt_sh})
        sync()
        st = mgr.restore_stats()
        out["restore"] = {"seconds": time.perf_counter() - t0, "bytes": st["bytes_read"],
                          "files": st["files_read"], "step": st["step"]}
        params, opt_state = restored["params"], restored["opt"]
        if on_restore is not None:
            on_restore(restored, extra)
        pipe.restore(extra["cursor"])
        start = extra["step"]
        say(f"resumed from step {start}")
    out["start"] = start

    with implicit_replication():
        for step in range(start, args.steps):
            batch_np = pipe.next_batch()
            batch = batch_on_mesh(mesh, batch_np, device)
            sync()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch, step)
            params = shd.constrain_tree(params, param_sh)
            opt_state = shd.constrain_tree(opt_state, opt_sh)
            loss = host_float(m.loss)   # the step's host sync
            dt = time.perf_counter() - t0
            tokens = host_float(m.tokens)
            out["losses"][step], out["step_s"][step] = loss, dt
            mailbox.beat(step=step, step_time=dt, tokens=tokens)
            if feeder is not None:
                feeder.poll(now=time.time())
                dead = monitor.dead_hosts(now=time.time())
                if dead:
                    say(f"WARNING: hosts {dead} missed heartbeats for "
                        f">{monitor.heartbeat_timeout:.0f}s")
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:.4f} ce {host_float(m.ce):.4f} "
                    f"gnorm {host_float(m.grad_norm):.2f} {dt * 1e3:.0f}ms "
                    f"({tokens / dt:.0f} tok/s)")
            if on_step is not None:
                on_step(step, batch_np, m)
            save_now = mgr and (step % args.ckpt_every == 0 and step > start)
            if mgr and (save_now or preempted()):
                if preempted():
                    save(step + 1, block=True)
                    say(f"preempted; checkpoint committed at step {step + 1}")
                    out.update(params=params, opt=opt_state, preempted=True,
                               summary=monitor.summary())
                    return out
                save(step + 1)
    if mgr:
        save(args.steps, block=True)
    summary = monitor.summary()
    if args.monitor_out and is_lead:
        with open(args.monitor_out, "w") as f:
            json.dump({"summary": summary, "hosts": monitor.summary_rows()}, f, indent=2)
        say(f"monitor summary written to {args.monitor_out}")
    say("training complete;", summary)
    out.update(params=params, opt=opt_state, summary=summary)
    return out


def train_lda(args):
    """The LDA Gibbs loop (the paper's application) on a synthetic corpus,
    at ``configs.lda``'s ``SMOKE`` or ``CONFIG``.  Returns the final state, the per-sweep seconds and perplexities."""
    from repro_torch.configs.lda import CONFIG as LDA_FULL, SMOKE as LDA_SMOKE
    from repro_torch.lda import gibbs_step, init_state, perplexity, synthesize_corpus

    device = multihost.launch_device()
    c = LDA_SMOKE if args.smoke else LDA_FULL
    corpus = synthesize_corpus(seed=args.seed, M=c.M, V=c.V, K=c.K, avg_len=70.5)
    state = init_state(args.seed, corpus, c.K, device=device)
    sweeps = []
    for it in range(args.steps):
        t0 = time.perf_counter()
        state = gibbs_step(state, corpus, alpha=c.alpha, beta=c.beta,
                           method=c.sampler_method, W=c.sampler_W)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        ppl = None
        if it % args.log_every == 0:
            ppl = perplexity(state, corpus)
            print(f"iter {it:4d} perplexity {ppl:.1f} {dt * 1e3:.0f}ms", flush=True)
        sweeps.append({"seconds": dt, "perplexity": ppl})
    print("gibbs complete", flush=True)
    return {"state": state, "sweeps": sweeps, "config": c}


def parser() -> argparse.ArgumentParser:
    """The reference's flags, one for one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="lm", choices=["lm", "lda"])
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw8bit", "adafactor"])
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (mesh = (ranks/tp, tp))")
    ap.add_argument("--monitor-out", default="",
                    help="write the StepMonitor summary JSON here")
    ap.add_argument("--coordinator", default="",
                    help="host:port of rank 0's TCP store (or set REPRO_COORDINATOR; "
                         "empty = single-process)")
    ap.add_argument("--heartbeat-dir", default="",
                    help="shared mailbox dir for cross-rank heartbeats "
                         "(default: <ckpt-dir>/heartbeats in multi-process runs)")
    ap.add_argument("--heartbeat-timeout", type=float, default=60.0,
                    help="seconds without a heartbeat before a rank is declared dead")
    return ap


def main(argv=None):
    """CLI entry point: parse flags, dispatch to the LM or LDA loop."""
    args = parser().parse_args(argv)
    if args.app == "lda":
        train_lda(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()
