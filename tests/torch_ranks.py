"""Spawned gloo groups for the port's distributed tests (imported by the
``test_torch_*`` files; not a test module itself).

``run_ranks(worker, tmp_path, world)`` runs ``worker(rank, world, out_dir)``
in ``world`` spawned processes that form one gloo group over a
``FileStore`` under ``tmp_path`` (no TCP port, safe under xdist), with
``REPRO_TORCH_DEVICE=cpu``; any rank's traceback fails the test, and the
first rank that fails ends the others.  Workers
must be importable module-level functions of a module that imports no
JAX at the top (children import it to unpickle the worker)."""

import multiprocessing
import os
import socket
import time
import traceback

import torch
import torch.distributed as dist


def run_ranks(worker, tmp_path, world, timeout=240, args=()):
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main, args=(worker, r, world, store, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails ends the group: its peers would wait on it
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    msgs = [e.read_text() for e in (tmp_path / f"rank{r}.err" for r in range(world))
            if e.exists()]
    assert not msgs, "\n".join(msgs)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def _rank_main(worker, rank, world, store, out_dir, args):
    os.environ["REPRO_TORCH_DEVICE"] = "cpu"
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
        try:
            worker(rank, world, out_dir, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def free_port() -> int:
    """A free loopback TCP port (for the REPRO_COORDINATOR contract)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
