"""Multi-process runtime initialization on ``torch.distributed``, the
counterpart of ``repro.dist.multihost``.

One entry point, :func:`init_from_env`, turns a set of per-process
environment variables (or explicit arguments) into a connected
``torch.distributed`` process group with connect retry/backoff, and
degrades to a clean single-process no-op when no coordinator is
configured, so the same launcher command line works on one card and on a
fleet.

The environment contract (every process of one run sets all three)::

    REPRO_COORDINATOR    host:port of rank 0's TCP store
    REPRO_NUM_PROCESSES  world size (total process count)
    REPRO_PROCESS_ID     this process's rank in [0, num_processes)

Optional knobs::

    REPRO_CONNECT_TIMEOUT  total seconds to keep retrying (default 60)
    REPRO_CONNECT_BACKOFF  initial retry backoff seconds (default 0.5,
                           doubled per attempt, capped at 8)

The group's backend is NCCL when the run uses the card and gloo on the
CPU (:func:`launch_device`: ``REPRO_TORCH_DEVICE``, default ``cuda``).
A coordinator that cannot be reached raises ``TimeoutError`` after the
timeout; nothing falls back to a single process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional

import torch

_ENV_COORD = "REPRO_COORDINATOR"
_ENV_NPROC = "REPRO_NUM_PROCESSES"
_ENV_PID = "REPRO_PROCESS_ID"
_ENV_TIMEOUT = "REPRO_CONNECT_TIMEOUT"
_ENV_BACKOFF = "REPRO_CONNECT_BACKOFF"
# the device a launcher runs on: "cuda" (the default) or "cpu"
ENV_DEVICE = "REPRO_TORCH_DEVICE"

_BACKOFF_CAP = 8.0


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """What :func:`init_from_env` resolved: rank, world size, coordinator.

    ``initialized`` is True only when a process group was brought up (a
    multi-process run); single-process no-op runs get
    ``ProcessInfo(0, 1, None, False)``."""

    process_index: int
    process_count: int
    coordinator: Optional[str]
    initialized: bool

    @property
    def is_multiprocess(self) -> bool:
        """True when this run spans more than one process."""
        return self.process_count > 1


# repeated calls (launcher and library code both asking) are idempotent
_STATE: Optional[ProcessInfo] = None


def launch_device() -> torch.device:
    """The device a launcher runs on: ``$REPRO_TORCH_DEVICE`` (``cuda`` by
    default; a CUDA request without a card raises, no silent CPU run)."""
    from repro_torch.kernels import runtime

    return runtime.resolve_device(os.environ.get(ENV_DEVICE) or None)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def init_from_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout: Optional[float] = None,
    backoff: Optional[float] = None,
    backend: Optional[str] = None,
    _initialize=None,
) -> ProcessInfo:
    """Bring up ``torch.distributed`` from env vars, with retry/backoff.

    Explicit arguments override the ``REPRO_*`` environment variables (the
    launcher's ``--coordinator`` flag passes through here).  With no
    coordinator configured anywhere, or a world size of 1, this is a no-op.

    Each connect attempt gets the rest of the ``timeout`` budget; a failed
    attempt sleeps an exponentially growing backoff and tries again until
    the budget is spent, then raises ``TimeoutError`` naming the
    coordinator.  Idempotent: a second call returns the first call's
    :class:`ProcessInfo`.  ``backend`` defaults to NCCL on the card, gloo
    on the CPU.  ``_initialize`` is a test seam for
    ``torch.distributed.init_process_group``."""
    global _STATE
    if _STATE is not None:
        return _STATE

    coordinator = coordinator or os.environ.get(_ENV_COORD) or None
    if num_processes is None:
        num_processes = int(os.environ.get(_ENV_NPROC, "1"))
    if process_id is None:
        process_id = int(os.environ.get(_ENV_PID, "0"))
    if timeout is None:
        timeout = float(os.environ.get(_ENV_TIMEOUT, "60"))
    if backoff is None:
        backoff = float(os.environ.get(_ENV_BACKOFF, "0.5"))

    if coordinator is None or num_processes <= 1:
        _STATE = ProcessInfo(0, 1, None, False)
        return _STATE
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for num_processes {num_processes}")
    import torch.distributed as dist

    if _group_up():
        _STATE = ProcessInfo(dist.get_rank(), dist.get_world_size(), coordinator, True)
        return _STATE

    if _initialize is None:
        backend = backend or _backend(launch_device())
    initialize = _initialize or dist.init_process_group
    deadline = time.monotonic() + timeout
    delay = max(backoff, 1e-3)
    attempt = 0
    last_err: Optional[BaseException] = None
    while True:
        attempt += 1
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"could not join the torch.distributed coordinator at {coordinator!r} "
                f"as process {process_id}/{num_processes} within {timeout:.0f}s "
                f"({attempt - 1} attempts); last error: {last_err}")
        try:
            initialize(backend=backend, init_method=f"tcp://{coordinator}",
                       world_size=num_processes, rank=process_id,
                       timeout=datetime.timedelta(seconds=max(int(remaining), 1)))
            break
        except (RuntimeError, ValueError, ConnectionError) as e:
            last_err = e
            time.sleep(min(delay, max(deadline - time.monotonic(), 0)))
            delay = min(delay * 2, _BACKOFF_CAP)

    if _group_up():
        _STATE = ProcessInfo(dist.get_rank(), dist.get_world_size(), coordinator, True)
    else:   # the test seam brought nothing up
        _STATE = ProcessInfo(process_id, num_processes, coordinator, True)
    return _STATE


def process_info() -> ProcessInfo:
    """The resolved :class:`ProcessInfo` (a live process group's rank and
    size when :func:`init_from_env` was never called; else one process)."""
    if _STATE is not None:
        return _STATE
    if _group_up():
        import torch.distributed as dist

        n = dist.get_world_size()
        return ProcessInfo(dist.get_rank(), n, None, n > 1)
    return ProcessInfo(0, 1, None, False)


def shutdown() -> None:
    """Tear down the process group (best effort; test hygiene)."""
    global _STATE
    if _group_up():
        import torch.distributed as dist

        dist.destroy_process_group()
    _STATE = None


def _reset_for_tests() -> None:
    """Forget the memoized ProcessInfo without touching the runtime."""
    global _STATE
    _STATE = None


def host_local_rows_to_global(mesh, x):
    """Assemble per-rank row blocks into one global row-sharded tensor.

    Each rank holds its own contiguous block of rows (a data-pipeline
    shard); the result is a DTensor sharded over the mesh's data axes
    (``DTensor.from_local``, nothing communicated) whose global row count
    is ``data shards x local rows``.  With one data shard: the tensor as
    it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sampling import sharded

    x = torch.as_tensor(x)
    n = sharded.data_size(mesh)
    if n == 1:
        return x
    shape = (x.shape[0] * n,) + tuple(x.shape[1:])
    return DTensor.from_local(x.contiguous(), mesh, sharded.row_spec(mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
