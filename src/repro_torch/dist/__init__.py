"""Distributed substrate on ``torch.distributed``, the counterpart of
``repro.dist``: process-group bring-up, sharding rules, per-rank shard
checkpoints, compression, cross-rank heartbeats and monitoring.

- :mod:`repro_torch.dist.multihost`: ``init_from_env()``, the
  ``REPRO_COORDINATOR`` env contract turned into an ``init_process_group``
  with retry/backoff (NCCL on the card, gloo on the CPU), a clean
  single-process no-op when unset.
- :mod:`repro_torch.dist.sharding`: the logical-axis rules engine, the
  reference's rule for rule; its specs become DTensor placements on a
  ``DeviceMesh``; :func:`~repro_torch.dist.sharding.constrain_activation`
  is the models' activation hook.
- :mod:`repro_torch.dist.fault`: atomic per-rank shard checkpoints in the
  reference's on-disk format (schema 2) that reshard on restore, async
  saves, and the SIGTERM preemption hook.
- :mod:`repro_torch.dist.compression`: int8 per-tensor quantization and
  the error-feedback compressed-allreduce simulation.
- :mod:`repro_torch.dist.monitor`, :mod:`repro_torch.dist.heartbeat`:
  copies of the reference's (numpy and the standard library only): step
  statistics, stragglers, dead hosts, and the file mailbox that feeds
  them.

Nothing here imports JAX or the reference package.
"""

from repro_torch.dist import (
    compression,
    fault,
    heartbeat,
    monitor,
    multihost,
    sharding,
)

__all__ = ["sharding", "fault", "compression", "monitor", "multihost", "heartbeat"]
