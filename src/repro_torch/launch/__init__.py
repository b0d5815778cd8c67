"""Launchers on ``torch.distributed``, the counterpart of ``repro.launch``:
``mesh`` (DeviceMesh construction and the budget search), ``train`` and
``serve`` (``python -m repro_torch.launch.train|serve``), and ``dryrun``
with ``costing`` (every production cell traced on a fake process group:
``python -m repro_torch.launch.dryrun``).  Importing them initializes no
process group."""
