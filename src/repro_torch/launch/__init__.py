"""Launchers on ``torch.distributed``, the counterpart of ``repro.launch``:
``mesh`` (DeviceMesh construction and the budget search), ``train`` and
``serve`` (``python -m repro_torch.launch.train|serve``).  Importing them
initializes no process group."""
