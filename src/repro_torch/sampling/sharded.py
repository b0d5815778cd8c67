"""The mesh-sharded draw (the counterpart of ``repro.sampling.sharded``)
comes with ROADMAP queue 1, slice 11, together with the seeded kernels K5
and K10 it launches per shard.  Until then every name here raises."""


def __getattr__(name: str):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"repro_torch.sampling.sharded.{name} is not ported yet: ROADMAP queue 1, "
        "slice 11 (multi-device draws)"
    )
