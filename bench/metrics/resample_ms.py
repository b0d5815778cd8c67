"""Device milliseconds a sweep of the resample stage: counts, theta and
phi gamma draws and normalisations, the sparse counts' sort."""


def read(ctx):
    t = ctx.trace
    if not t.sweeps or "resample" not in t.stage_s:
        return None
    return 1e3 * t.stage_s["resample"] / t.sweeps
