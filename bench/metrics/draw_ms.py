"""Device milliseconds a sweep of the z-draw stage (layers.json)."""


def read(ctx):
    t = ctx.trace
    if not t.sweeps or "draw" not in t.stage_s:
        return None
    return 1e3 * t.stage_s["draw"] / t.sweeps
