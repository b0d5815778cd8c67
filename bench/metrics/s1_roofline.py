"""S1's share of its roofline (%): the least time of the probe sweep's
MH draw (``yardstick.s1_bound``, the larger of its bytes and INT32
terms) over S1's mean device time a launch."""

from bench import yardstick


def read(ctx):
    s, n = ctx.trace.by_kernel.get("S1", (0.0, 0))
    if not n or s <= 0:
        return None
    z_in, z_out = ctx.probe
    c = ctx.corpus
    b = yardstick.s1_bound(z_in, z_out, c.docs, c.mask, ctx.cell.config["K"],
                           ctx.cell.mix["reference"]["mh_steps"])
    return 100.0 * b["seconds"] / (s / n)
