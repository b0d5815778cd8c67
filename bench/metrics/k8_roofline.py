"""K8's share of its roofline (%): the mean least time of a chunk
(``yardstick.k8_chunk_bounds`` on the cell's own chunks) over K8's mean
device time a launch."""

from bench import yardstick


def read(ctx):
    s, n = ctx.trace.by_kernel.get("K8", (0.0, 0))
    if not n or s <= 0:
        return None
    chunk = ctx.cell.mix["reference"]["chunk"]
    bounds = yardstick.k8_chunk_bounds(ctx.corpus.docs, ctx.cell.config["K"], chunk)
    least = sum(b["seconds"] for b in bounds) / len(bounds)
    return 100.0 * least / (s / n)
