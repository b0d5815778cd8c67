"""The whole sweep's share of the chip's peak (%): the least time any
exact sweep of the configuration needs (its bytes at the HBM rate,
``yardstick.sweep_seconds``) over the untraced host-clock time a sweep."""

from bench import yardstick


def read(ctx):
    if ctx.sweep_s <= 0:
        return None
    cfg = ctx.cell.config
    least = yardstick.sweep_seconds(ctx.corpus.live_tokens, cfg["M"], cfg["V"], cfg["K"])
    return 100.0 * least / ctx.sweep_s
