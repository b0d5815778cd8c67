"""Reads of a device value a sweep forces the host to wait for: the
port's ``host_syncs`` counter over its ``lda.sweeps`` in the recorded
window (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    w = spans.window(ctx)
    sweeps = w.counters.get("lda.sweeps") if w is not None else None
    if not sweeps:
        return None
    return w.counters.get("host_syncs", 0) / sweeps
