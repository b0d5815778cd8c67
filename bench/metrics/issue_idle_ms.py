"""Device idle milliseconds a sweep whose gap began while the host was
inside a port span other than a ``sync.*`` one: the device waiting for
the port to issue work (``bench/spans.py``: idle by innermost span)."""

from bench import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None or not w.spans or not w.trace.sweeps:
        return None
    s = sum(v for k, v in w.idle_by_span.items()
            if k != spans.OUTSIDE and not k.startswith("sync."))
    return 1e3 * s / w.trace.sweeps
