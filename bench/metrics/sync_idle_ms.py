"""Device idle milliseconds a sweep whose gap began while the host was
inside a port ``sync.*`` span: the device drained while the host waited
for a value it read (``bench/spans.py``: idle by innermost span)."""

from bench import spans


def read(ctx):
    w = spans.window(ctx)
    if w is None or not w.spans or not w.trace.sweeps:
        return None
    s = sum(v for k, v in w.idle_by_span.items() if k.startswith("sync."))
    return 1e3 * s / w.trace.sweeps
