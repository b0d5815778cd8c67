"""Host microseconds a chunk of the dense z-draw: the self time of the
port's ``lda.draw_z`` spans (their ``autotune.plan`` left out) over the
``lda.chunks`` the recorded window's sweeps drew (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    w = spans.window(ctx)
    chunks = w.counters.get("lda.chunks") if w is not None and w.spans else None
    if not chunks:
        return None
    return w.span_self_us("lda.draw_z") / chunks
