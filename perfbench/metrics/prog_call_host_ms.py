"""prog_call_host_ms: the host time of a traced call outside its iteration
loop, in ms, the mean over the traced calls: each ``entry`` span's
duration less that of the loop's spans inside it (``segment.enqueue``,
``segment.read``, ``mk.launch``, ``mk.wait``; ``lsqr_tpu_torch.tracing``).
What is left is the call's set-up, its finalize and the glue between them.
Nothing to read where the program records no spans."""

#: the spans of a call's iteration loop
LOOP = ("segment.enqueue", "segment.read", "mk.launch", "mk.wait")


def entries(ctx, spans):
    """The ``entry`` spans of the traced calls: the last ``traced_calls``
    recorded (spans are recorded only while the profiler is on); None where
    fewer were recorded."""
    calls = int(ctx.window.traced_calls)
    found = [s for s in spans if s.name == "entry"]
    return found[-calls:] if calls and len(found) >= calls else None


def value(ctx, spans):
    found = entries(ctx, spans)
    if found is None:
        return None
    loop = {}
    for s in spans:
        if s.name in LOOP:
            loop[s.call] = loop.get(s.call, 0) + s.end_ns - s.start_ns
    host = [s.end_ns - s.start_ns - loop.get(s.id, 0) for s in found]
    return sum(host) / len(host) / 1e6


def read(ctx):
    try:
        from lsqr_tpu_torch import tracing
    except ImportError:
        return None
    return value(ctx, tracing.spans())
