"""prog_pair_roofline: the least time of the product pairs the traced
calls launched over their device time, in %, both from the program's
``kernel`` spans (``lsqr_tpu_torch.tracing``: one launch in ``SAMPLE`` of
each wrapper, so a sample of the pairs). A span whose declared work is
``pair`` moves, by perfbench.roofline's rule, the values once and each of
its ``rows`` right-hand sides' u and v read and written; its device time
is the launch's own CUDA-event interval. Which kernel runs the pair, and
under which counter, does not enter. Nothing to read where the program
records no spans or the traced calls ran no sampled pair."""

from perfbench import roofline


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
    ids = {s.id for s in found}
    pairs = [s for s in spans if s.name == "kernel" and s.call in ids
             and s.attrs.get("work") == "pair"]
    seconds = sum(float(s.attrs.get("device_s", 0.0)) for s in pairs)
    if not pairs or seconds <= 0:
        return None
    cfg = ctx.cell.config
    values = roofline.work_bytes(ctx.cell.family.values_inside(cfg), 0, 0, "pair")
    vectors = roofline.work_bytes(0, cfg["m"], cfg["n"], "pair")
    nbytes = sum(values + int(s.attrs.get("rows", 1)) * vectors for s in pairs)
    return roofline.share_percent(nbytes, seconds)


def read(ctx):
    try:
        from lsqr_tpu_torch import tracing
    except ImportError:
        return None
    return value(ctx, tracing.spans())
