"""prog_masked_iter_share: the share, in %, of the iterations the traced
calls launched that no right-hand side needed, from the program's own
counters: 1 - (sum of ``iterations_needed``) / (sum of
``iterations_launched``) over the traced calls' ``entry`` spans
(``lsqr_tpu_torch.tracing``). Nothing to read where the program records no
spans (a version without ``tracing``) or launched no iteration."""


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
    launched = sum(int(s.attrs.get("iterations_launched", 0)) for s in found)
    needed = sum(int(s.attrs.get("iterations_needed", 0)) for s in found)
    return 100.0 * (1.0 - needed / launched) if launched > 0 else None


def read(ctx):
    try:
        from lsqr_tpu_torch import tracing
    except ImportError:
        return None
    return value(ctx, tracing.spans())
