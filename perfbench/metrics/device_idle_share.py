"""device_idle_share: 1 - (union of device kernel, memcpy and memset
intervals) / (wall span of the traced calls), in %."""


def read(ctx):
    s = ctx.window.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * s.idle_share
