"""masked_iter_share: the share, in %, of the iterations launched in the
traced calls that no right-hand side needed: 1 - (sum over calls of the
call's largest itn) / (iterations launched, from the launch counters)."""


def read(ctx):
    if ctx.window.summary is None or not ctx.iterations:
        return None
    return 100.0 * (1.0 - ctx.window.traced_itn / ctx.iterations)
