"""solve_ms: the window's wall time over the calls completed in it, in ms.

A call is one entry call (one ``lsqr_batch`` over all its rows, or one
``lsqr``) ended by ``torch.cuda.synchronize()``; the window holds every
call's right-hand-side draw and the time between calls too."""


def read(ctx):
    win = ctx.window
    return 1e3 * win.seconds / win.calls if win.calls else None
