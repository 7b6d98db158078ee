"""mk_roofline: the least time of the LSQR iterations the traced calls
needed (perfbench.roofline: for each, the values once and u, v, w and x
each read and written, at 3.35 TB/s; the sum of each call's itn) over
the device kernel time of those calls (every kernel, the calls' set-up
and the masked iterations past convergence included), in %."""

from perfbench import roofline


def read(ctx):
    s = ctx.window.summary
    if s is None or not ctx.window.traced_itn or s.kernel_s <= 0:
        return None
    cfg = ctx.cell.config
    nbytes = roofline.work_bytes(ctx.cell.family.values_inside(cfg), cfg["m"], cfg["n"],
                                 "lsqr_iteration")
    return roofline.share_percent(nbytes * ctx.window.traced_itn, s.kernel_s)
