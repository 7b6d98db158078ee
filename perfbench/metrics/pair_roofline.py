"""pair_roofline: the least time of the product pairs the traced calls
launched (perfbench.roofline: for each, the values once, u and v each read
and written, at 3.35 TB/s) over the device time of the pair's kernels in
those calls, in %. The traffic's ``pair`` names the program's launch
counter of the pair, each launch one right-hand side's pair, and the
kernels a launch runs; nothing to read where it names none, or where the
traced calls launched no pair or ran none of those kernels."""

from perfbench import roofline


def read(ctx):
    s, spec = ctx.window.summary, ctx.cell.traffic.get("pair")
    if s is None or spec is None:
        return None
    pairs = int(ctx.window.traced_counts.get(spec["counter"], 0))
    seconds = sum(s.by_kernel.get(name, (0, 0.0))[1] for name in spec["kernels"])
    if pairs <= 0 or seconds <= 0:
        return None
    cfg = ctx.cell.config
    nbytes = roofline.work_bytes(ctx.cell.family.values_inside(cfg), cfg["m"], cfg["n"], "pair")
    return roofline.share_percent(nbytes * pairs, seconds)
