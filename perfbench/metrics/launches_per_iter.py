"""launches_per_iter: device kernels in the traced calls (profiler events)
over the iterations those calls launched (the program's launch counters:
a pair a right-hand side an iteration, or K iterations a megakernel
launch). Set-up kernels of each call count with them."""


def read(ctx):
    s = ctx.window.summary
    if s is None or not ctx.iterations or not s.kernels:
        return None
    return s.kernels / ctx.iterations
