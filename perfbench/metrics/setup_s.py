"""setup_s: the host clock from the start of ``run.py`` to the first timed
call: imports, CUDA start, the kernel libraries (built on a checkout's
first run), the inputs, the operator and the warm call."""


def read(ctx):
    return ctx.setup_s
