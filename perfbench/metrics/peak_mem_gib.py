"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over set-up and the
window (reset at process start), in GiB: the operator, the right-hand
sides, the solver's state and the answer the check keeps."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
