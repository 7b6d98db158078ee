"""operator_build_s: the host clock around the user's builder call on the
benchmark's inputs (the traffic's builder: ``dia_shared_operator``,
``dia_operator_device``) with a synchronize before and after, in set-up."""


def read(ctx):
    return ctx.build_s
