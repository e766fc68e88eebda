"""Process start to the first timed request, on the host clock."""


def read(ctx):
    return ctx.setup_s
