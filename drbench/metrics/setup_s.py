"""Set-up seconds: process start to the first timed call (imports, the
card's context, the inputs, the containers and one warm call, which
builds the kernels in a checkout's first run)."""


def read(ctx):
    return ctx.setup_s
