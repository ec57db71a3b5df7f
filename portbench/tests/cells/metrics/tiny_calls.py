"""A test-only metric: the calls of the window."""


def read(ctx):
    return len(ctx.calls)
