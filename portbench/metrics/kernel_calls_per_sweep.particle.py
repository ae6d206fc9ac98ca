"""Device kernels per sweep in the profiler's trace of the window: B1's
launches and every kernel of the frames' records."""


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.units if n else None
