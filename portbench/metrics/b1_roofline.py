"""Kernel B1's share of its roofline: the frozen bound of every call of
the window (``counts.roofline.b1_bound``) over B1's device time in the
profiler's trace, in %."""
from portbench.counts import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(e - s for _, s, e in ctx.trace.kernels(r"^meanfield_kernel$"))
    if t <= 0:
        return None
    bounds = [roofline.b1_bound(**c) for c in ctx.calls.b1]
    ms = ctx.units * sum(b["bound_ms"] for b in bounds)
    ctx.notes["b1_roofline"] = "bound by " + ",".join(
        sorted({b["bound_by"] for b in bounds}))
    return 100.0 * ms / (t / 1e3)
