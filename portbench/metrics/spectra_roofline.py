"""B2's spectra kernel's share of its roofline: the frozen bound of every
call's bins (``counts.roofline.spectra_bound``) over ``spectra_kernel``'s
device time in the profiler's trace, in %."""
from portbench.counts import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(e - s for _, s, e in ctx.trace.kernels(r"^spectra_kernel$"))
    if t <= 0:
        return None
    bounds = [roofline.spectra_bound(**c) for c in ctx.calls.spectra]
    ms = ctx.units * sum(b["bound_ms"] for b in bounds)
    ctx.notes["spectra_roofline"] = "bound by " + ",".join(
        sorted({b["bound_by"] for b in bounds}))
    return 100.0 * ms / (t / 1e3)
