"""Kernel B2's share of its roofline: the frozen bound of the step's
fewest operations or bytes of every call of the window
(``counts.roofline.b2_kernel_bound``: the smoothing and the solve at their
fewest, whichever route or stage computes them; the spectra are the
spectra kernel's) over the device time of B2's three kernels in the
profiler's trace, in %."""
from portbench.counts import roofline

B2 = r"^(pde_kernel|pde_gmem_kernel|pde_gmem_fft_kernel)$"


def read(ctx):
    if ctx.trace is None:
        return None
    t = sum(e - s for _, s, e in ctx.trace.kernels(B2))
    if t <= 0:
        return None
    bounds = [roofline.b2_kernel_bound(**c) for c in ctx.calls.b2]
    ms = ctx.units * sum(b["bound_ms"] for b in bounds)
    ctx.notes["b2_roofline"] = "bound by " + ",".join(
        sorted({b["bound_by"] for b in bounds}))
    return 100.0 * ms / (t / 1e3)
