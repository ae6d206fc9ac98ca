"""Device kernels per sweep in the profiler's trace of the
window.  B2's launches in the trace are held against the program's own
counter (``pde_multi_step.route_launches``); where they disagree the
metric is left out."""

B2 = r"^(pde_kernel|pde_gmem_kernel|pde_gmem_fft_kernel)$"


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    traced = len(ctx.trace.kernels(B2))
    counted = ctx.counters.get("b2_launches")
    if counted is not None and traced != counted:
        ctx.notes["kernel_calls_per_sweep.pde"] = (
            f"B2 launches: {traced} in the trace, {counted} counted")
        return None
    n = len(ctx.trace.kernels())
    return n / ctx.units if n else None
