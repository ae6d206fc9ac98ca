"""Host ms a sweep in the program's span ``mf.fetch``
(``sweeps.fast_meanfield.run_meanfield_sweep``'s frames stacked and
fetched to host numpy arrays), summed over the spans inside the window,
over the window's sweeps.  With a device trace, each span counts from the
end of the last B1 kernel that runs while it is open: until then the copy
only waits for the frames' queued work, which the fetch does not cost the
sweep.  None where the program records no such span."""
import bisect

NAME = "mf.fetch"
QUEUED = r"^meanfield_kernel$"


def read(ctx):
    try:
        from hydrolim_tpu_torch.utils.profiling import PREFIX, events
    except ImportError:
        return None
    win = [(t0, t1) for n, t0, t1 in ctx.spans.events if n == "window"]
    if not win or not ctx.units:
        return None
    got = [e for e in events() if e.name == NAME
           and win[-1][0] <= e.start and e.end <= win[-1][1]]
    if not got:
        return None
    if ctx.trace is None:
        return 1e3 * sum(e.duration for e in got) / ctx.units
    lo, hi = ctx.trace.window
    # the queued kernels run one after another: the last to start before
    # a span's end is the last to end
    queued = sorted((s, e) for _, s, e in ctx.trace.kernels(QUEUED))
    starts = [s for s, _ in queued]
    total = 0.0                          # µs on the trace's clock
    for n, s, e, _ in ctx.trace.host:
        if n != PREFIX + NAME or s < lo or e > hi:
            continue
        j = bisect.bisect_left(starts, e) - 1
        done = max(s, queued[j][1]) if j >= 0 else s
        total += max(0.0, e - done)
    return total / 1e3 / ctx.units
