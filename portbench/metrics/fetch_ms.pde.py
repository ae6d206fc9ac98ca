"""Host ms a sweep in the program's span ``pde.fetch``
(``pde.fast_solve.result_to_numpy``: the records and fields to host numpy
arrays), its self time summed over the spans inside the window, over the
window's sweeps.  None where the program records no such span."""


def read(ctx):
    try:
        from hydrolim_tpu_torch.utils.profiling import events, self_s
    except ImportError:
        return None
    win = [(t0, t1) for n, t0, t1 in ctx.spans.events if n == "window"]
    if not win or not ctx.units:
        return None
    rec = events()
    got = [e for e in rec if e.name == "pde.fetch"
           and win[-1][0] <= e.start and e.end <= win[-1][1]]
    if not got:
        return None
    return 1e3 * sum(self_s(e, rec) for e in got) / ctx.units
