"""Host ms a sweep in the program's span ``mf.fits``
(``experiments.cross_engine_validation.particle_side``'s v_eff and D_eff
fits to the frames' positions), summed over the spans inside the window,
over the window's sweeps.  None where the program records no such span."""


def read(ctx):
    try:
        from hydrolim_tpu_torch.utils.profiling import events
    except ImportError:
        return None
    win = [(t0, t1) for n, t0, t1 in ctx.spans.events if n == "window"]
    if not win or not ctx.units:
        return None
    got = [e for e in events() if e.name == "mf.fits"
           and win[-1][0] <= e.start and e.end <= win[-1][1]]
    if not got:
        return None
    return 1e3 * sum(e.duration for e in got) / ctx.units
