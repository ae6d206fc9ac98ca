"""Host ms a sweep in the program's span ``pde.window_means``
(``sweeps.pde_sweeps.pde_beta_sweep``'s v_eff and D_eff means over
[t_min, t_max], β by β), summed over the spans inside the window, over the
window's sweeps.  None where the program records no such span."""


def read(ctx):
    try:
        from hydrolim_tpu_torch.utils.profiling import events
    except ImportError:
        return None
    win = [(t0, t1) for n, t0, t1 in ctx.spans.events if n == "window"]
    if not win or not ctx.units:
        return None
    got = [e for e in events() if e.name == "pde.window_means"
           and win[-1][0] <= e.start and e.end <= win[-1][1]]
    if not got:
        return None
    return 1e3 * sum(e.duration for e in got) / ctx.units
