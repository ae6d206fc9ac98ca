"""Host time per sweep outside the run loop: the unit's span less the
``solve`` span around ``run_meanfield_sweep`` (the v_eff and D_eff fits of
``particle_side``), in ms, averaged over the window's sweeps."""


def read(ctx):
    units, solves = ctx.spans.totals("unit"), ctx.spans.totals("solve")
    if not units or len(units) != len(solves):
        return None
    return 1e3 * (sum(units) - sum(solves)) / len(units)
