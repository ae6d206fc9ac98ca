"""Host time per sweep outside ``pde_solve_fused``: fetching its records
and snapshots to the host and the estimators (the windowed v_eff and
D_eff means), in ms, averaged over the window's sweeps.
``pde_solve_fused`` is timed to the end of its device work (the traced
run synchronises after it)."""


def read(ctx):
    units, solves = ctx.spans.totals("unit"), ctx.spans.totals("solve")
    if not units or len(units) != len(solves):
        return None
    return 1e3 * (sum(units) - sum(solves)) / len(units)
