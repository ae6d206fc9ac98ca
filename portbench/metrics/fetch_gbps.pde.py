"""The rate of the records' fetch to the host: the ``bytes`` the program
counts on its span ``pde.fetch`` (the arrays ``result_to_numpy`` returns)
over the span's self time, summed over the spans inside the window, in
GB/s.  None where the program records no such span or count."""


def read(ctx):
    try:
        from hydrolim_tpu_torch.utils.profiling import events, self_s
    except ImportError:
        return None
    win = [(t0, t1) for n, t0, t1 in ctx.spans.events if n == "window"]
    if not win:
        return None
    rec = events()
    got = [e for e in rec if e.name == "pde.fetch" and "bytes" in e.attrs
           and win[-1][0] <= e.start and e.end <= win[-1][1]]
    t = sum(self_s(e, rec) for e in got)
    if not got or t <= 0:
        return None
    return sum(e.attrs["bytes"] for e in got) / t / 1e9
