"""The benchmark's own host spans around the calls into the program's
layers: name, start and end on the host clock.  While a profiler runs,
each span is also a ``torch.profiler.record_function`` annotation
(``portbench.<name>``), so the device trace can name what the host was
doing."""
from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.events = []          # (name, start_s, end_s)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(f"portbench.{name}")
               if self.annotate else contextlib.nullcontext())
        try:
            with ctx:
                yield
        finally:
            self.events.append((name, t0, time.perf_counter()))

    def totals(self, name: str):
        """The durations (s) of the spans called ``name``, in order."""
        return [t1 - t0 for n, t0, t1 in self.events if n == name]
