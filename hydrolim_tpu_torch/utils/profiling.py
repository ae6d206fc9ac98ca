"""Tracing / profiling hooks (SURVEY.md §5).

The reference reports progress via bare prints; here the framework exposes
first-class performance instrumentation:

- :class:`PhaseTimer` — per-phase timers with a summary table,
- :func:`trace` — context manager around ``torch.profiler`` for host and
  device traces,
- :func:`throughput` — particle-steps/sec (and friends) counters from timed
  step closures, the metric family of BASELINE.json.

CUDA work is asynchronous: a host clock read right after a launch measures
the launch, not the work.  So where the process uses a card
(``torch.cuda.is_initialized()``), the timers synchronise it at both ends
of what they time; on a CPU-only process they never touch CUDA.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch


def _sync() -> None:
    """Wait for the card, where this process uses one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class PhaseTimer:
    """Accumulating named phase timers; a phase's time is the device's
    (the card is synchronised at both ends of a phase).

    >>> timer = PhaseTimer()
    >>> with timer("simulate"): ...
    >>> timer.summary()
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = [f"{'phase':<24}{'calls':>8}{'total_s':>12}{'mean_ms':>12}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24}{n:>8}{tot:>12.3f}{1e3 * tot / n:>12.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/hydrolim_trace"):
    """Capture a host (and, with a card, device) trace with
    ``torch.profiler``; the Chrome trace is written to
    ``logdir/trace.json`` (chrome://tracing, Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def throughput(step_fn: Callable[[], None], *, items_per_call: float,
               warmup: int = 1, reps: int = 5) -> Dict[str, float]:
    """Time a step closure and report items/sec (e.g.
    particle-steps/sec/card: items = B·N·K_steps); the card is
    synchronised after each call."""
    for _ in range(warmup):
        step_fn()
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step_fn()
        _sync()
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"items_per_sec": items_per_call / best, "best_s": best,
            "mean_s": sum(times) / len(times)}
