"""The port's spans: named, nested intervals of the host's work inside the
program, with counts (``bytes=``) beside them (SURVEY.md §5).

- :func:`span` — a context manager around a piece of the program's work,
- :func:`enable` — record spans with no profiler running,
- :func:`events`, :func:`self_s`, :func:`dropped`, :func:`reset` — read and
  clear the record,
- :func:`trace` — a ``torch.profiler`` trace of a block, with its spans.

Off by default: a span then costs one check and records nothing.  It is on
after :func:`enable`, or while a ``torch.profiler`` runs.  On, a span keeps
its name, its start and end on ``time.perf_counter()``, its id, the id of
the enclosing open span, the id of the root of its nest (one sweep) and its
attributes, and wraps its body in ``torch.profiler.record_function(
"hydrolim." + name)``, so that it lands on the profiler's timeline beside
the kernels.  A span never synchronises the card: a span's time is the
host's, the device's time is the trace's.  The record is the process's
and nests spans in the order they open, so spans belong to one thread; it
keeps the newest ``CAPACITY`` spans and counts the ones it dropped.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 100_000
PREFIX = "hydrolim."

_profiler_running = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class Span:
    """One recorded span; ``end`` is NaN while it is open."""

    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    root: int
    attrs: Dict[str, object]

    @property
    def duration(self) -> float:
        return self.end - self.start


class _Registry:
    """The record of spans: the closed ones, newest last, and the stack of
    open ones."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = False
        self.closed: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.open: List[Span] = []


_registry = _Registry()
_OFF = contextlib.nullcontext()


class _Open:
    """The context of one recorded span."""

    __slots__ = ("rec", "annotation")

    def __init__(self, name: str, attrs: dict):
        parent = _registry.open[-1] if _registry.open else None
        sid = next(_registry.ids)
        self.rec = Span(name, float("nan"), float("nan"), sid,
                        None if parent is None else parent.id,
                        sid if parent is None else parent.root, attrs)
        self.annotation = torch.profiler.record_function(PREFIX + name)

    def __enter__(self) -> Span:
        _registry.open.append(self.rec)
        self.rec.start = time.perf_counter()
        self.annotation.__enter__()
        return self.rec

    def __exit__(self, *exc) -> None:
        self.annotation.__exit__(*exc)
        self.rec.end = time.perf_counter()
        if _registry.open and _registry.open[-1] is self.rec:
            _registry.open.pop()
        closed = _registry.closed
        if len(closed) == closed.maxlen:
            _registry.dropped += 1
        closed.append(self.rec)


def span(name: str, **attrs):
    """A span around the ``with`` block: ``with span("pde.fetch") as s``
    gives the record (``s.attrs`` takes counts known at the end), or None
    while spans are off."""
    if not (_registry.enabled or _profiler_running()):
        return _OFF
    return _Open(name, attrs)


def enable() -> None:
    """Record spans with no profiler running (an operator's switch)."""
    _registry.enabled = True


def events() -> List[Span]:
    """The recorded spans, oldest closed first."""
    return list(_registry.closed)


def dropped() -> int:
    """Spans closed past the record's capacity and dropped, oldest
    first."""
    return _registry.dropped


def reset() -> None:
    """Clear the record and its drop count."""
    _registry.closed.clear()
    _registry.dropped = 0


def self_s(event: Span, among: Optional[List[Span]] = None) -> float:
    """``event``'s duration less the part of it that its children (in
    ``among``, by default the record) cover."""
    kids = sorted((max(e.start, event.start), min(e.end, event.end))
                  for e in (events() if among is None else among)
                  if e.parent == event.id)
    covered, t = 0.0, event.start
    for s, e in kids:
        s = max(s, t)
        if e > s:
            covered += e - s
            t = e
    return event.duration - covered


def _sync() -> None:
    """Wait for the card, where this process uses one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host (and, with a card, device) trace of the block with
    ``torch.profiler``: the Chrome trace (chrome://tracing, Perfetto) in
    ``logdir/trace.json``, the spans recorded meanwhile in
    ``logdir/spans.json``.  The card is synchronised before the trace
    stops, so that the block's device work is in it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    t0 = time.perf_counter()
    prof.start()
    try:
        yield logdir
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        spans = [dataclasses.asdict(e) for e in events() if e.start >= t0]
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump(dict(spans=spans, dropped=dropped()), f, default=str)
