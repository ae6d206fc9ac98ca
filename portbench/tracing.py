"""Reading the traced run: the device's kernels and copies in the window
from ``torch.profiler``'s trace, their busy time (the union of their
intervals), the idle gaps named by the benchmark's host span and the
innermost host operator running at the time, and the context that the
per-layer metric readers (``portbench/metrics/<metric>.py``) read."""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION = "portbench."


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]            # µs on the trace's clock
    device: List[Tuple[str, float, float]]  # (name, start µs, end µs)
    host: List[Tuple[str, float, float, int]]  # (name, start, end, depth)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self, pattern: Optional[str] = None):
        """Device kernels (no copies) whose name matches ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        return [e for e in self.device if e[0] != "memcpy"
                and e[0] != "memset" and (rx is None or rx.search(e[0]))]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals within the window."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_labels(self, times: List[float]) -> List[str]:
        """What the host was doing at each of ``times``: the innermost
        benchmark span and the innermost operator inside it."""
        order = sorted(range(len(times)), key=lambda i: times[i])
        out = [""] * len(times)
        active: List[Tuple[str, float, float, int]] = []
        j = 0
        for i in order:
            t = times[i]
            while j < len(self.host) and self.host[j][1] <= t:
                active.append(self.host[j])
                j += 1
            active = [h for h in active if h[2] > t]
            span, op, depth_op = "window", "", -1
            for name, _, _, depth in active:
                if name.startswith(ANNOTATION):
                    span = name[len(ANNOTATION):]
                elif depth > depth_op:
                    op, depth_op = name, depth
            out[i] = f"{span}/{op}" if op else span
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        gaps: Dict[str, float] = {}
        spans = self.gaps()
        for (s, e), key in zip(spans, self.host_labels(
                [0.5 * (s + e) for s, e in spans])):
            gaps[key] = gaps.get(key, 0.0) + (e - s) / 1e6
        best = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return dict(device_ops=best(by_name), idle_gaps=best(gaps))


def short_name(name: str) -> str:
    """A kernel's function name, without its return type, namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def read_trace(path: Path) -> Trace:
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", events)
    window = None
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            label = (short_name(name) if cat == "kernel"
                     else cat.replace("gpu_", ""))
            device.append((label, s, e))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            if name == ANNOTATION + "window":
                window = (s, e)
            host.append((name, s, e, 0))
    if window is None:
        raise ValueError("the trace holds no portbench.window span")
    # nesting depth of the host events: count the enclosing ones
    host.sort(key=lambda x: (x[1], -x[2]))
    stack: List[float] = []
    nested = []
    for name, s, e, _ in host:
        while stack and stack[-1] <= s:
            stack.pop()
        nested.append((name, s, e, len(stack)))
        stack.append(e)
    return Trace(window, device, nested)


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric reader reads."""

    units: int                    # units of work in the window
    calls: object                 # runners.Calls of one unit
    spans: object                 # spans.Spans of the window
    trace: Optional[Trace]
    counters: Dict[str, int]      # the program's counters over the window
    notes: Dict[str, str]         # what a reader says beside its number
