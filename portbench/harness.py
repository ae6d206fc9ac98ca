"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check against the plain reference.

Every piece is found by its name: the cell in
``portbench/workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and traffic mix (``traffic/<mix>.json``, whose
``runner`` names ``runners/<runner>.py`` and its class ``Runner``); a
per-layer metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``'s ``read(ctx)``; the end-to-end metric a cell
reports besides ``setup_s`` is the one whose ``workloads`` name it.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from portbench.runners.base import unit_seed
from portbench.spans import Spans
from portbench.tracing import MetricContext, read_trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hydrolim_tpu")


def benchmark(root: Path = HERE.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(name: str) -> dict:
    """The cell's file with its configuration and traffic mix."""
    wl = load_json("workloads", name)
    return dict(wl, config_data=load_json("configs", wl["config"]),
                traffic_data=load_json("traffic", wl["traffic"]))


def runner_class(name: str):
    """The class ``Runner`` of ``runners/<name>.py``."""
    if not name.isidentifier() or name == "base":
        raise ValueError(f"no runner {name!r}")
    return importlib.import_module(f"portbench.runners.{name}").Runner


def make_runner(c: dict, device, spans: Spans, sync: bool,
                shrink: Optional[dict] = None):
    """The runner of cell ``c`` (``cell(name)``)."""
    return runner_class(c["traffic_data"]["runner"])(
        c["config_data"], c["traffic_data"], device, spans, sync=sync,
        shrink=shrink)


def reported(bench: dict, name: str) -> list:
    """The end-to-end metrics cell ``name`` reports, ``setup_s`` aside."""
    return [m for m in bench["end_to_end"] if m["name"] != "setup_s"
            and name in m.get("workloads", [name])]


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name, compared
    whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def counters() -> Dict[str, int]:
    """The program's launch counter that a metric reads: B2's, all
    routes."""
    try:
        from hydrolim_tpu_torch.ops import pde_kernel
    except ImportError:
        return {}
    return {"b2_launches":
            sum(pde_kernel.pde_multi_step.route_launches.values())}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", chips: int = 1,
             shrink: Optional[dict] = None) -> dict:
    """One run; returns the result line's dict (``checks`` last).
    ``shrink`` replaces sizes of the configuration (tests only)."""
    bench = benchmark()
    c = cell(name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = Spans(annotate=trace)
    notes: Dict[str, str] = {}
    runner = make_runner(c, dev, spans, trace, shrink)
    runner.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    spans.events.clear()

    rng = np.random.default_rng([int(seed), 99])
    c0 = counters()
    attempted = failed = 0
    work = 0.0
    tmp = tempfile.TemporaryDirectory()
    prof = contextlib.nullcontext()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    with prof:
        # the window opens once the profiler runs, and closes before it
        # stops: neither is the program's time
        t0 = time.perf_counter()
        notes["window_start"] = time.strftime("%H:%M:%S")
        with spans.span("window"):
            while True:
                keep = int(rng.integers(0, attempted + 1)) == 0
                attempted += 1
                try:
                    with spans.span("unit"):
                        work += runner.unit(unit_seed(seed, attempted - 1),
                                            keep)
                except Exception:            # the run reports it, then ends
                    traceback.print_exc()
                    failed += 1
                    break
                if time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
    notes["window_s"] = f"{window_s:.3f}"
    units = spans.totals("unit")
    units_at = [(t1 - t, t - t0) for n, t, t1 in spans.events
                if n == "unit"]
    if units:
        notes["unit_s"] = (f"min {min(units):.3f} median "
                           f"{float(np.median(units)):.3f} max "
                           f"{max(units):.3f} at {units.index(max(units))}"
                           f" of {len(units)}, {max(units_at)[1]:.1f} s "
                           "into the window")
    c1 = counters()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    dev_info = dict(platform="gpu" if cuda else dev.type,
                    kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                    count=chips, memory_peak_bytes=int(peak))
    metrics = {}
    result = dict(correct=False, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev_info)
    done = attempted - failed
    if not trace:
        rate, = reported(bench, name)      # a unit's work is in its unit
        metrics[rate["name"]] = dict(value=work / window_s,
                                     unit=rate["unit"])
        metrics["setup_s"] = dict(value=setup_s, unit="s")
    elif done:
        tr = None
        if cuda:
            path = Path(tmp.name) / "trace.json"
            prof.export_chrome_trace(str(path))
            tr = read_trace(path)
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
        ctx = MetricContext(units=done, calls=runner.calls(),
                            spans=spans, trace=tr,
                            counters={k: c1[k] - c0.get(k, 0)
                                      for k in c1}, notes=notes)
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        if tr is not None:
            result["breakdown"] = tr.breakdown()
    tmp.cleanup()
    del prof

    checks: Dict[str, dict] = {}
    if done:
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        readings = runner.check()
        notes["check_s"] = f"{time.perf_counter() - t_check:.1f}"
        for k, v in readings.items():
            lim = c.get("limits", {}).get(k)
            checks[k] = dict(value=v, limit=lim)
        result["correct"] = failed == 0 and all(
            x["limit"] is not None and math.isfinite(x["value"])
            and x["value"] <= x["limit"] for x in checks.values())
    runner.close()
    if notes:
        result["notes"] = notes
    pl = power_limit() if cuda else None
    if pl:
        result.setdefault("notes", {})["card"] = pl
    result["checks"] = checks
    return result


def check_lines(result: dict) -> list:
    out = []
    for k, x in result["checks"].items():
        lim = "none" if x["limit"] is None else repr(x["limit"])
        out.append(f"check {k} {x['value']!r} limit {lim}")
    out.append(f"correct {result['correct']}")
    return out
