"""The port's spans (``utils/profiling.py``) on the CPU: off, a span records
nothing and never touches the profiler; on, its ids, parent, root and self
time, and the record's bound; under ``torch.profiler`` an annotation for
every recorded span, nested as the record nests them; and the spans inside
the two sweep paths, read by the benchmark's per-layer metrics in a tiny
traced run of each cell."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
NEW_METRICS = {
    "xeng.pde": ("fetch_ms.pde", "fetch_gbps.pde", "window_means_ms.pde",
                 "final_row_ms.pde"),
    "xeng.particle": ("fetch_ms.particle", "fits_ms.particle"),
}


@pytest.fixture(autouse=True)
def clean_record(monkeypatch):
    """A fresh record, off, for each test."""
    monkeypatch.setattr(profiling, "_registry", profiling._Registry())


def test_off_a_span_records_nothing_and_never_annotates(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered while spans are off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("pde.fetch", bytes=1) as sp:
        torch.ones(4).sum()
    assert sp is None
    # one shared null context, whatever the name: nothing made per span
    assert profiling.span("a") is profiling.span("b")
    assert profiling.events() == [] and profiling.dropped() == 0


def test_on_ids_parents_roots_and_self_time():
    profiling.enable()
    with profiling.span("outer", bytes=7) as outer:
        time.sleep(0.002)
        with profiling.span("a") as a:
            with profiling.span("a.inner") as inner:
                time.sleep(0.002)
        with profiling.span("b") as b:
            time.sleep(0.001)
    with profiling.span("second") as second:
        pass
    ev = profiling.events()
    assert [e.name for e in ev] == ["a.inner", "a", "b", "outer", "second"]
    assert len({e.id for e in ev}) == 5
    assert outer.parent is None and outer.root == outer.id
    assert a.parent == outer.id and b.parent == outer.id
    assert inner.parent == a.id
    assert {e.root for e in (a, b, inner)} == {outer.id}
    assert second.parent is None and second.root == second.id
    assert outer.attrs == {"bytes": 7} and a.attrs == {}
    for e in ev:
        assert e.start <= e.end
    assert outer.start <= a.start and a.end <= b.start and b.end <= outer.end
    # self time: less the children, not the grandchildren twice
    assert profiling.self_s(outer) == pytest.approx(
        outer.duration - a.duration - b.duration, abs=1e-9)
    assert profiling.self_s(a) == pytest.approx(a.duration - inner.duration,
                                                abs=1e-9)
    assert profiling.self_s(inner) == inner.duration
    assert profiling.self_s(outer) >= 0.0015
    # a span closes on an exception too, and the stack unwinds
    with pytest.raises(ValueError):
        with profiling.span("raises"):
            raise ValueError
    with profiling.span("after") as after:
        pass
    assert after.parent is None
    assert profiling.events()[-2].name == "raises"


def test_the_record_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_registry", profiling._Registry(5))
    profiling.enable()
    for i in range(8):
        with profiling.span(f"s{i}"):
            pass
    assert [e.name for e in profiling.events()] == [f"s{i}"
                                                    for i in range(3, 8)]
    assert profiling.dropped() == 3
    profiling.reset()
    assert profiling.events() == [] and profiling.dropped() == 0
    assert profiling.CAPACITY == 100_000
    assert profiling._Registry().closed.maxlen == profiling.CAPACITY


def test_a_profiler_trace_holds_every_span_nested(tmp_path):
    """No ``enable()``: the profiler alone turns spans on.  ``trace``
    writes the Chrome trace and the spans recorded meanwhile."""
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("sweep"):
            for _ in range(2):
                with profiling.span("block"):
                    (torch.arange(100.0) ** 2).sum()
            with profiling.span("fetch", bytes=3):
                torch.ones(10).numpy()
    assert profiling.span("off again") is profiling.span("x")
    recorded = profiling.events()
    assert [e.name for e in recorded] == ["block", "block", "fetch", "sweep"]
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert [s["name"] for s in spans["spans"]] == [e.name for e in recorded]
    assert spans["spans"][2]["attrs"] == {"bytes": 3}
    assert spans["dropped"] == 0
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    ann = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("name", "").startswith(profiling.PREFIX)]
    assert sorted(e["name"] for e in ann) == sorted(
        profiling.PREFIX + e.name for e in recorded)
    # each recorded span to its annotation, by name and order of start
    by_name = {}
    for e in sorted(ann, key=lambda e: float(e["ts"])):
        by_name.setdefault(e["name"][len(profiling.PREFIX):], []).append(e)
    match = {}
    for e in sorted(recorded, key=lambda e: e.start):
        match[e.id] = by_name[e.name].pop(0)
    inside = lambda c, p: (float(p["ts"]) <= float(c["ts"]) and
                           float(c["ts"]) + float(c["dur"])
                           <= float(p["ts"]) + float(p["dur"]))
    for e in recorded:
        if e.parent is not None:
            assert inside(match[e.id], match[e.parent]), e.name
    sweep = next(e for e in recorded if e.name == "sweep")
    assert all(e.root == sweep.id for e in recorded)


@pytest.fixture
def tiny(monkeypatch):
    """``tiny_run`` of a cell, with the benchmark's own spans kept."""
    sys.path.insert(0, str(ROOT / "portbench" / "tests"))
    try:
        from portbench_tiny import tiny_run
    finally:
        sys.path.remove(str(ROOT / "portbench" / "tests"))
    from portbench import harness
    from portbench.spans import Spans

    made = []

    class Kept(Spans):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(harness, "Spans", Kept)

    def run(name):
        r = tiny_run(name, trace=True)
        return r, made[-1].events
    return run


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_a_tiny_traced_run_reports_the_new_metrics(tiny, name):
    r, bench_spans = tiny(name)
    assert r["correct"] is True, r["checks"]
    for m in NEW_METRICS[name]:
        assert m in r["metrics"], (m, r["metrics"])
        assert r["metrics"][m]["value"] > 0
    # every program span of the window lies inside one of its units
    units = [(t0, t1) for n, t0, t1 in bench_spans if n == "unit"]
    assert len(units) == r["attempted"]
    ev = profiling.events()
    assert ev
    for e in ev:
        assert any(t0 <= e.start and e.end <= t1 for t0, t1 in units), e
    roots = {e.root for e in ev if e.name in ("pde.sweep", "mf.sweep")}
    assert len(roots) == r["attempted"]


def test_the_tiny_pde_run_has_one_fetch_row_and_means_a_sweep(tiny,
                                                              monkeypatch):
    from hydrolim_tpu_torch.sweeps import pde_sweeps

    fetched = []
    orig = pde_sweeps.result_to_numpy

    def keep(res):
        out = orig(res)
        fetched.append(out)
        return out
    monkeypatch.setattr(pde_sweeps, "result_to_numpy", keep)
    r, _ = tiny("xeng.pde")
    ev = profiling.events()
    n = r["attempted"]
    for name in ("pde.sweep", "pde.init", "pde.solve", "pde.fetch",
                 "pde.final_row"):
        assert sum(e.name == name for e in ev) == n, name
    # the window means: the reduction where the records are, then the
    # host's per-β arithmetic
    means = [e for e in ev if e.name == "pde.window_means"]
    assert len(means) == 2 * n
    assert sum("rows" in e.attrs for e in means) == n
    assert len(fetched) == n + 1        # the warm unit's, unrecorded
    fetched = fetched[1:]
    for sweep in (e for e in ev if e.name == "pde.sweep"):
        mine = [e for e in ev if e.root == sweep.id]
        assert {e.name for e in mine} == {
            "pde.sweep", "pde.init", "pde.solve", "pde.final_row",
            "pde.finish", "pde.fetch", "pde.window_means"}
    for sp, out in zip((e for e in ev if e.name == "pde.fetch"), fetched):
        arrays = [out.rho_p, out.rho_m, out.snapshots, out.m_snapshots,
                  out.snap_times, out.records.m_mean, out.records.var,
                  out.records.fft_ri, out.records.v_eff, out.records.D_eff,
                  out.window_means]
        assert all(isinstance(a, np.ndarray) for a in arrays)
        assert sp.attrs["bytes"] == sum(a.nbytes for a in arrays)
    solve = next(e for e in ev if e.name == "pde.solve")
    row = next(e for e in ev if e.name == "pde.final_row")
    assert row.parent == solve.id
