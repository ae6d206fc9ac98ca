"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery of its pieces by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32
    assert all(_text_ok(w) for w in bench["command"])
    for w in bench["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # the whole check of 24 cells fits its 43,200 seconds
    assert ((2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_names_units_and_entries(bench):
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"])
        assert _text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert (ROOT / c["file"]).is_file()
        names["configs"].add(c["name"])
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        assert _text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names["workloads"].add(w["name"])
    assert {w["config"] for w in bench["workloads"]} == names["configs"]
    assert len(names["workloads"]) == len(bench["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert m["name"] not in names["metrics"]
        names["metrics"].add(m["name"])
        for w in m.get("workloads", []):
            assert w in names["workloads"]
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _text_ok(m["layer"])
        if m["unit"] == "%" and (m["name"].endswith("_roofline")
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def _reports(bench, cell):
    """The end-to-end metrics a cell reports."""
    return {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_moves_is_reported_where_its_metric_is(bench):
    """Each per-layer metric moves one end-to-end metric that every cell
    it lists reports; each cell reports set-up, one other end-to-end
    metric (the rate of its units' work) and a per-layer one."""
    from portbench import harness

    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", [w["name"]
                                        for w in bench["workloads"]]):
            assert m["moves"] in _reports(bench, cell), (m["name"], cell)
    for w in bench["workloads"]:
        rep = _reports(bench, w["name"])
        assert "setup_s" in rep and len(rep) == 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])
        assert [m["name"] for m in harness.reported(bench, w["name"])] == [
            r for r in sorted(rep) if r != "setup_s"]


def test_pieces_are_found_by_name(bench):
    from portbench import harness
    from portbench.runners.base import BaseRunner

    for w in bench["workloads"]:
        c = harness.cell(w["name"])
        assert c["config"] == w["config"] and c["traffic"] == w["traffic"]
        assert issubclass(harness.runner_class(c["traffic_data"]["runner"]),
                          BaseRunner)
        assert c["limits"], w["name"]
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_a_cell_added_as_files_runs(tmp_path, bench):
    """A new runner, traffic mix and cell, added as files and entries to a
    copy of the checkout, run with no edit to a file that was there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "hydrolim_tpu_torch").symlink_to(ROOT / "hydrolim_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    runners = tmp_path / "portbench" / "runners"
    (runners / "pde_again.py").write_text(
        (runners / "pde_beta_sweep.py").read_text())
    mix = dict(json.loads((ROOT / "portbench" / "traffic"
                           / "pde_sweep.json").read_text()),
               runner="pde_again", note="the same mix by a new runner")
    (tmp_path / "portbench" / "traffic" / "pde_again.json").write_text(
        json.dumps(mix))
    cell = dict(json.loads((ROOT / "portbench" / "workloads"
                            / "xeng.pde.json").read_text()),
                traffic="pde_again")
    (tmp_path / "portbench" / "workloads" / "xeng.added.json").write_text(
        json.dumps(cell))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(name="xeng.added",
                               config="cross_engine_validation",
                               traffic="pde_again", chips=1,
                               why="a cell added as files"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "xeng.pde" in m.get("workloads", []):
            m["workloads"].append("xeng.added")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    script = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})\n"
        "from portbench import harness\n"
        "from portbench_tiny import SHRINK\n"
        "r = harness.run_cell('xeng.added', 5, 0.01, False,\n"
        "    t_start=time.perf_counter(), device='cpu',\n"
        "    shrink=SHRINK['xeng.pde'])\n"
        "print(json.dumps(dict(file=harness.__file__,\n"
        "    runner=sys.modules['portbench.runners.pde_again'].__file__,\n"
        "    r=r)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["file"].startswith(str(tmp_path))
    assert res["runner"].startswith(str(tmp_path))
    assert res["r"]["correct"] is True
    assert "site_steps_per_s" in res["r"]["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())
