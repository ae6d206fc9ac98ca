"""Each cell run once at its tiny size on the CPU, on the port's plain
versions, past the harness's look for a card: its result line and its
check against the reference."""
import json

import pytest

from portbench_tiny import SHRINK, tiny_run

REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(SHRINK))
def test_dry_run_prints_the_result_line(name, trace):
    r = json.loads(json.dumps(tiny_run(name, trace=trace)))
    assert all(k in r for k in REQUIRED)
    assert list(r)[-1] == "checks"
    assert set(r) <= set(REQUIRED) | {"breakdown", "notes", "checks"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    if not trace:
        assert set(r["metrics"]) >= {"setup_s"} and len(r["metrics"]) == 2
        for m in r["metrics"].values():
            assert m["value"] > 0 and m["unit"]
    # the plain versions against the reference, within every limit
    assert r["checks"] and all(x["limit"] is not None
                               for x in r["checks"].values())
    assert r["correct"] is True, r["checks"]
