"""Readings of a cell's comparison for setting its limits: the program's
sound runs on many seeds, and the control's (the reference in the next
precision below the configuration's, put in the program's place) on a
few, in one process.  The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--dtype bfloat16]

Prints one JSON line per seed and, last, each number's lower reading (the
largest of the sound runs) and upper reading (the smallest of the
control's).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(name: str, seeds, control_seeds, dtype: str, device="cuda",
             shrink=None):
    """(sound readings per seed, control readings per seed)."""
    import torch

    from portbench import harness
    from portbench.spans import Spans

    runner = harness.make_runner(harness.cell(name), torch.device(device),
                                 Spans(), False, shrink)
    sound, control = [], []
    try:
        for kind, seq, out in (("sound", seeds, sound),
                               ("control", control_seeds, control)):
            for seed in seq:
                t0 = time.perf_counter()
                runner.unit(seed, keep=True)
                r = (runner.check() if kind == "sound"
                     else runner.control(getattr(torch, dtype)))
                out.append(r)
                print(json.dumps(dict(kind=kind, seed=seed, readings=r,
                                      seconds=time.perf_counter() - t0)),
                      flush=True)
    finally:
        runner.close()
    return sound, control


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--dtype", default="bfloat16")
    a = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    ints = lambda s: [int(x) for x in s.split(",") if x]
    sound, control = readings(a.workload, ints(a.seeds),
                              ints(a.control_seeds), a.dtype)
    keys = sorted({k for r in sound + control for k in r})
    summary = {k: dict(lower=max((r[k] for r in sound if k in r),
                                 default=None),
                       upper=min((r[k] for r in control if k in r),
                                 default=None)) for k in keys}
    print(json.dumps(dict(workload=a.workload, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
