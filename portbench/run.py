"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (``hydrolim_tpu_torch``)
and this folder.  Set-up (imports, the CUDA context, the kernels' builds,
one warm unit of the cell's shapes) is ``setup_s``; then units of work
(sweeps) run until ``--seconds`` have passed, and the rate is
all their work over all their time.  ``--trace 1`` runs the same window
under ``torch.profiler`` and reports the per-layer metrics instead.  After
the window, a unit drawn from the seed is checked against the plain
reference (``portbench/reference``).  The last line of standard output is
the result as JSON; the numbers compared, each with its limit, are the
last lines of standard error.  Exits non-zero, with no result, without
enough CUDA devices or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; few
    host threads; no JAX behind a library."""
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _environment()
    import torch

    from portbench import harness

    wl = [w for w in harness.benchmark(ROOT)["workloads"]
          if w["name"] == a.workload]
    if not wl:
        print(f"portbench: no cell {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = wl[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              t_start=T_START, chips=chips)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
