"""In-flight checkpointing overhead: the same run with and without
``ckpt_dir=`` (the JAX package's ``experiments/measure_ckpt_overhead.py``).

Each route runs once warm, then once timed without a checkpoint and once
timed with ``ckpt_dir=`` on a fresh directory, so every chunk's atomic npz
write is included; the card is synchronised at the end of each call.
Routes:

- ``fused``: the exclusion β-sweep (11 β × 3 runs, L=1000, N=500, T=20;
  PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:1030-1034) on kernel B3;
- ``lattice_gas``: the same sweep on the plain-torch slot engine;
- ``particle``: the same sweep on the τ-leap engine;
- ``pde``: the PDE β-ensemble (11 β × 3 runs, L=1000, T=10;
  IMEX_PDE_solver_run_sweep.py) on kernel B2 through
  ``run_pde_ensemble(ckpt_dir=)``.

Prints one JSON line per route: both walls, the overhead, and what the
writes cost (``utils.checkpoint.WRITE_STATS``: files, bytes, the wait for
the chunks' copies, ``np.savez_compressed`` wall and process CPU time, the
renames).

Usage: python -m hydrolim_tpu_torch.experiments.measure_ckpt_overhead
       [--small] [--device cuda|cpu] [--routes fused,lattice_gas,particle,pde]
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from hydrolim_tpu_torch.utils.checkpoint import (
    WRITE_STATS,
    reset_write_stats,
)

ROUTES = ("fused", "lattice_gas", "particle", "pde")


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(run, device: str) -> dict:
    """Warm once, then time the call without and with a checkpoint."""
    base = Path(tempfile.mkdtemp(prefix="ckpt_overhead_"))
    try:
        run(None)
        _sync(device)
        walls = {}
        for name, ck in (("straight_s", None), ("ckpt_s", base / "ck")):
            reset_write_stats()
            t0 = time.perf_counter()
            run(ck)
            _sync(device)
            walls[name] = time.perf_counter() - t0
        writes = dict(WRITE_STATS)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    walls["overhead_pct"] = 100.0 * (walls["ckpt_s"] - walls["straight_s"]) \
        / walls["straight_s"]
    return dict(walls, writes=writes)


def measure_sweep(engine: str, small: bool, device: str) -> dict:
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    beta = np.linspace(0, 3, 5 if small else 11)
    over = dict(L=200, N=100) if small else None
    rk = dict(T=4.0, obs_dt=0.2) if small else None
    n_runs = 2 if small else 3
    out = tempfile.mkdtemp(prefix="ckpt_overhead_out_")

    def run(ck):
        sweep_over_betas(beta, n_runs_per_beta=n_runs, ps_kwargs=over,
                         run_kwargs=rk, engine=engine,
                         npz_path=f"{out}/r.npz", outdir=out, seed=0,
                         plot_result=False, ckpt_dir=ck, device=device)

    row = _timed(run, device)
    shutil.rmtree(out, ignore_errors=True)
    return dict(route=engine, surface="sweep_over_betas",
                grid=f"{len(beta)} beta x {n_runs} runs", **row)


def measure_pde(small: bool, device: str) -> dict:
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.sweeps.pde_sweeps import run_pde_ensemble

    if small:
        config = PDEConfig(L=128, T=0.5, dt=1e-3, bc="periodic",
                           gaussian_kernel=True, kernel_sigma=1e5 - 10,
                           snapshot_interval=100, fft_kmax=8, n_tracers=16)
        beta, n_runs = np.linspace(0, 3, 4), 1
    else:
        config = PDEConfig(L=1000, T=10.0, dt=5e-4, bc="periodic",
                           gaussian_kernel=True, kernel_sigma=1e5 - 10,
                           snapshot_interval=1000, fft_kmax=8,
                           n_tracers=1000, tracer_window_time=0.25)
        beta, n_runs = np.linspace(0, 3, 11), 3

    def run(ck):
        run_pde_ensemble(config, beta, gamma=0.2, lam=0.6, n_runs=n_runs,
                         seed=0, n_tracers=config.n_tracers, device=device,
                         ckpt_dir=ck)

    return dict(route="pde", surface="run_pde_ensemble",
                grid=f"{len(beta)} beta x {n_runs} runs",
                **_timed(run, device))


def main(small: bool = False, device: str = "cuda", routes=ROUTES) -> list:
    rows = []
    for route in routes:
        row = (measure_pde(small, device) if route == "pde"
               else measure_sweep(route, small, device))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="CPU smoke scale")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--routes", default=",".join(ROUTES))
    a = ap.parse_args()
    main(a.small, a.device, [r for r in a.routes.split(",") if r])
