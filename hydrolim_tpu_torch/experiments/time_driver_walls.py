"""Walls of the port's uncheckpointed run paths, to hold one checkout
against another on the same card.

The three kernels are built first; the fused sweep runs once to warm
up, then each path once timed (host clock, the card synchronised at the
end): the exclusion β-sweep on kernel B3 in its two
configurations (11 β × 3 runs, L=1000, T=20; no fit), the same sweep (b)
on the τ-leap step and on the slot engine cut to 40 frames, the mean-field
``ParticleSystem`` run on kernel B1 (L=256, N=5000, T=10), the PDE
single run on kernel B2 (40,000 steps) and a PDE ensemble on B2 (11 β × 3
runs, L=1000, 1000 tracers, 4000 steps: its final record row runs replica
by replica).  Prints one JSON line.

Usage (against an older checkout, in turns: old, new, new, old):
    PYTHONPATH=<tree> python hydrolim_tpu_torch/experiments/time_driver_walls.py
        --tag NAME [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch


def _wall(fn, device: str) -> float:
    t0 = time.perf_counter()
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(tag: str, device: str = "cuda") -> dict:
    from hydrolim_tpu_torch import ParticleSystem
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.experiments.particle_beta_sweep import FLAGSHIP
    from hydrolim_tpu_torch.ops._build import build_kernel_library
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        pde_single_run,
        run_pde_ensemble,
    )

    betas = np.linspace(0.0, 3.0, 11)
    out = tempfile.mkdtemp(prefix="driver_walls_")

    def sweep(engine, over, rk=None):
        return lambda: sweep_over_betas(
            betas, 3, ps_kwargs=over or None, run_kwargs=rk,
            npz_path=f"{out}/sweep.npz", outdir=out, seed=0, do_fit=False,
            plot_result=False, engine=engine, device=device)

    def mean_field():
        ParticleSystem(L=256, xlim=1, rate_diffusion=0.2 * 256 ** 2,
                       rate_active=0.6 * 256, beta=2.0, init="fixed",
                       N=5000, scale_rates=False, local_kernel_sigma=0.0,
                       periodic=True, site_capacity=None,
                       active_model="bidirectional", rng=1,
                       device=device).run(T=10.0, obs_dt=0.5)

    def pde_ensemble():
        config = PDEConfig(L=1000, T=2.0, dt=5e-4, bc="periodic",
                           active_model="bidirectional", gaussian_kernel=True,
                           kernel_sigma=0.05, snapshot_interval=2000,
                           fft_kmax=8)
        run_pde_ensemble(config, betas, gamma=0.2, lam=0.6, n_runs=3,
                         seed=0, n_tracers=1000, device=device,
                         fetch_snapshots=False)

    short = dict(T=4.0, obs_dt=0.1)
    paths = {
        "fused (a)": sweep("fused", {}),
        "fused (b)": sweep("fused", FLAGSHIP),
        "particle (b), 40 frames": sweep("particle", FLAGSHIP, short),
        "lattice_gas (b), 40 frames": sweep("lattice_gas", FLAGSHIP, short),
        "B1 mean field, T=10": mean_field,
        "PDE single run": lambda: pde_single_run(outdir=f"{out}/pde",
                                                 device=device),
        "PDE ensemble, 33 replicas": pde_ensemble,
    }
    if torch.device(device).type == "cuda":   # no nvcc inside a timing
        for kernel in ("meanfield_multi_step", "pde_multi_step",
                       "exclusion_multi_step"):
            build_kernel_library(kernel)
    sweep("fused", {})()                                  # warm-up
    row = {"tag": tag, **{k: _wall(f, device) for k, f in paths.items()}}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--tag", default="this")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.tag, a.device)
