"""(σ, β) double sweep over interaction-kernel widths.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta_2.py
:1277-1293 (σ ∈ {1e-4 … 0.3, 0} × 11 β × 5 runs at L=1000, non-periodic),
the JAX package's ``experiments/run_particle_sigma_sweep.py``.  σ=0.3
(radius 1200 ≥ L) takes the dense reflect band.  Per-σ npz files make the
sweep resumable; ``--replot`` redraws from the cross-σ archive.
``--engine``: ``particle`` (the default, as in the JAX package's CLI) runs
the general τ-leap step, ``fused``/``pallas`` kernel B3/B4,
``lattice_gas`` the plain-torch slot engines.  ``--ckpt-dir DIR``
checkpoints each σ's grid in flight (one subdirectory per σ).

Usage: python -m hydrolim_tpu_torch.experiments.particle_sigma_sweep
       [--small] [--outdir DIR] [--device cuda|cpu] [--replot]
       [--engine particle|fused|pallas|lattice_gas] [--ckpt-dir DIR]
"""
from __future__ import annotations

import argparse

import numpy as np

from hydrolim_tpu_torch.sweeps.sigma_sweep import (
    REFERENCE_SIGMA_VALUES,
    plot_D_eff_all_sigmas,
    plot_D_eff_vs_sigma_all_beta,
    plot_v_eff_all_sigmas,
    plot_v_eff_vs_sigma_all_beta,
    sweep_over_sigmas,
)


def main(small: bool = False, outdir: str = "sigma_sweep_out",
         run: bool = True, device: str = "cuda", engine: str = "particle",
         ckpt_dir: str = None, n_devices: int = None):
    if small:
        sigmas = [0.005, 0.05, 0]
        betas = np.linspace(0, 3, 4)
        ps = dict(L=200, N=100)
        rk = dict(T=4.0, obs_dt=0.2)
        n_runs = 2
    else:
        sigmas = REFERENCE_SIGMA_VALUES
        betas = np.linspace(0, 3, 11)
        ps, rk, n_runs = None, None, 5
    results = sweep_over_sigmas(sigmas, betas, n_runs_per_beta=n_runs,
                                run=run, ps_kwargs=ps, run_kwargs=rk,
                                outdir=outdir, device=device, engine=engine,
                                ckpt_dir=ckpt_dir, n_devices=n_devices)
    plot_v_eff_all_sigmas(results, outdir)
    plot_D_eff_all_sigmas(results, outdir)
    plot_v_eff_vs_sigma_all_beta(results, outdir)
    plot_D_eff_vs_sigma_all_beta(results, outdir)
    for s in sorted(results):
        print(f"sigma={s:g}: v(beta) = {np.round(results[s]['v_mean'], 4)}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="sigma_sweep_out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--replot", action="store_true",
                   help="reload the cross-sigma archive instead of running")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "fused", "pallas", "lattice_gas"])
    p.add_argument("--n-devices", type=int, default=None,
                   help="split the (beta x runs) batch over this many cards "
                        "(the results equal the one-card run)")
    p.add_argument("--ckpt-dir", default=None,
                   help="mid-run checkpoint/resume dir, one subdirectory "
                        "per sigma (rerun on it to resume)")
    a = p.parse_args()
    main(a.small, a.outdir, run=not a.replot, device=a.device,
         engine=a.engine, ckpt_dir=a.ckpt_dir, n_devices=a.n_devices)
