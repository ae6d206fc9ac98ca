"""Particle β-sweep — the reference's flagship exclusion experiment.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:1030-1034
(β = linspace(0, 3, 11) × 3 runs at L=1000, N=500, T=20, K=1).
``--flagship`` runs the flagship capacity instead: K=3, N=750, σ=0.002
(experiments/run_particle_single.py:24-31).  The whole (β × replicas)
grid advances as one batch on the card unless ``--device cpu``:
``--engine particle`` (the default, as in the JAX package's CLI) on the
general τ-leap step, ``fused`` on kernel B3/B4, ``lattice_gas`` on the
plain-torch slot engines.

Usage: python -m hydrolim_tpu_torch.experiments.particle_beta_sweep
       [--outdir DIR] [--small] [--flagship] [--replot] [--device cuda|cpu]
       [--engine particle|fused|pallas|lattice_gas]
"""
from __future__ import annotations

import argparse

import numpy as np

from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

FLAGSHIP = dict(site_capacity=3, N=750, local_kernel_sigma=0.002)


def main(outdir: str = "beta_sweep_out", small: bool = False,
         run: bool = True, n_runs: int = None, flagship: bool = False,
         device: str = "cuda", engine: str = "particle"):
    beta_values = np.linspace(0, 3, 5 if small else 11)
    over = dict(FLAGSHIP) if flagship else {}
    if small:
        over.update(L=200, N=150 if flagship else 100)
    rk = dict(T=4.0, obs_dt=0.2) if small else None
    save = sweep_over_betas(
        beta_values, n_runs_per_beta=n_runs or (2 if small else 3), run=run,
        ps_kwargs=over or None, run_kwargs=rk,
        npz_path=f"{outdir}/beta_sweep_results.npz", outdir=outdir, seed=0,
        device=device, engine=engine)
    print("v_eff(beta):", np.round(save["means"], 4))
    print("D_eff(beta):", np.round(save["D_means"], 4))
    print("p_block(beta):", np.round(save["block_means"], 4))
    print(f"fit (theta, tau): {save['popt']}")
    return save


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="beta_sweep_out")
    p.add_argument("--small", action="store_true")
    p.add_argument("--flagship", action="store_true",
                   help="K=3, N=750, sigma=0.002 (the flagship capacity)")
    p.add_argument("--replot", action="store_true",
                   help="reload the npz checkpoint instead of re-running")
    p.add_argument("--n-runs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "fused", "pallas", "lattice_gas"])
    a = p.parse_args()
    main(a.outdir, a.small, run=not a.replot, n_runs=a.n_runs,
         flagship=a.flagship, device=a.device, engine=a.engine)
