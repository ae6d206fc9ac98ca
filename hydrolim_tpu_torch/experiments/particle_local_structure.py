"""Local-structure (pattern formation) β-sweep.

Reference driver: PARTICLE_solver_BIOLOGY_local_structure.py:671-753, the
JAX package's ``experiments/run_particle_local_structure.py``: 11 β in
[0, 3] × 3 runs at L=1000, N=900, K=1, walls, local m σ=0.005, T=40,
obs_dt=1 (``DEFAULT_STRUCTURE_*``) → the structure observables per β, the
npz and, where matplotlib is installed, the figure inventory.  ``--small``
runs 4 β × 2 runs at L=200, N=180 on a torus, T=4, obs_dt=0.2.

``--engine``: ``particle`` (the default, as in the JAX package's CLI) runs
the general τ-leap step, ``pallas`` kernel B3/B4, ``lattice_gas`` the
plain-torch slot engines; on the card unless ``--device cpu``.

Usage: python -m hydrolim_tpu_torch.experiments.particle_local_structure
       [--small] [--outdir DIR] [--replot]
       [--engine particle|lattice_gas|pallas] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from hydrolim_tpu_torch.sweeps.local_structure import (
    load_structure_results,
    save_structure_results,
    sweep_betas_for_structures,
)
from hydrolim_tpu_torch.viz.structure_plots import run_all_plots

NPZ = "beta_sweep_local_structure.npz"


def main(small: bool = False, outdir: str = "local_structure_out",
         run: bool = True, engine: str = "particle", device: str = "cuda"):
    npz = Path(outdir) / NPZ
    if small:
        betas = np.linspace(0, 3, 4)
        ps = dict(L=200, N=180, periodic=True)
        rk = dict(T=4.0, obs_dt=0.2)
        n_runs = 2
    else:
        betas = np.linspace(0, 3, 11)
        ps, rk, n_runs = None, None, 3
    if run:
        results = sweep_betas_for_structures(betas, n_runs, ps_kwargs=ps,
                                             run_kwargs=rk, keep_outs=True,
                                             engine=engine, device=device)
        npz.parent.mkdir(parents=True, exist_ok=True)
        save_structure_results(results, str(npz))
    else:
        results = load_structure_results(str(npz))
    run_all_plots(results, outdir=outdir, L=(ps or {}).get("L", 1000))
    for b in sorted(results):
        r = results[b]
        print(f"beta={b:.2f}: var={r['var_mean']:.4f} "
              f"lowk={r['low_k_power_mean']:.4f} k*={r['dominant_k_mode']}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="local_structure_out")
    p.add_argument("--replot", action="store_true",
                   help="reload the npz instead of re-running")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "lattice_gas", "pallas"])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.small, a.outdir, run=not a.replot, engine=a.engine,
         device=a.device)
