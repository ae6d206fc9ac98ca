"""(N, β) double sweep — calibration of the exclusion constants C0/C1/C2.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION_double_sweep.py:851-961
(N = linspace(50, 950, 19) × 11 β × 4 runs, T=10; per-N (f, g) blocking
fits, then meta-fits f(x) = C0 − C1·x, g(x) = C2/x^{3/2}), the JAX
package's ``experiments/run_particle_double_sweep.py``.  The grid runs in
chunks of 44 replicas on the card unless ``--device cpu``.

``--n-runs`` and ``--seed`` repeat the grid at other statistics (the
JAX package's VALIDATION.md compares 16-run realizations, seeds 0 and 1);
``--engine`` picks the engine: ``particle`` (the default, as in the JAX
package's CLI) the general τ-leap step, ``pallas`` kernel B3/B4,
``lattice_gas`` the plain-torch slot engine.

Usage: python -m hydrolim_tpu_torch.experiments.particle_double_sweep
       [--small] [--outdir DIR] [--device cuda|cpu] [--n-runs N]
       [--seed S] [--engine particle|pallas|lattice_gas]
"""
from __future__ import annotations

import argparse

import numpy as np

from hydrolim_tpu_torch.sweeps.double_sweep import double_sweep_fused


def main(small: bool = False, outdir: str = "double_sweep_out",
         device: str = "cuda", n_runs: int = None, seed: int = 0,
         engine: str = "particle"):
    if small:
        betas = np.linspace(0, 3, 4)
        Ns = np.linspace(40, 160, 4)
        kw = dict(ps_kwargs=dict(L=200), run_kwargs=dict(T=3.0, obs_dt=0.2),
                  n_runs_per_beta=n_runs or 2)
    else:
        betas = np.linspace(0, 3, 11)
        Ns = np.linspace(50, 950, 19)
        kw = dict(n_runs_per_beta=n_runs or 4,
                  run_kwargs=dict(T=10, obs_dt=0.1))
    res = double_sweep_fused(betas, Ns, outdir=outdir, device=device,
                             seed=seed, engine=engine, **kw)
    print("f(rho):", np.round(res["f_fit"], 3))
    print("g(rho):", np.round(res["g_fit"], 3))
    print(f"C0={res['C0']:.6f} ± {res['C0_err']:.6f}  C1={res['C1']:.6f} ± "
          f"{res['C1_err']:.6f}  C2={res['C2']:.6f} ± {res['C2_err']:.6f}")
    print("(frozen reference constants: C0=1.25529 C1=0.60229 C2=0.15327)")
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="double_sweep_out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-runs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", default="particle",
                   choices=["particle", "pallas", "lattice_gas"])
    a = p.parse_args()
    main(a.small, a.outdir, a.device, n_runs=a.n_runs, seed=a.seed,
         engine=a.engine)
