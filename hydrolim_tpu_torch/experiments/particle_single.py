"""Single particle-engine experiment.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION.py:55-107 — L=1000,
N=750, rate_active=5, β=0.7, K=3, σ=0.002, non-periodic, exponential-gradient
IC, T=20, obs_dt=0.5 → individual figures; the JAX package's
``experiments/run_particle_single.py``.  It prints the COM drift velocity
that ``plot_individuals`` returns (also where matplotlib is not installed
and the figures are skipped).  ``--engine``: ``particle`` (the default, as
in the JAX package) runs the general τ-leap step, ``lattice_gas`` the
plain-torch slot engine; ``--ckpt-dir DIR`` runs it in checkpointed chunks
(kill and rerun resumes bit-identically).

Usage: python -m hydrolim_tpu_torch.experiments.particle_single
       [--outdir DIR] [--small] [--engine particle|lattice_gas]
       [--ckpt-dir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from hydrolim_tpu_torch.particles.system import ParticleSystem
from hydrolim_tpu_torch.sweeps.beta_sweep import make_exp_gradient


def main(outdir: str = "particle_single_out", small: bool = False,
         engine: str = "particle", ckpt_dir: str = None,
         device: str = "cuda"):
    """Run, draw, print; returns (the out dict, the COM drift velocity)."""
    L, N = (200, 150) if small else (1000, 750)
    T, obs_dt = (4.0, 0.5) if small else (20.0, 0.5)
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.85, decay_length=0.2,
                             anchor_positions=None)
    ps = ParticleSystem(
        L=L, xlim=1, rate_diffusion=0, rate_active=5, beta=0.7,
        init="fixed", rho0_plus=grad[0], rho0_minus=grad[1], N=N,
        scale_rates=False, local_kernel_sigma=0.002, minus_anchor=True,
        periodic=False, immobilize_when_anchored=True, anchor_radius=0.003,
        anchor_positions=None, site_capacity=3,
        crowding_suppresses_rates=False, k_on=0, k_off=0, k_exit=0, rng=0,
        device=device)
    if ckpt_dir:
        out = ps.run_checkpointed(T=T, obs_dt=obs_dt, ckpt_dir=ckpt_dir,
                                  chunk_frames=8, record_fft=True,
                                  record_var=True, engine=engine)
    else:
        out = ps.run(T=T, obs_dt=obs_dt, record_fft=True, record_var=True,
                     engine=engine)
    v = ps.plot_individuals(out, show_k_max=5, cmap_name="viridis", xlim=1,
                            outdir=outdir)
    print(f"mean COM drift velocity: {v:.4g}; figures in {outdir}/")
    return out, v


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="particle_single_out")
    p.add_argument("--small", action="store_true",
                   help="reduced problem for a quick check")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "lattice_gas"],
                   help="lattice_gas = site-centric slot engine, same law")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint/resume the run in this directory "
                        "(kill + rerun resumes bit-identically)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.outdir, a.small, engine=a.engine, ckpt_dir=a.ckpt_dir,
         device=a.device)
