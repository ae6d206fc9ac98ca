"""Anchored binding/exit β-sweep — the reference's commented-out anchored
configuration run end to end, on the plain-torch anchored slot engine
(``--engine particle``: on the general τ-leap step).

The port of the JAX package's ``experiments/run_anchored_exits.py``.
Reference: PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:845-856 (anchors
(0.25, 0.60, 0.80), k_on=10, k_off=5, k_exit=5, minus_anchor,
immobilize_when_anchored, L=1000, N=500), with the exits-per-anchor figure
and the A·ρ̄·Sₐ·(1−m_β)/2 fit of :660-825 / :975-982 (``plot_outs``).

It exercises the bind → immobilise → exit channels at sweep scale: minus
particles binding at anchor sites (k_on), unbinding (k_off) and leaving
for good from a bound anchored state (k_exit), N shrinking over the run.

The reference's config says ``site_capacity=1``, but its bind gate
``occ_total[pos] < K`` counts the particle itself
(PARTICLE_solver_CLASS.py:342-344), so at K=1 binding never fires: the
default is K=3 (the flagship capacity); ``--K 1`` reproduces the
reference's zero exits.

Writes ``anchored_exits.json`` (per β the total and per-anchor exits, the
fitted Sₐ, and per replica the exit count, final N and exit sites) and,
where matplotlib is installed, ``exits_vs_beta.png``.  The grid runs on the
card unless ``--device cpu``.

Usage: python -m hydrolim_tpu_torch.experiments.anchored_exits
       [--outdir DIR] [--small] [--K 3] [--engine lattice_gas|particle]
       [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from hydrolim_tpu_torch.sweeps.beta_sweep import (
    make_exp_gradient,
    sweep_over_betas,
)
from hydrolim_tpu_torch.viz.exit_plots import fit_capture_amplitudes, plot_outs

ANCHORS = (0.25, 0.60, 0.80)


def anchored_ps_kwargs(L: int, N: int, K: int) -> dict:
    """The reference's anchored sweep configuration at capacity K."""
    return dict(
        L=L, xlim=1, rate_diffusion=0.02, rate_active=5, N=N,
        init="poisson", scale_rates=False, local_kernel_sigma=0.005,
        minus_anchor=True, periodic=False, immobilize_when_anchored=True,
        anchor_radius=0.003, anchor_positions=list(ANCHORS),
        site_capacity=K, crowding_suppresses_rates=False,
        k_on=10, k_off=5, k_exit=5,
    )


def main(outdir: str = "anchored_exits_out", small: bool = False,
         seed: int = 11, K: int = 3, engine: str = "lattice_gas",
         device: str = "cuda") -> dict:
    L, N = (200, 100) if small else (1000, 500)
    T, obs_dt = (4.0, 0.2) if small else (20.0, 0.1)
    n_beta, n_runs = (3, 2) if small else (11, 3)
    beta_values = np.linspace(0.0, 3.0, n_beta)
    ps_kwargs = anchored_ps_kwargs(L, N, K)
    # one gradient call covers both profiles: decay_length shapes only the
    # + profile; the − profile is flat plus the anchor peaks
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=ANCHORS,
                             anchor_peak_width=0.01, anchor_peak_mass=0.03)
    run_kwargs = dict(T=T, obs_dt=obs_dt)

    save = sweep_over_betas(
        beta_values, n_runs_per_beta=n_runs, ps_kwargs=ps_kwargs,
        init_kwargs=dict(rho0_plus=grad[0], rho0_minus=grad[1]),
        run_kwargs=run_kwargs,
        npz_path=f"{outdir}/anchored_exits_sweep.npz", outdir=outdir,
        seed=seed, keep_outs=True, do_fit=False, plot_result=False,
        engine=engine, device=device)

    outs = save["outs"]
    total_mean, total_std, region_mean, region_std = plot_outs(
        beta_values, n_runs, ps_kwargs, run_kwargs, outs,
        do_theory_fit=True, plot_theory=True, outdir=outdir)
    S_fits = fit_capture_amplitudes(beta_values, ps_kwargs, run_kwargs,
                                    region_mean, region_std)[0]
    flat = [o for row in outs for o in row]
    res = {
        "beta_values": beta_values.tolist(), "n_runs": n_runs, "K": K,
        "L": L, "N": N, "seed": seed, "route": str(save["route"]),
        "total_mean": total_mean.tolist(), "total_std": total_std.tolist(),
        "region_mean": region_mean.tolist(),
        "region_std": region_std.tolist(), "S_fits": S_fits.tolist(),
        "exit_counts": [len(o["exit_times"]) for o in flat],
        "n_final": ((save["spins_final"] != 0).sum((1, 2)).tolist()
                    if "spins_final" in save else
                    [int(o["alive_frames"][-1].sum()) for o in flat]),
        "exit_sites": [np.asarray(o["exit_positions"], int).tolist()
                       for o in flat],
    }
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "anchored_exits.json").write_text(json.dumps(res))
    print("total exits per beta:", np.round(total_mean, 2))
    print("per-anchor exits at beta=0:", np.round(region_mean[0], 2))
    print("fitted S_a per anchor:", np.round(S_fits, 4))
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="anchored_exits_out")
    p.add_argument("--small", action="store_true")
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--engine", default="lattice_gas",
                   choices=["particle", "lattice_gas"])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.outdir, a.small, K=a.K, engine=a.engine, device=a.device)
