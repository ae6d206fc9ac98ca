"""Large-lattice run: both engines at L = 65,536, far past the reference's
1000 sites, on one card.

The counterpart of the JAX package's ``experiments/run_large_lattice.py``:

- the K = 1 site-centric lattice gas (``run_lattice_gas``, global m) at
  L = 65,536, N = L/2, β ∈ {0.5, 2.5}, T = 4 — exact particle-number
  conservation on the final occupancy, and |m| against the tanh fixed
  point (|m| < 0.1 below β = 1, |m − m_β| < 0.05 above it);
- the IMEX PDE at the same L with the banded implicit solve
  (``diffusion_solver='banded'``, ``pde_step`` in plain torch), 1500
  steps per β — mass conserved to 1e-4 and dm/dt within 15% of the
  Curie–Weiss reaction law.

``wall_time.json`` (each engine's wall, steps, site updates per second and
the lattice gas's µs per step) is written before the overview figure,
which is skipped where matplotlib is not installed.

The JAX driver shards the lattice axis over a 'space' mesh (``--n-devices
8``, on virtual CPU devices where the host has fewer).  Both arrays fit one
card whole (two replicas of 65,536 sites take a few MB), and the port
fakes no devices, so here ``--n-devices`` defaults to 1.  ``--n-devices
N`` > 1 splits the lattice axis over N of the host's devices
(``parallel.spatial.space_mesh``; more than the host has raises
``ValueError``): the particle half on ``space_sharding``, bit for bit the
unsharded half, and the PDE half on ``parallel.spatial.PDEFields``, whose
mass sums reassociate.  ``--grid`` runs the particle half on a (2 'sweep' ×
N/2 'space') ``grid_mesh`` instead.  ``particle_half`` and ``pde_half``
take a mesh, which may repeat a device (``space_mesh(devices=[...])``).

Usage: python -m hydrolim_tpu_torch.experiments.large_lattice [--small]
       [--outdir DIR] [--seed N] [--device cuda|cpu] [--n-devices N]
       [--grid]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import (
    ParticleConfig,
    PDEConfig,
    make_pde_params,
)
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.parallel.mesh import select_devices
from hydrolim_tpu_torch.parallel.spatial import (
    PDEFields,
    grid_mesh,
    grid_sharding,
    space_mesh,
    space_sharding,
)
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.run import substeps_for
from hydrolim_tpu_torch.pde.stepper import build_pde_ops, magnetization
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_dt
from hydrolim_tpu_torch.theory.meanfield import m_fixed_point

BETAS = np.array([0.5, 2.5], np.float32)
T, OBS_DT = 4.0, 0.5      # the ordered branch saturates at m_β by t ~ 2
RD, RA = 0.5, 2.0
LAM = 0.6


# The sharded PDE half against the unsharded one: its float32 mass sums
# reassociate segment by segment, each step's renormalization differs by
# an ulp or so, and the difference walks over the run's steps.  The bound,
# on m(t), the mass and the final density, each relative to its largest
# magnitude, is held by tests/test_torch_spatial.py (L=4096, 300 steps a
# beta, 2 and 4 segments: at most 8.0e-6 on the CPU) and by chip_smoke.py
# phase 20 (L=65,536, 1500 steps).
SHARDED_PDE_RTOL = 5e-5


def pde_max_rel(a: dict, b: dict) -> float:
    """The largest difference of two ``pde_half`` results' m(t), mass and
    final density, each relative to the first's largest magnitude."""
    out = 0.0
    for key in ("m_series", "mass", "rho_fin"):
        for beta, x in a[key].items():
            y = b[key][beta]
            out = max(out, float(np.abs(x - y).max() / np.abs(x).max()))
    return out


def meshes(n_devices: int, grid: bool, device):
    """(particle mesh, PDE mesh) of the driver's flags: None and None on
    one device; a 'space' mesh over the first ``n_devices`` of the host's
    devices of ``device``'s type for both; with ``grid`` the particle half
    on a (2, N/2) ('sweep', 'space') grid (the JAX driver's)."""
    kind = torch.device(device).type
    smesh = (space_mesh(n_devices, select_devices(n_devices, kind))
             if n_devices > 1 else None)
    if not grid:
        return smesh, smesh
    n_space = max(n_devices // 2, 1)
    return grid_mesh(2, n_space, select_devices(2 * n_space, kind)), smesh


def particle_half(L: int, seed: int, device, mesh=None) -> dict:
    """The lattice gas at L sites, N = L/2, the two β: its frames, final
    occupancy, wall and step count, with the driver's asserts.  ``mesh``:
    None, a 'space' mesh (``space_sharding``) or a ('sweep', 'space') grid
    (``grid_sharding``)."""
    N = L // 2
    config = ParticleConfig(L=L, xlim=1, N=N, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=True, site_capacity=1,
                            active_model="bidirectional")
    params = broadcast_params(config, beta=BETAS, rate_diffusion=RD,
                              rate_active=RA, device=device)
    dt = ensemble_dt(config, beta_max=float(BETAS.max()), rate_diffusion=RD,
                     rate_active=RA)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    shard = (None if mesh is None else grid_sharding(mesh)
             if mesh.devices.ndim == 2 else space_sharding(mesh))
    frames, occ = run_lattice_gas(config, params, T=T, obs_dt=OBS_DT, dt=dt,
                                  seed=seed, device=device, record_fft=False,
                                  occ_sharding=shard)
    m_traj = frames.m_global.abs().cpu().numpy()           # (2, M)
    n_final = occ.abs().reshape(2, -1).sum(-1).cpu().numpy()
    wall = time.perf_counter() - t0
    # the engine's own substep rule (ceil)
    n_steps = substeps_for(OBS_DT, dt) * (len(np.arange(0.0, T, OBS_DT)) - 1)
    assert np.all(n_final == N), ("particle number not conserved", n_final)
    m_lo, m_hi = float(m_traj[0, -1]), float(m_traj[1, -1])
    m_th = float(m_fixed_point(float(BETAS[1])))
    assert m_lo < 0.1, ("sub-critical |m| should stay small", m_lo)
    assert abs(m_hi - m_th) < 0.05, ("super-critical m off theory", m_hi,
                                     m_th)
    return dict(record=dict(wall_s=wall, dt=dt, steps=n_steps,
                            site_updates_per_s=2 * L * n_steps / wall,
                            us_per_step=1e6 * wall / n_steps,
                            m_sub=m_lo, m_super=m_hi, m_theory=m_th),
                total=frames.total[:, -1].cpu().numpy(), m_traj=m_traj,
                occ=occ.cpu().numpy())


def pde_rho0(L: int, seed: int, bi: int) -> np.ndarray:
    """β index ``bi``'s initial (2, L) densities (the JAX driver's draw)."""
    rng = np.random.default_rng(seed + bi)
    # small noise: the CW-rate check assumes near-uniform m(x)
    rho0 = np.clip(1.0 + 0.05 * rng.standard_normal((2, L)), 0.0, None)
    return rho0 / rho0.sum() * L        # mean total density ~1


def pde_grid(L: int, small: bool):
    """(config, γ, record stride) of the PDE half: the advection CFL sets
    dt = 0.5·dx/λ and γ = 2.5·dx²/dt keeps the banded inverse narrow (the
    JAX driver's large-L recipe)."""
    dx = 1.0 / L
    dt = 0.5 * dx / LAM
    gamma = 2.5 * dx * dx / dt
    nsteps = 300 if small else 1500
    config = PDEConfig(L=L, T=nsteps * dt, dt=dt, bc="periodic",
                       gaussian_kernel=False, diffusion_solver="banded",
                       snapshot_interval=max(nsteps // 4, 1), n_tracers=1)
    return config, gamma, max(nsteps // 100, 1)


def pde_run(config: PDEConfig, gamma: float, beta: float, rec_every: int,
            rho0: np.ndarray, device, mesh=None):
    """``pde_step`` from (1.2·ρ₀[0], 0.8·ρ₀[1]) (a seeded magnetization
    imbalance) for the config's steps; every ``rec_every`` steps the mean
    m and the mass.  Returns (m_t, mass_t, final total density) as
    numpy.  ``mesh``: a 'space' mesh the fields are split over
    (``parallel.spatial.PDEFields``; the records' sums all-reduced)."""
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device)
    params = make_pde_params(gamma=gamma, lam=LAM, beta=float(beta),
                             device=device)
    ops = build_pde_ops(config, gamma, device)
    rho = PDEFields(config, params, ops, as_t(1.2 * rho0[0]),
                    as_t(0.8 * rho0[1]), mesh)
    m_t, mass_t = [], []
    for _ in range(config.nsteps // rec_every):
        for _ in range(rec_every):
            rho.step()
        m_t.append(rho.mean(lambda o, p, m: magnetization(config, o, p, m)))
        mass_t.append(rho.sum(lambda o, p, m: p + m))
    host = lambda xs: torch.stack(xs).cpu().numpy()
    rp, rm = rho.fields()
    return host(m_t), host(mass_t), (rp + rm).cpu().numpy()


def pde_half(L: int, small: bool, seed: int, device, mesh=None) -> dict:
    """Both β on the banded PDE, with the driver's asserts; ``mesh``: a
    'space' mesh the fields are split over."""
    config, gamma, rec_every = pde_grid(L, small)
    nsteps, dt = config.nsteps, config.dt
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    m_series, rho_fin = {}, {}
    masses = {}
    for bi, beta in enumerate(BETAS):
        m_t, mass, rho = pde_run(config, gamma, beta, rec_every,
                                 pde_rho0(L, seed, bi), device, mesh)
        m_series[float(beta)], rho_fin[float(beta)] = m_t, rho
        masses[float(beta)] = mass
        assert abs(mass[-1] - mass[0]) / mass[0] < 1e-4, (
            "PDE mass not conserved", mass[0], mass[-1])
    wall = time.perf_counter() - t0
    record = dict(wall_s=wall, dt=dt, steps=2 * nsteps,
                  site_updates_per_s=2 * L * nsteps / wall, rates={})
    # the CFL dt gives ~0.02 time units: not enough to saturate m, enough
    # to pin dm/dt against the CW reaction law 2(sinh(βm) − m·cosh(βm))
    # (uniform-field limit; β=0.5 decays toward 0, β=2.5 grows toward m_β)
    T_pde = nsteps * dt
    for beta in BETAS:
        ms = m_series[float(beta)]
        rate_meas = float((ms[-1] - ms[0]) / (T_pde - rec_every * dt))
        m_mid = 0.5 * float(ms[0] + ms[-1])
        rate_th = 2.0 * (np.sinh(beta * m_mid) - m_mid * np.cosh(beta * m_mid))
        assert abs(rate_meas - rate_th) < 0.15 * abs(rate_th) + 1e-3, (
            "PDE m-drift off the CW reaction law", float(beta), rate_meas,
            rate_th)
        record["rates"][f"beta={beta:g}"] = {"measured": rate_meas,
                                             "theory": float(rate_th)}
    lo, hi = (m_series[float(b)] for b in BETAS)
    assert lo[-1] < lo[0], "sub-critical m must decay"
    assert hi[-1] > hi[0], "super-critical m must grow"
    return dict(record=record, m_series=m_series, rho_fin=rho_fin,
                mass=masses, rec_every=rec_every)


def plot_overview(outdir: str, L: int, part: dict, pde: dict,
                  where: str = "one device") -> None:
    plt = _pyplot()
    if plt is None:
        return
    coarse = lambda x: np.asarray(x).reshape(1024, -1).mean(-1)
    xs = np.linspace(0, 1, 1024, endpoint=False)
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    times = np.arange(0.0, T, OBS_DT)
    dt_pde = pde["record"]["dt"]
    for bi, beta in enumerate(BETAS):
        lab = f"β={beta:g}"
        axes[0, 0].plot(xs, coarse(part["total"][bi]), label=lab, lw=0.8)
        axes[0, 1].plot(times, part["m_traj"][bi], label=lab)
        axes[1, 0].plot(xs, coarse(pde["rho_fin"][float(beta)]), label=lab,
                        lw=0.8)
        ms = pde["m_series"][float(beta)]
        tt = (np.arange(len(ms)) + 1) * pde["rec_every"] * dt_pde
        axes[1, 1].plot(tt, np.abs(ms), label=lab)
    axes[0, 1].axhline(part["record"]["m_theory"], ls="--", c="k", lw=0.8,
                       label=r"$m_\beta$ theory")
    axes[0, 0].set_title(f"lattice gas ρ(x, T), L={L}")
    axes[0, 1].set_title("lattice gas |m|(t)")
    axes[1, 0].set_title("PDE ρ(x, T) (banded solve)")
    axes[1, 1].set_title("PDE |m|(t)")
    for ax in axes.flat:
        ax.legend(fontsize=8)
    fig.suptitle(f"L={L} lattice, particle half on {where}")
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "large_lattice_overview.png"), dpi=120)
    plt.close(fig)


def _mesh_name(mesh) -> str:
    if mesh is None:
        return "one device"
    if mesh.devices.ndim == 2:
        return (f"(2 'sweep' x {mesh.devices.shape[1]} 'space') grid of "
                f"{mesh.devices.size} devices")
    return f"'space' axis of {mesh.devices.size} devices"


def main(outdir: str = "large_lattice_out", small: bool = False,
         seed: int = 0, device: str = "cuda", n_devices: int = 1,
         grid: bool = False) -> dict:
    pmesh, smesh = meshes(n_devices, grid, device)
    L = 4096 if small else 65536
    os.makedirs(outdir, exist_ok=True)
    record = {"L": L, "N": L // 2, "n_devices": n_devices,
              "particle_mesh": ("2d-grid" if grid else "1d-space"
                                if pmesh is not None else "none"),
              "device": str(device),
              "mesh": {"particle": None if pmesh is None else pmesh.record(),
                       "pde": None if smesh is None else smesh.record()}}
    print(f"# {torch.device(device).type}: particle half on "
          f"{_mesh_name(pmesh)}, PDE half on {_mesh_name(smesh)}, L={L}",
          flush=True)
    part = particle_half(L, seed, device, pmesh)
    record["particle"] = part["record"]
    print(f"# lattice gas: {part['record']['wall_s']:.1f} s for "
          f"{part['record']['steps']} steps x 2 replicas "
          f"({part['record']['site_updates_per_s']:.3e} site-updates/s, "
          f"{part['record']['us_per_step']:.1f} us/step)", flush=True)
    pde = pde_half(L, small, seed, device, smesh)
    record["pde"] = pde["record"]
    print(f"# pde (banded): {pde['record']['wall_s']:.1f} s for "
          f"{pde['record']['steps'] // 2} steps x 2 betas "
          f"({pde['record']['site_updates_per_s']:.3e} site-updates/s)",
          flush=True)
    with open(os.path.join(outdir, "wall_time.json"), "w") as f:
        json.dump(record, f, indent=1)
    plot_overview(outdir, L, part, pde, _mesh_name(pmesh))
    print(json.dumps({k: v for k, v in record.items() if k != "L"}))
    return record


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="large_lattice_out")
    p.add_argument("--small", action="store_true",
                   help="L=4096, 300 PDE steps (a quick CPU run)")
    p.add_argument("--n-devices", type=int, default=1,
                   help="1 (the default): one device holds the whole "
                        "lattice; N > 1 splits the lattice axis over N of "
                        "the host's devices (no virtual devices: more than "
                        "the host has raises)")
    p.add_argument("--grid", action="store_true",
                   help="2-D mesh for the particle run: the two beta "
                        "replicas ride a 'sweep' axis of 2 while 'space' "
                        "splits the lattice over n_devices/2 "
                        "(parallel.spatial.grid_mesh)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.outdir, a.small, a.seed, a.device, a.n_devices, a.grid)
