"""``IMEXPDE`` — the user-facing PDE facade with the reference's API surface.

Constructor kwargs are the JAX package's (``hydrolim_tpu/pde/system.py``,
after IMEX_PDE_solver_class.py:13-29) plus ``device``;
``initialize(mode, rho0, noise, n_tracers)``, ``solve()``, ``get_output()``
and ``plot_all()``/``plot_individual()`` keep the same names and output
schema.  ``solve()`` runs ``pde_solve_fused`` — kernel B2 on the card —
with per-step spectra at every ``kmax`` (the full rfft by default), as the
JAX facade's default XLA solve records them.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.pde.fast_solve import (
    check_pde_engine,
    pde_solve_fused,
    result_to_numpy,
)
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.pde.stepper import PDESolveResult


class IMEXPDE:
    def __init__(
        self,
        L: int = 1000,
        xlim: float = 1.0,
        T: float = 10.0,
        dt: float = 5e-4,
        gamma: float = 2.33e-4,
        lam: float = 0.6,
        beta: float = 2.0,
        bc: str = "periodic",
        active_model: str = "bidirectional",
        gaussian_kernel: bool = False,
        kernel_sigma: float = 0.02,
        snapshot_interval: int = 50,
        outdir: str = "IMEX_output",
        seed: Optional[int] = None,
        diffusion_solver: str = "auto",
        fft_kmax: Optional[int] = None,
        legacy_double_diffusion: bool = False,
        make_outdir: bool = False,
        device: str = "cuda",
    ):
        if diffusion_solver == "auto" and float(gamma) == 0.0:
            diffusion_solver = "identity"   # A = I exactly; skip the solve
        self.config = PDEConfig(
            L=L, xlim=xlim, T=T, dt=dt, bc=bc, active_model=active_model,
            gaussian_kernel=gaussian_kernel, kernel_sigma=kernel_sigma,
            snapshot_interval=snapshot_interval,
            diffusion_solver=diffusion_solver, fft_kmax=fft_kmax,
            legacy_double_diffusion=legacy_double_diffusion)
        self.device = torch.device(device)
        one = lambda v: torch.full((1,), float(v), dtype=torch.float32,
                                   device=self.device)
        self.params = PDEParams(gamma=one(gamma), lam=one(lam),
                                beta=one(beta))
        self.outdir = Path(outdir)
        if make_outdir:
            self.outdir.mkdir(parents=True, exist_ok=True)
        self.seed = seed if seed is not None else int(
            np.random.SeedSequence().entropy % (2 ** 63))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.rho_mean = 1.0 / xlim
        self._result: Optional[PDESolveResult] = None

    # -- reference-compatible attributes ------------------------------------
    @property
    def L(self):
        return self.config.L

    @property
    def dx(self):
        return self.config.dx

    @property
    def x(self):
        return np.linspace(0, self.config.xlim, self.config.L, endpoint=False)

    @property
    def T(self):
        return self.config.T

    @property
    def dt(self):
        return self.config.dt

    @property
    def nsteps(self):
        return self.config.nsteps

    @property
    def gamma(self):
        return float(self.params.gamma[0])

    @property
    def lam(self):
        return float(self.params.lam[0])

    @property
    def beta(self):
        return float(self.params.beta[0])

    # -----------------------------------------------------------------------
    def initialize(self, mode: str = "poisson", rho0: float = 1.0,
                   noise: float = 0.2, n_tracers: int = 1000) -> None:
        """Initial conditions: ``rho_p``/``rho_m`` (1, L) and ``tracers``
        (one replica).  ``mode='poisson'`` reproduces the reference quirk:
        a centred exponential bump ``exp(−|x−0.5|/0.05)``, not Poisson
        noise."""
        self.n_tracers = n_tracers
        self.rho_p, self.rho_m, self.tracers = pde_initialize(
            self.config, self.generator, B=1, mode=mode, rho0=rho0,
            noise=noise, n_tracers=n_tracers, device=self.device)

    def solve(self, engine: str = "xla") -> None:
        """Advance the full T horizon through ``pde_solve_fused``.
        ``engine`` takes the JAX package's names, which all run it
        (``fast_solve.PDE_ENGINES``)."""
        check_pde_engine(engine)
        cfg = self.config if self.config.n_tracers == self.n_tracers \
            else dataclasses.replace(self.config, n_tracers=self.n_tracers)
        res = result_to_numpy(pde_solve_fused(
            cfg, self.params, self.rho_p, self.rho_m, self.tracers,
            self.generator))
        first = lambda a: a[0]
        self._result = PDESolveResult(
            rho_p=first(res.rho_p), rho_m=first(res.rho_m),
            records=type(res.records)(*(first(getattr(res.records, f))
                                        for f in ("m_mean", "var", "fft_ri",
                                                  "v_eff", "D_eff"))),
            snapshots=first(res.snapshots),
            m_snapshots=first(res.m_snapshots),
            snap_times=first(res.snap_times))

    def get_output(self) -> Dict[str, Any]:
        """Reference output schema (IMEX_PDE_solver_class.py:293-306)."""
        assert self._result is not None, "call solve() first"
        r = self._result
        rec = r.records
        n_iters = self.config.n_records   # == nsteps+1 at record_every=1
        # snapshot times recorded at block starts that are true iterations
        n_snap = int(np.sum(np.asarray(r.snap_times) <= self.config.T + 1e-9))
        fft_c = np.asarray(rec.fft_ri[..., 0] + 1j * rec.fft_ri[..., 1],
                           dtype=np.complex64)
        return dict(
            rho_p=np.asarray(r.rho_p),
            rho_m=np.asarray(r.rho_m),
            m_series=np.asarray(rec.m_mean)[:n_iters],
            var_series=np.asarray(rec.var)[:n_iters],
            fft_amp=np.abs(fft_c)[:n_iters],
            fft_phase=fft_c[:n_iters],
            snapshots=np.asarray(r.snapshots)[:n_snap],
            m_snapshots=np.asarray(r.m_snapshots)[:n_snap],
            times=np.asarray(r.snap_times)[:n_snap],
            v_eff_series=np.asarray(rec.v_eff)[:n_iters],
            D_eff_series=np.asarray(rec.D_eff)[:n_iters],
        )

    # plotting lives in viz.pde_plots; thin methods for API parity
    def plot_all(self):
        from hydrolim_tpu_torch.viz.pde_plots import plot_all
        plot_all(self, self.get_output())

    def plot_individual(self, k_max: int = 6):
        from hydrolim_tpu_torch.viz.pde_plots import plot_individual
        plot_individual(self, self.get_output(), k_max=k_max)
