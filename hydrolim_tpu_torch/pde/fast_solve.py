"""Fused PDE solve on kernel B2.

``pde_solve_fused`` advances the whole (β × runs) batch chunk by chunk, one
``pde_multi_step`` call per ``snapshot_interval`` steps (the last chunk
shorter when the interval does not divide the run), and returns the
per-step records (m, Var, v_eff, D_eff and the rfft re/im at every kmax),
the chunk-start snapshots and the final fields.  Semantics follow the XLA
``pde_solve`` of the JAX package: record at state n, tracer update at n, no
field step at n = nsteps; the snapshots are the states at the multiples of
the interval.

CUDA tensors run the kernel, CPU tensors its plain version.  The routing
(``_m_mode``, ``_solve_mode_of``) is the JAX package's, without its VMEM
budget: an exact solve needs no (L, L) matrix here.
"""
from __future__ import annotations

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.fields.magnetization import pde_magnetization
from hydrolim_tpu_torch.ops.convolve import periodic_gaussian_kernel
from hydrolim_tpu_torch.ops.diffusion import banded_kernel
from hydrolim_tpu_torch.ops.pde_kernel import (
    build_smooth_operands,
    build_solve_operands,
    pde_multi_step,
)
from hydrolim_tpu_torch.pde.stepper import (
    PDERecord,
    PDESolveResult,
    TracerState,
    _tracer_update,
    build_smooth_op,
)

_NARROW_R_MAX = 63   # taps per side of the narrow smoothing
_BANDED_R_MAX = 63   # taps per side of the banded solve

# The JAX package's PDE engines: its XLA solve and its fused Pallas kernel,
# which 'auto' picks where the configuration qualifies.  They share one law
# (the fields and the m/Var/v_eff/D_eff records), and the port's one engine,
# the fused solve, also records the per-step spectra the XLA solve records
# at every kmax, so all three names run it.
PDE_ENGINES = ("xla", "pallas", "auto")


def check_pde_engine(engine: str) -> None:
    """Accept the JAX package's PDE engine names (``PDE_ENGINES``)."""
    if engine not in PDE_ENGINES:
        raise ValueError(f"unknown PDE engine {engine!r}; the JAX package's "
                         f"names are {PDE_ENGINES}")


def _m_mode(config: PDEConfig) -> str:
    """The kernel's magnetization mode: 'pointwise', 'global', 'narrow' or
    'smooth'.  A kernel much wider than the domain (the reference β-sweep's
    σ = 1e5−10, just under the >1e5 sentinel) is uniform to below f32
    resolution and routes to the exact global mean; a kernel much narrower
    than the domain applies as its 2r+1 centre taps (truncated at 5.7σ, a
    relative tail < 1e-7 that cancels in the num/den ratio)."""
    if not config.gaussian_kernel:
        return "pointwise"
    if config.kernel_sigma > 1e5:
        return "global"
    sigma_grid = config.kernel_sigma / config.dx
    if (config.L / 2.0) ** 2 / (2.0 * sigma_grid * sigma_grid) < 1e-8:
        return "global"
    r = _narrow_radius(config)
    if 1 <= r <= _NARROW_R_MAX and 2 * r + 1 < config.L:
        return "narrow"
    return "smooth"


def _narrow_radius(config: PDEConfig) -> int:
    """Tap radius covering the Gaussian to a relative tail < ~1e-7
    (exp(-r²/2σ²) < 1e-7 at r ≈ 5.7σ), rounded up to a multiple of 16
    (capped at the narrow bound), as the JAX package rounds it: nearby σ
    values share one radius, and the extra taps carry ~zero weight."""
    sigma_grid = config.kernel_sigma / config.dx
    r = int(np.ceil(5.7 * sigma_grid))
    if r <= _NARROW_R_MAX:
        r = min(-(-r // 16) * 16, _NARROW_R_MAX)
    return r


def build_narrow_weights(config: PDEConfig) -> np.ndarray:
    """(2r+1,) float32 symmetric circulant taps, w(d) = k(d mod L) at
    r + d."""
    r = _narrow_radius(config)
    k = periodic_gaussian_kernel(config.L, config.dx, config.kernel_sigma)
    return np.array([k[d % config.L] for d in range(-r, r + 1)], np.float32)


def _solve_mode_of(config: PDEConfig, gamma: float):
    """(solve_mode, solve_r) for the fused kernel: 'none' for γ = 0 or the
    identity; 'banded' where the XLA engine would apply the truncated
    banded taps (``diffusion_solver='banded'``, or the auto solver past
    L = 8192) on a periodic lattice and they fit ``_BANDED_R_MAX``, the
    radius rounded up to a multiple of 16 (capped); else 'exact'."""
    if config.solver_kind == "identity" or gamma == 0.0:
        return "none", 0
    if config.solver_kind == "banded":
        try:
            r = (len(banded_kernel(config.dx, config.dt, gamma)) - 1) // 2
        except ValueError:
            return "exact", 0
        if r <= _BANDED_R_MAX:
            return "banded", min(-(-max(r, 1) // 16) * 16, _BANDED_R_MAX)
    return "exact", 0


def build_banded_solve_weights(config: PDEConfig, gamma: float,
                               solve_r: int) -> np.ndarray:
    """(2·solve_r+1,) float32 symmetric truncated taps of A⁻¹, w(d) at
    solve_r + d, zero past the kernel's own radius."""
    w = banded_kernel(config.dx, config.dt, gamma)
    r = (len(w) - 1) // 2
    out = np.zeros(2 * solve_r + 1, np.float32)
    out[solve_r - r:solve_r + r + 1] = w
    return out


def kernel_operands(config: PDEConfig, gamma: float, device="cuda"):
    """(m_mode, solve_mode, SmoothOperands or None, SolveOperands or None)
    of a configuration."""
    m_mode = _m_mode(config)
    solve_mode, solve_r = _solve_mode_of(config, gamma)
    weights = None
    if m_mode == "narrow":
        weights = build_narrow_weights(config)
    elif m_mode == "smooth":            # the circulant's first row
        weights = periodic_gaussian_kernel(config.L, config.dx,
                                           config.kernel_sigma)
    smooth = build_smooth_operands(m_mode, weights, device)
    solve = build_solve_operands(
        config.L, config.dx, config.dt, gamma, config.bc == "periodic",
        solve_mode, device,
        weights=(build_banded_solve_weights(config, gamma, solve_r)
                 if solve_mode == "banded" else None))
    return m_mode, solve_mode, smooth, solve


def _rfft_ri(total: torch.Tensor, kmax: int, L: int) -> torch.Tensor:
    X = torch.fft.rfft(total, dim=-1)[..., :kmax] / L
    return torch.stack([X.real, X.imag], dim=-1).to(torch.float32)


def pde_solve_fused(config: PDEConfig, params_b: PDEParams,
                    rho_p0: torch.Tensor, rho_m0: torch.Tensor,
                    tracers0: TracerState, generator: torch.Generator,
                    keep_snapshots: bool = True) -> PDESolveResult:
    """Batched fused solve on the device of ``rho_p0``.

    ``generator`` (on that device) seeds the kernel's Philox streams and
    supplies the plain version's draws and the final iteration's."""
    gamma_b = params_b.gamma.reshape(-1)
    gamma = float(gamma_b[0])
    if not bool(torch.all(gamma_b == gamma_b[0])):
        raise ValueError("pde_solve_fused needs a uniform gamma")
    if config.n_tracers < 1:
        raise ValueError("pde_solve_fused needs n_tracers >= 1")
    dev = rho_p0.device
    B, L, dt = rho_p0.shape[0], config.L, config.dt
    n_t, W, kmax = config.n_tracers, config.tracer_window, config.kmax
    nsteps, interval = config.nsteps, config.snapshot_interval
    starts = list(range(0, nsteps, interval))
    m_mode, solve_mode, smooth, solve = kernel_operands(config, gamma, dev)
    periodic = config.bc == "periodic"

    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    scal = torch.zeros((B, 4), dtype=torch.float32, device=dev)
    scal[:, 0] = params_b.beta.reshape(-1)
    scal[:, 1] = params_b.lam.reshape(-1)
    scal[:, 2] = gamma
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=generator,
                          device=dev, dtype=torch.int32)
    rho_p, rho_m = f32(rho_p0), f32(rho_m0)
    pos, spin = f32(tracers0.unwrapped), f32(tracers0.spin)
    hist = f32(tracers0.hist)

    recs, snaps, m_snaps = [], [], []
    for n0 in starts:
        if keep_snapshots:
            snaps.append(rho_p + rho_m)
            m_snaps.append(rho_p - rho_m)
        rho_p, rho_m, pos, spin, hist, rec = pde_multi_step(
            scal, seeds, n0, rho_p, rho_m, pos, spin, hist, solve, smooth,
            L=L, n_t=n_t, window=W, k_steps=min(interval, nsteps - n0),
            dt=dt, xlim=config.xlim, periodic=periodic, m_mode=m_mode,
            solve_mode=solve_mode,
            bidirectional=config.active_model == "bidirectional",
            kmax_rec=kmax, generator=generator)
        recs.append(rec)
    recs = torch.cat(recs, dim=1)                    # (B, nsteps, 4 + 2k)

    # final iteration (n = nsteps): record + tracer update, no step; m as
    # the XLA path takes it (the full circulant, also for a narrow kernel)
    m_field = pde_magnetization(rho_p, rho_m, build_smooth_op(config, dev),
                                kernel_sigma=config.kernel_sigma)
    total = rho_p + rho_m
    tr = TracerState(pos=torch.remainder(pos, config.xlim), unwrapped=pos,
                     spin=spin.to(torch.int32), hist=hist)
    _, v_f, D_f = _tracer_update(config, params_b, m_field, tr, nsteps,
                                 generator=generator)
    cat = lambda a, b: torch.cat([a, b[:, None]], dim=1)
    m_mean = cat(recs[:, :, 0], m_field.mean(-1))
    var = cat(recs[:, :, 1], total.var(-1, unbiased=False))
    v_eff = cat(recs[:, :, 2], v_f)
    D_eff = cat(recs[:, :, 3], D_f)
    per = torch.stack([recs[:, :, 4:4 + kmax],
                       recs[:, :, 4 + kmax:4 + 2 * kmax]], -1)
    fft_ri = torch.cat([per, _rfft_ri(total, kmax, L)[:, None]], dim=1)
    if keep_snapshots:
        if nsteps % interval == 0:      # the final state is a block start
            snaps.append(total)
            m_snaps.append(rho_p - rho_m)
        snapshots = torch.stack(snaps, dim=1)
        m_snapshots = torch.stack(m_snaps, dim=1)
        snap_times = (torch.arange(len(snaps), dtype=torch.float32,
                                   device=dev) * (interval * dt)).expand(
            B, len(snaps))
    else:
        snapshots = torch.zeros((B, 0, L), device=dev)
        m_snapshots = torch.zeros((B, 0, L), device=dev)
        snap_times = torch.zeros((B, 0), device=dev)
    records = PDERecord(m_mean=m_mean, var=var, fft_ri=fft_ri, v_eff=v_eff,
                        D_eff=D_eff)
    if config.record_every > 1:
        e = config.record_every
        records = PDERecord(*(getattr(records, f)[:, ::e] for f in
                              ("m_mean", "var", "fft_ri", "v_eff", "D_eff")))
    return PDESolveResult(rho_p=rho_p, rho_m=rho_m, records=records,
                          snapshots=snapshots, m_snapshots=m_snapshots,
                          snap_times=snap_times)


def result_to_numpy(res: PDESolveResult) -> PDESolveResult:
    """The same result with every tensor moved to host numpy arrays."""
    np_ = lambda t: t.detach().cpu().numpy()
    rec = res.records
    return PDESolveResult(
        rho_p=np_(res.rho_p), rho_m=np_(res.rho_m),
        records=PDERecord(m_mean=np_(rec.m_mean), var=np_(rec.var),
                          fft_ri=np_(rec.fft_ri), v_eff=np_(rec.v_eff),
                          D_eff=np_(rec.D_eff)),
        snapshots=np_(res.snapshots), m_snapshots=np_(res.m_snapshots),
        snap_times=np_(res.snap_times))
