"""Fused PDE solve on kernel B2.

``pde_solve_fused`` advances the whole (β × runs) batch chunk by chunk, one
``pde_multi_step`` call per ``snapshot_interval`` steps, and returns the
per-step records (m, Var, v_eff, D_eff, rfft re/im), the chunk-start
snapshots and the final fields.  Semantics follow ``pde_solve``: record at
state n, tracer update at n, no field step at n = nsteps.

CUDA tensors run the kernel, CPU tensors its plain version.  Per-step
spectra ride the record rows when kmax ≤ 62; a wider kmax is recorded at
chunk starts only (the other rows NaN).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.ops.pde_kernel import (
    MAX_KMAX_REC,
    build_solve_operands,
    m_field_of,
    pde_multi_step,
)
from hydrolim_tpu_torch.pde.stepper import (
    PDERecord,
    PDESolveResult,
    TracerState,
    _tracer_update,
)

def _m_mode(config: PDEConfig) -> str:
    """The kernel's magnetization mode: 'pointwise', 'global' or 'smooth'
    (not ported; the JAX package splits it into narrow and smooth).  A
    kernel much wider than the domain (the reference β-sweep's σ = 1e5−10,
    just under the >1e5 sentinel) is uniform to below f32 resolution and
    routes to the exact global mean."""
    if not config.gaussian_kernel:
        return "pointwise"
    if config.kernel_sigma > 1e5:
        return "global"
    sigma_grid = config.kernel_sigma / config.dx
    if (config.L / 2.0) ** 2 / (2.0 * sigma_grid * sigma_grid) < 1e-8:
        return "global"
    return "smooth"


def _kmax_rec(config: PDEConfig) -> int:
    """Per-step in-kernel spectra bins, or 0 when kmax is too wide."""
    k = config.kmax
    return k if k <= MAX_KMAX_REC else 0


def _solve_mode_of(config: PDEConfig, gamma: float) -> str:
    if config.solver_kind == "identity" or gamma == 0.0:
        return "none"
    if config.solver_kind in ("fft", "dct", "dense"):
        return "exact"
    raise NotImplementedError(
        f"diffusion solver {config.solver_kind!r} is not ported")


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
    nsteps, k_chunk = config.nsteps, config.snapshot_interval
    if config.n_tracers < 1 or nsteps % k_chunk != 0:
        raise ValueError("pde_solve_fused needs n_tracers >= 1 and nsteps "
                         "a multiple of snapshot_interval")
    dev = rho_p0.device
    B, L, dt = rho_p0.shape[0], config.L, config.dt
    n_t, W = config.n_tracers, config.tracer_window
    n_chunks = nsteps // k_chunk
    m_mode = _m_mode(config)
    solve_mode = _solve_mode_of(config, gamma)
    periodic = config.bc == "periodic"
    solve = build_solve_operands(L, config.dx, dt, gamma, periodic,
                                 solve_mode, dev)
    kmax, kmax_rec = config.kmax, _kmax_rec(config)

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

    recs, snaps, m_snaps, fft_chunks = [], [], [], []
    for c in range(n_chunks):
        if keep_snapshots:
            snaps.append(rho_p + rho_m)
            m_snaps.append(rho_p - rho_m)
        if kmax_rec == 0:
            fft_chunks.append(_rfft_ri(rho_p + rho_m, kmax, L))
        rho_p, rho_m, pos, spin, hist, rec = pde_multi_step(
            scal, seeds, c * k_chunk, rho_p, rho_m, pos, spin, hist, solve,
            L=L, n_t=n_t, window=W, k_steps=k_chunk, dt=dt,
            xlim=config.xlim, periodic=periodic, m_mode=m_mode,
            solve_mode=solve_mode,
            bidirectional=config.active_model == "bidirectional",
            kmax_rec=kmax_rec, generator=generator)
        recs.append(rec)
    recs = torch.cat(recs, dim=1)                    # (B, nsteps, 4 + 2k)

    # final iteration (n = nsteps): record + tracer update, no step
    m_field = m_field_of(m_mode, rho_p, rho_m)
    total = rho_p + rho_m
    tr = TracerState(pos=torch.remainder(pos, config.xlim), unwrapped=pos,
                     spin=spin.to(torch.int32), hist=hist)
    _, v_f, D_f = _tracer_update(config, params_b, m_field, tr, nsteps,
                                 generator=generator)
    fft_f = _rfft_ri(total, kmax, L)
    cat = lambda a, b: torch.cat([a, b[:, None]], dim=1)
    m_mean = cat(recs[:, :, 0], m_field.mean(-1))
    var = cat(recs[:, :, 1], total.var(-1, unbiased=False))
    v_eff = cat(recs[:, :, 2], v_f)
    D_eff = cat(recs[:, :, 3], D_f)
    if kmax_rec > 0:
        per = torch.stack([recs[:, :, 4:4 + kmax_rec],
                           recs[:, :, 4 + kmax_rec:4 + 2 * kmax_rec]], -1)
        fft_ri = torch.cat([per, fft_f[:, None]], dim=1)
    else:
        fft_ri = torch.full((B, nsteps + 1, kmax, 2), math.nan,
                            dtype=torch.float32, device=dev)
        fft_ri[:, 0:nsteps:k_chunk] = torch.stack(fft_chunks, dim=1)
        fft_ri[:, nsteps] = fft_f
    if keep_snapshots:
        snapshots = torch.stack(snaps + [total], dim=1)
        m_snapshots = torch.stack(m_snaps + [rho_p - rho_m], dim=1)
        snap_times = (torch.arange(n_chunks + 1, dtype=torch.float32,
                                   device=dev) * (k_chunk * dt)).expand(
            B, n_chunks + 1)
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

