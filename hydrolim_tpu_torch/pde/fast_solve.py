"""Fused PDE solve on kernel B2.

``pde_solve_fused`` advances the whole (β × runs) batch block by block
(``PDERun``), one ``pde_multi_step`` call per ``snapshot_interval`` steps
(the last block shorter when the interval does not divide the run), and
returns the per-step records (m, Var, v_eff, D_eff and the rfft re/im at
every kmax), the block-start snapshots and the final fields.  Semantics follow the XLA
``pde_solve`` of the JAX package: record at state n, tracer update at n, no
field step at n = nsteps; the snapshots are the states at the multiples of
the interval.

CUDA tensors run the kernel, CPU tensors its plain version.  The routing
(``_m_mode``, ``_solve_mode_of``) is the JAX package's, without its VMEM
budget: an exact solve needs no (L, L) matrix here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.fields.magnetization import pde_magnetization
from hydrolim_tpu_torch.ops.convolve import periodic_gaussian_kernel
from hydrolim_tpu_torch.ops.diffusion import banded_kernel
from hydrolim_tpu_torch.parallel import draws
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


def _replica(v, i: int):
    """Replica i's value of a per-replica parameter (a scalar as it is)."""
    t = torch.as_tensor(v)
    return t.reshape(-1)[i:i + 1] if t.numel() > 1 else v


def _rfft_ri(total: torch.Tensor, kmax: int, L: int) -> torch.Tensor:
    X = torch.fft.rfft(total, dim=-1)[..., :kmax] / L
    return torch.stack([X.real, X.imag], dim=-1).to(torch.float32)


class PDERun:
    """The fixed parts of one batched fused solve on the device of
    ``device``: the kernel's modes and operands, its scalars and the
    snapshot-block grid, ``n_blocks = ceil((nsteps + 1) / interval)``
    blocks (the JAX package's), block b starting at step
    n0 = b·interval, the last one holding the final iteration.

    ``start`` makes the carry of block 0 (fields, tracers with their
    displacement ring, B2's Philox seeds drawn from the generator, the
    generator); ``run_range`` runs blocks [lo, hi): for each its snapshot
    (where kept), one ``pde_multi_step`` call with ``step0 = n0`` over the
    block's steps, and in the last block the final iteration (record and
    tracer update at n = nsteps, no field step).  Its records are the
    per-iteration rows (B, n, 4 + 2·kmax): m, Var, v_eff, D_eff and the
    rfft re/im.  The ring slot and the D_eff window are functions of the
    global step, so ranges stitch bit for bit given the carry
    (``utils.checkpoint.pde_solve_checkpointed``); ``finish`` assembles
    the ``PDESolveResult``."""

    route = "pde_multi_step"

    def __init__(self, config: PDEConfig, params_b: PDEParams, *, device,
                 keep_snapshots: bool = True, b0: int = 0):
        self.b0 = b0
        gamma_b = params_b.gamma.reshape(-1)
        gamma = float(gamma_b[0])
        if not bool(torch.all(gamma_b == gamma_b[0])):
            raise ValueError("pde_solve_fused needs a uniform gamma")
        if config.n_tracers < 1:
            raise ValueError("pde_solve_fused needs n_tracers >= 1")
        self.config, self.params_b = config, params_b
        self.device = dev = torch.device(device)
        self.keep_snapshots = keep_snapshots
        (self.m_mode, self.solve_mode, self.smooth,
         self.solve) = kernel_operands(config, gamma, dev)
        B = params_b.beta.reshape(-1).shape[0]
        self.scal = torch.zeros((B, 4), dtype=torch.float32, device=dev)
        self.scal[:, 0] = params_b.beta.reshape(-1)
        self.scal[:, 1] = params_b.lam.reshape(-1)
        self.scal[:, 2] = gamma
        self.n_blocks = -(-(config.nsteps + 1) // config.snapshot_interval)

    def for_rows(self, params_b: PDEParams, device, b0: int) -> "PDERun":
        """The same solve over rows [b0, b0 + len(params_b)) of the batch
        on ``device``: B2 keys their streams on their global index
        (``parallel.mesh.ShardedRun``)."""
        return PDERun(self.config, params_b, device=device,
                      keep_snapshots=self.keep_snapshots, b0=b0)

    def start(self, rho_p0: torch.Tensor, rho_m0: torch.Tensor,
              tracers0: TracerState, generator: torch.Generator) -> dict:
        f32 = lambda t: t.to(device=self.device,
                             dtype=torch.float32).contiguous()
        seeds = torch.randint(0, 2 ** 31 - 1, (rho_p0.shape[0],),
                              generator=generator, device=self.device,
                              dtype=torch.int32)
        return dict(rho_p=f32(rho_p0), rho_m=f32(rho_m0),
                    pos=f32(tracers0.unwrapped), spin=f32(tracers0.spin),
                    hist=f32(tracers0.hist), seeds=seeds, gen=generator)

    def _final_row(self, rho_p, rho_m, pos, spin, hist, gen):
        """The final iteration's record row (B, 1, 4 + 2·kmax); m as the
        XLA path takes it (the full circulant, also for a narrow kernel).
        The tracer draws are made for the batch, as ``_tracer_update``
        makes them; every transform and reduction then runs on one replica
        at a time, so a replica's row does not depend on which replicas
        share the call (the blocks of ``parallel.mesh.ShardedRun``): on the
        card a batched matmul, FFT or row reduction picks its algorithm by
        the row count, and the row would differ from the one-device run's
        in its last bits."""
        config, dev = self.config, self.device
        smooth = build_smooth_op(config, dev)
        flip_u = draws.rand(pos.shape, gen, pos.device)
        z = draws.randn(pos.shape, gen, pos.device)
        rows = []
        for i in range(rho_p.shape[0]):
            r = slice(i, i + 1)
            m_field = pde_magnetization(rho_p[r], rho_m[r], smooth,
                                        kernel_sigma=config.kernel_sigma)
            total = rho_p[r] + rho_m[r]
            tr = TracerState(pos=torch.remainder(pos[r], config.xlim),
                             unwrapped=pos[r], spin=spin[r].to(torch.int32),
                             hist=hist[r])
            params = PDEParams(**{
                f.name: _replica(getattr(self.params_b, f.name), i)
                for f in dataclasses.fields(PDEParams)})
            _, v_f, D_f = _tracer_update(config, params, m_field, tr,
                                         config.nsteps,
                                         _inject=(flip_u[r], z[r]))
            ri = _rfft_ri(total, config.kmax, config.L)
            col = lambda a: a[:, None]
            rows.append(torch.cat([col(m_field.mean(-1)),
                                   col(total.var(-1, unbiased=False)),
                                   col(v_f), col(D_f), ri[..., 0],
                                   ri[..., 1]], dim=1))
        return torch.cat(rows)[:, None]

    def run_range(self, carry: dict, lo: int, hi: int):
        config = self.config
        L, dt, nsteps = config.L, config.dt, config.nsteps
        interval = config.snapshot_interval
        rho_p, rho_m, pos, spin, hist = (
            carry[k] for k in ("rho_p", "rho_m", "pos", "spin", "hist"))
        seeds, gen = carry["seeds"], carry["gen"]
        recs, snaps, m_snaps = [], [], []
        for b in range(lo, hi):
            n0 = b * interval
            if self.keep_snapshots:
                snaps.append(rho_p + rho_m)
                m_snaps.append(rho_p - rho_m)
            k = min(interval, nsteps - n0)
            if k > 0:
                rho_p, rho_m, pos, spin, hist, rec = pde_multi_step(
                    self.scal, seeds, n0, rho_p, rho_m, pos, spin, hist,
                    self.solve, self.smooth, L=L, n_t=config.n_tracers,
                    window=config.tracer_window, k_steps=k, dt=dt,
                    xlim=config.xlim, periodic=config.bc == "periodic",
                    m_mode=self.m_mode, solve_mode=self.solve_mode,
                    bidirectional=config.active_model == "bidirectional",
                    kmax_rec=config.kmax, b0=self.b0, generator=gen)
                recs.append(rec)
            if b == self.n_blocks - 1:
                recs.append(self._final_row(rho_p, rho_m, pos, spin, hist,
                                            gen))
        B = rho_p.shape[0]
        stack = lambda xs: (torch.stack(xs, dim=1) if xs else
                            torch.zeros((B, 0, L), device=self.device))
        records = dict(recs=torch.cat(recs, dim=1), snaps=stack(snaps),
                       m_snaps=stack(m_snaps))
        return records, dict(rho_p=rho_p, rho_m=rho_m, pos=pos, spin=spin,
                             hist=hist, seeds=seeds, gen=gen)

    def finish(self, records: dict, carry: dict) -> PDESolveResult:
        """The result of the whole grid from its stitched records (rows of
        iterations 0…nsteps) and the last carry."""
        config = self.config
        kmax, dt = config.kmax, config.dt
        recs = records["recs"]
        snapshots = records["snaps"]
        B, n_snap = snapshots.shape[0], snapshots.shape[1]
        snap_times = (torch.arange(n_snap, dtype=torch.float32,
                                   device=self.device)
                      * (config.snapshot_interval * dt)).expand(B, n_snap)
        col = lambda j: recs[:, :, j].contiguous()
        fft_ri = torch.stack([recs[:, :, 4:4 + kmax],
                              recs[:, :, 4 + kmax:4 + 2 * kmax]], -1)
        records_ = PDERecord(m_mean=col(0), var=col(1), fft_ri=fft_ri,
                             v_eff=col(2), D_eff=col(3))
        if config.record_every > 1:
            e = config.record_every
            records_ = PDERecord(*(getattr(records_, f)[:, ::e] for f in
                                   ("m_mean", "var", "fft_ri", "v_eff",
                                    "D_eff")))
        return PDESolveResult(rho_p=carry["rho_p"], rho_m=carry["rho_m"],
                              records=records_, snapshots=snapshots,
                              m_snapshots=records["m_snaps"],
                              snap_times=snap_times)


def pde_solve_fused(config: PDEConfig, params_b: PDEParams,
                    rho_p0: torch.Tensor, rho_m0: torch.Tensor,
                    tracers0: TracerState, generator: torch.Generator,
                    keep_snapshots: bool = True, mesh=None) -> PDESolveResult:
    """Batched fused solve on the device of ``rho_p0``: one
    ``PDERun.run_range`` over every snapshot block.

    ``generator`` (on that device) seeds the kernel's Philox streams and
    supplies the plain version's draws and the final iteration's.
    ``mesh=`` splits the batch over a sweep mesh: each block launches B2
    on its rows with their global index (``parallel.mesh.ShardedRun``)."""
    from hydrolim_tpu_torch.parallel.mesh import shard_run

    run = PDERun(config, params_b, device=rho_p0.device,
                 keep_snapshots=keep_snapshots)
    carry = run.start(rho_p0, rho_m0, tracers0, generator)
    records, carry = shard_run(mesh, run, params_b).run_range(
        carry, 0, run.n_blocks)
    return run.finish(records, carry)


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
