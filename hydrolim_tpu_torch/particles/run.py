"""Observation-frame run loop of the particle engine.

The port of the JAX package's ``particles/run.py``: the frame grid
``times_obs = arange(0, T, obs_dt)``, a fixed number of Δt sub-steps
between frames, so every frame holds the state at the first step time ≥
its frame time, and the per-frame observable stack recorded on the device.
The state is batched, (B, n_buf) per replica.

Which engine runs the steps follows the configuration only:

- a mean-field configuration inside kernel B1's scope (periodic,
  ``init='fixed'``, so every replica's first N buffer entries are alive and
  the rest dead) runs on B1 over the alive prefix, one
  ``meanfield_multi_step`` call per frame (on CPU tensors its plain
  version);
- a mean-field configuration outside it (walls, Poisson init) runs the
  torch fast path, ``particles.stepper._step_meanfield_global`` per step;
- anything else (exclusion, local m, anchors, a custom flip rate) runs the
  general τ-leap step, ``particles.stepper.step``, in plain torch (some
  hundred small launches a step on the card); its final state carries the
  exit log.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.fields.magnetization import local_m_field
from hydrolim_tpu_torch.ops.segment import masked_bincount
from hydrolim_tpu_torch.ops.stepper_kernel import meanfield_multi_step
from hydrolim_tpu_torch.particles.stepper import (
    ParticleState,
    _is_meanfield_fast_path,
    _step_meanfield_global,
    build_static_arrays,
    step,
    with_exit_log,
)

# the routes of ``run_particles`` (``ParticleRunResult.engine``)
B1_ROUTE = "meanfield_multi_step"
TORCH_ROUTE = "torch"
TAU_LEAP_ROUTE = "tau_leap"


class ParticleFrames(NamedTuple):
    """Per-frame observable stack, leaves (B, M, ...): the reference's
    ``out`` schema (PARTICLE_solver_CLASS.py:542-557) in array form."""

    rho_p: torch.Tensor            # (B, M, L)
    rho_m: torch.Tensor            # (B, M, L)
    total: torch.Tensor            # (B, M, L)
    m_local: torch.Tensor          # (B, M, L)
    m_global: torch.Tensor         # (B, M)
    particle_count: torch.Tensor   # (B, M) int32
    rho_hat_ri: torch.Tensor       # (B, M, L, 2) re/im of the density DFT
    fft_amp: torch.Tensor          # (B, M, L)
    var: torch.Tensor              # (B, M)
    pos: torch.Tensor              # (B, M, n_buf) int32 unwrapped
    alive: torch.Tensor            # (B, M, n_buf) bool
    bound: torch.Tensor            # (B, M, n_buf) bool


class ParticleRunResult(NamedTuple):
    frames: ParticleFrames
    final_state: ParticleState
    engine: str                    # B1_ROUTE, TORCH_ROUTE or TAU_LEAP_ROUTE


def _record_frame(config: ParticleConfig, mfield_op, state: ParticleState,
                  record_pos: bool, record_fft: bool = True
                  ) -> ParticleFrames:
    """One frame's observables of a (B, n_buf) state (leaves (B, ...)).
    The spectrum is taken by ``torch.fft`` in float64 and rounded to
    float32 (the JAX package uses a float32 matmul DFT), and so is the
    lattice variance."""
    L = config.L
    pos, sigma, alive = state.pos, state.sigma, state.alive
    a = alive.to(torch.float32)
    counts_p = masked_bincount(pos, a * (sigma > 0), L)
    counts_m = masked_bincount(pos, a * (sigma < 0), L)
    n_alive = a.sum(-1)
    denom = (n_alive.clamp(min=1.0) * config.dx)[:, None]
    rho_p = counts_p / denom
    rho_m = counts_m / denom
    total = rho_p + rho_m
    m_local = local_m_field(counts_p, counts_m, mfield_op,
                            sigma=config.local_kernel_sigma,
                            sigma_grid=config.sigma_grid,
                            periodic=config.periodic)
    s_sum = torch.where(alive, sigma, 0).sum(-1).to(torch.float32)
    m_global = s_sum / n_alive.clamp(min=1.0)
    B = pos.shape[0]
    if record_fft:
        spec = torch.fft.fft(total.to(torch.float64))
        rho_hat = torch.stack([spec.real, spec.imag], -1).to(torch.float32)
        amp = spec.abs().to(torch.float32)
    else:
        rho_hat = total.new_zeros((B, 0, 2))
        amp = total.new_zeros((B, 0))
    var = total.to(torch.float64).var(-1, unbiased=False).to(torch.float32)
    if record_pos:
        pos_u = pos + state.wind * L
        live = alive
        bound = (state.bound if state.bound is not None
                 else torch.zeros_like(alive))
    else:
        pos_u = pos.new_zeros((B, 0))
        live = bound = alive.new_zeros((B, 0))
    return ParticleFrames(
        rho_p=rho_p, rho_m=rho_m, total=total, m_local=m_local,
        m_global=m_global, particle_count=alive.sum(-1, dtype=torch.int32),
        rho_hat_ri=rho_hat, fft_amp=amp, var=var, pos=pos_u, alive=live,
        bound=bound)


def substeps_for(obs_dt: float, dt_target: float) -> int:
    """Δt sub-steps per observation frame, with a sanity bound against a
    garbage dt (e.g. an absurd β underflowing the rate bound)."""
    assert math.isfinite(dt_target) and dt_target > 0.0, (
        f"dt must be positive and finite, got {dt_target!r}")
    n = max(1, int(math.ceil(obs_dt / dt_target - 1e-9)))
    assert n <= 100_000_000, (
        f"{n} sub-steps per obs_dt frame (obs_dt={obs_dt!r}, "
        f"dt={dt_target!r}) — dt is implausibly small; check the rate/beta "
        "configuration passed to ensemble_dt")
    return n


def in_b1_scope(config: ParticleConfig) -> bool:
    """Kernel B1's scope: the mean-field configuration on a periodic
    lattice with the 'fixed' init (the alive entries are the first N)."""
    return (_is_meanfield_fast_path(config) and config.periodic
            and config.init == "fixed")


def particle_route(config: ParticleConfig, engine: str = "auto") -> str:
    """The engine ``run_particles`` takes for ``config``: the τ-leap step
    outside the mean-field configuration; inside it B1 where it is in
    scope, else the torch fast path.  ``engine='xla'`` (the JAX package's
    name of its XLA path) forces the torch fast path on a mean-field
    configuration."""
    if engine not in ("auto", "xla"):
        raise ValueError(f"unknown particle engine {engine!r}")
    if not _is_meanfield_fast_path(config):
        return TAU_LEAP_ROUTE
    return B1_ROUTE if engine == "auto" and in_b1_scope(config) \
        else TORCH_ROUTE


def step_times(frame: int, n_sub: int, obs_dt: float, dt_eff: float):
    """The start times of frame ``frame``'s sub-steps in float32, as the
    JAX run computes them: t0 = (frame − 1)·obs_dt, then t0 + k·Δt rounded
    once (XLA contracts it into a fused multiply-add; the float32 product
    is exact in float64, so the sum is formed there and rounded once)."""
    f32 = np.float32
    t0 = f32((f32(frame) - f32(1.0)) * f32(obs_dt))
    dt32 = float(f32(dt_eff))
    return [float(f32(float(t0) + float(f32(k)) * dt32))
            for k in range(n_sub)]


def _batched(v, B: int, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=device).reshape(-1).expand(B)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState))


class ParticleRun:
    """The fixed parts of one run of a (B, n_buf) batch: the route, the
    frame grid (``n_frames`` frames of ``n_sub`` sub-steps of ``dt_eff``)
    and the frame recorder.  ``start`` makes the carry of frame 0 (the
    state, B1's Philox seeds, the ``torch.Generator``); ``run_range``
    records frames [lo, hi) and returns the carry after frame hi − 1.
    Every draw and every counter is a function of the global frame and
    step index, so a run split into ranges is the run in one piece, bit
    for bit, given the carry (``utils.checkpoint`` saves it between
    ranges).

    The carry is a dict: the state's fields by name (None where the state
    has none), ``seeds`` ((B,) int32 on B1's route, else None) and
    ``gen``, the generator.  ``b0`` is the global index of the batch's
    first replica, B1's Philox key (``for_rows``)."""

    def __init__(self, config: ParticleConfig, params: ParticleParams, *,
                 T: float, obs_dt: float, dt: float, record_pos: bool,
                 record_fft: bool, engine: str, device, _draws=None,
                 b0: int = 0):
        self._kw = dict(T=T, obs_dt=obs_dt, dt=dt, record_pos=record_pos,
                        record_fft=record_fft, engine=engine, _draws=_draws)
        self.config, self.params, self.b0 = config, params, b0
        self.route = particle_route(config, engine)
        self.device = torch.device(device)
        self.statics = build_static_arrays(config, self.device)
        self.record_pos, self.record_fft = record_pos, record_fft
        self.obs_dt = obs_dt
        self.n_frames = len(np.arange(0.0, T, obs_dt))
        self.n_sub = substeps_for(obs_dt, dt) if self.n_frames else 0
        self.dt_eff = obs_dt / self.n_sub if self.n_frames else 0.0
        self._draws = _draws

    def for_rows(self, params: ParticleParams, device, b0: int
                 ) -> "ParticleRun":
        """The same run over rows [b0, b0 + len(params)) of the batch on
        ``device`` (one block of ``parallel.mesh.ShardedRun``)."""
        return ParticleRun(self.config, params, **self._kw, device=device,
                           b0=b0)

    def prepare(self, state0: ParticleState) -> ParticleState:
        """``state0`` as the route carries it: on the τ-leap route with its
        exit log (``with_exit_log``), elsewhere with an alive mask."""
        if self.route == TAU_LEAP_ROUTE:
            return with_exit_log(self.config, state0)
        if state0.alive is None:
            return dataclasses.replace(
                state0, alive=torch.ones_like(state0.pos, dtype=torch.bool))
        return state0

    def record(self, state: ParticleState) -> ParticleFrames:
        return _record_frame(self.config, self.statics.mfield_op, state,
                             self.record_pos, self.record_fft)

    def start(self, state0: ParticleState, seed: int) -> dict:
        """The carry of frame 0: ``state0`` (prepared), the generator seeded
        with ``seed`` and, on B1's route, the Philox seeds drawn from it."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        seeds = None
        if self.route == B1_ROUTE:
            N = self.config.N
            if not bool(state0.alive[:, :N].all()) or \
                    bool(state0.alive[:, N:].any()):
                raise ValueError("kernel B1 runs the first N buffer "
                                 "entries: the state's alive entries must "
                                 "be exactly those (the 'fixed' init)")
            seeds = torch.randint(0, 2 ** 31 - 1, (state0.pos.shape[0],),
                                  generator=gen, device=self.device,
                                  dtype=torch.int32)
        return dict({f: getattr(state0, f) for f in STATE_FIELDS},
                    seeds=seeds, gen=gen)

    @staticmethod
    def state(carry: dict) -> ParticleState:
        return ParticleState(**{f: carry[f] for f in STATE_FIELDS})

    def run_range(self, carry: dict, lo: int, hi: int):
        """Frames [lo, hi) (leaves (B, hi − lo, ...)) and the carry after
        them; frame 0 is the carried state as it is."""
        config, params, gen = self.config, self.params, carry["gen"]
        state = self.state(carry)
        n_sub, dt_eff = self.n_sub, self.dt_eff
        frames = [self.record(state)] if lo == 0 else []
        f0 = max(lo, 1)
        if self.route == B1_ROUTE and hi > f0:
            N, B, dev = config.N, state.pos.shape[0], self.device
            scal = torch.stack([_batched(v, B, dev) for v in (
                params.beta, params.rate_diffusion, params.rate_active)],
                dim=1).contiguous()
            bidi = config.active_model == "bidirectional"
            head = [getattr(state, k)[:, :N].contiguous()
                    for k in ("pos", "sigma", "wind")]
            for f in range(f0, hi):
                head = list(meanfield_multi_step(
                    scal, carry["seeds"], *head, L=config.L, k_steps=n_sub,
                    dt=dt_eff, bidirectional=bidi, step0=(f - 1) * n_sub,
                    b0=self.b0, generator=gen))
                state = dataclasses.replace(state, **{
                    k: torch.cat([h, getattr(state, k)[:, N:]], 1)
                    for k, h in zip(("pos", "sigma", "wind"), head)})
                frames.append(self.record(state))
        elif self.route == TAU_LEAP_ROUTE:
            for f in range(f0, hi):
                for k, t in enumerate(step_times(f, n_sub, self.obs_dt,
                                                 dt_eff)):
                    inject = (None if self._draws is None
                              else self._draws.step((f - 1) * n_sub + k))
                    state = step(config, params, self.statics, state,
                                 dt_eff, t, generator=gen, _inject=inject)
                frames.append(self.record(state))
        else:
            for _ in range(f0, hi):
                for _ in range(n_sub):
                    state = _step_meanfield_global(config, params, state,
                                                   dt_eff, generator=gen)
                frames.append(self.record(state))
        stacked = ParticleFrames(*(torch.stack(leaf, dim=1)
                                   for leaf in zip(*frames)))
        return stacked, dict({f: getattr(state, f) for f in STATE_FIELDS},
                             seeds=carry["seeds"], gen=gen)


def run_particles(config: ParticleConfig, params: ParticleParams,
                  state0: ParticleState, *, T: float, obs_dt: float,
                  dt: float, record_pos: bool = True,
                  record_fft: bool = True, seed: int = 0,
                  engine: str = "auto", _draws=None,
                  mesh=None) -> ParticleRunResult:
    """Run the (B, n_buf) batch ``state0`` to time T, recording frames
    every obs_dt on its device.  ``dt`` is the sub-step target; the
    effective step is obs_dt/ceil(obs_dt/dt) ≤ dt.  Params are (B,) or
    scalar tensors.  All draws come from one ``torch.Generator`` seeded
    with ``seed`` on the state's device: B1's Philox seeds (its counter is
    ``step0 = (f − 1)·n_sub`` at frame f), the torch path's uniforms or
    the τ-leap step's draws.  ``engine``: see ``particle_route``; the
    route taken is returned.  On the τ-leap route the state gains its
    exit log (``with_exit_log``), and an exit is logged at its step's
    start time (``step_times``).  The run is one ``ParticleRun.run_range``
    over every frame (``utils.checkpoint.run_particles_checkpointed``
    runs the same ranges in chunks).  ``mesh=`` splits the batch over a
    sweep mesh (``parallel.mesh.ShardedRun``); the result is the same.

    Test-only: ``_draws.step(i)`` gives the τ-leap step's ``_inject`` of
    global step i."""
    from hydrolim_tpu_torch.parallel.mesh import shard_run

    run = ParticleRun(config, params, T=T, obs_dt=obs_dt, dt=dt,
                      record_pos=record_pos, record_fft=record_fft,
                      engine=engine, device=state0.pos.device, _draws=_draws)
    state0 = run.prepare(state0)
    if run.n_frames == 0:  # T <= 0: an empty frame stack, not a lone frame 0
        empty = ParticleFrames(*(f[:, None][:, :0]
                                 for f in run.record(state0)))
        return ParticleRunResult(empty, state0, run.route)
    carry = run.start(state0, seed)
    frames, carry = shard_run(mesh, run, params).run_range(carry, 0,
                                                           run.n_frames)
    return ParticleRunResult(frames, run.state(carry), run.route)
