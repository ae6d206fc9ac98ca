"""``ParticleSystem`` — the user-facing particle facade with the reference's
API surface.

Constructor keywords and defaults are the JAX package's
(``hydrolim_tpu/particles/system.py``, after PARTICLE_solver_CLASS.py:14-40)
plus ``device``; ``run(T, obs_dt, record_fft, record_var, engine)`` returns
the same ``out`` dict (:542-557).  Three engines are ported:

- ``engine='particle'`` (the default) for every configuration through
  ``particles.run.run_particles``: the general τ-leap step (exclusion,
  local m, anchors with bind / unbind / exit, crowding, a custom flip
  rate; the out dict carries the exit log), and on the mean-field
  configuration kernel B1 where it is in scope (periodic,
  ``init='fixed'``), the torch fast path elsewhere;
- ``engine='pallas'`` for the fused exclusion class through
  ``sweeps.fast_exclusion.run_exclusion_sweep`` (kernel B3/B4);
- ``engine='lattice_gas'`` for any exclusion configuration without
  anchors through the plain-torch slot engine
  (``particles.lattice_gas_k.run_lattice_gas_k``).

The two slot routes tag every particle, so ``pos_list``/``pos_frames``
carry identities.  ``run_checkpointed`` runs ``'particle'`` or
``'lattice_gas'`` in chunks, resumable (``utils/checkpoint.py``).  The
figure methods (``visualize_all``, ``plot_individuals``,
``animate_profiles``, ``show_realtime``) draw through ``viz/`` on the host,
and skip the figures where matplotlib is not installed.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import (
    ParticleConfig,
    auto_dt,
    make_particle_params,
)
from hydrolim_tpu_torch.particles.init import eval_profile, init_particles
from hydrolim_tpu_torch.particles.lattice_gas import tracer_valid_mask
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu_torch.particles.run import (
    ParticleRunResult,
    run_particles,
    substeps_for,
)
from hydrolim_tpu_torch.particles.stepper import ParticleState
from hydrolim_tpu_torch.sweeps.ensemble import exit_log_lists
from hydrolim_tpu_torch.sweeps.fast_exclusion import (
    is_fused_exclusion_path,
    run_exclusion_sweep,
)
from hydrolim_tpu_torch.utils.checkpoint import (
    run_lattice_gas_k_checkpointed,
    run_particles_checkpointed,
)


def _wrap_flip_rate_fn(fn: Optional[Callable]) -> Optional[Callable]:
    """Adapt the reference's 2-arg ``flip_rate_fn(sigma, m)`` (beta closed
    over, PARTICLE_solver_CLASS.py:59-62) to the ``(sigma, m, beta)``
    signature."""
    if fn is None:
        return None
    try:
        n_args = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_args = 3
    if n_args >= 3:
        return fn
    return lambda sigma, m, beta: fn(sigma, m)


def _seed_from_rng(rng) -> int:
    if rng is None:
        return int(np.random.SeedSequence().entropy % (2 ** 63))
    if isinstance(rng, (int, np.integer)):
        return int(rng)
    if isinstance(rng, np.random.Generator):
        return int(rng.integers(0, 2 ** 63 - 1))
    raise TypeError(f"unsupported rng {type(rng)}")


class ParticleSystem:
    def __init__(
        self,
        L: int,
        xlim: float,
        rate_diffusion: float,
        rate_active: float,
        beta: float,
        flip_rate_fn: Optional[Callable] = None,
        init: str = "fixed",
        N: int = 1000,
        rho0_plus: Optional[Callable] = None,
        rho0_minus: Optional[Callable] = None,
        rng=None,
        scale_rates: bool = True,
        local_kernel_sigma: float = 0.005,
        periodic: bool = False,
        minus_anchor: bool = True,
        immobilize_when_anchored: bool = True,
        anchor_positions: Optional[list] = None,
        anchor_radius: float = 0.005,
        site_capacity: Optional[int] = 1,
        crowding_suppresses_rates: bool = False,
        k_on: float = 0.1,
        k_off: float = 0.01,
        suppress_flip_when_bound: bool = True,
        k_exit: float = 0,
        # --- extensions of the JAX package ---
        active_model: str = "plus_forward",
        dt: Optional[float] = None,
        max_event_prob: float = 0.10,
        n_pad: Optional[int] = None,
        exit_buffer: Optional[int] = None,
        record_pos: bool = True,
        # --- the port's ---
        device: str = "cuda",
    ):
        if exit_buffer is None:
            # a particle exits at most once, so N slots always suffice
            exit_buffer = N if k_exit and anchor_positions else 8
        if init == "poisson" and n_pad is None and rho0_plus is not None:
            # The Poisson profiles, not N, determine the realized count:
            # size the buffer from the total intensity with 6-sigma
            # headroom (capped at the K·L capacity when exclusion
            # truncates), so profiles whose mass exceeds N are realized in
            # full instead of binomially thinned to n_buf(N).
            lam_tot = float(np.sum(eval_profile(rho0_plus, L))
                            + np.sum(eval_profile(rho0_minus, L)))
            need = int(np.ceil(lam_tot + 6.0 * np.sqrt(max(lam_tot, 1.0))))
            if site_capacity is not None:
                need = min(need, L * int(site_capacity))
            default_buf = -(-max(int(np.ceil(N * 1.25)), 8) // 8) * 8
            if need > default_buf:
                n_pad = -(-need // 8) * 8
                if k_exit and anchor_positions:
                    exit_buffer = max(exit_buffer, n_pad)
        self.config = ParticleConfig(
            L=L, xlim=xlim, init=init, N=N, scale_rates=scale_rates,
            local_kernel_sigma=local_kernel_sigma, periodic=periodic,
            minus_anchor=minus_anchor,
            immobilize_when_anchored=immobilize_when_anchored,
            anchor_positions=tuple(anchor_positions) if anchor_positions
            else None,
            anchor_radius=anchor_radius, site_capacity=site_capacity,
            crowding_suppresses_rates=crowding_suppresses_rates,
            suppress_flip_when_bound=suppress_flip_when_bound,
            active_model=active_model,
            dt=dt, max_event_prob=max_event_prob, n_pad=n_pad,
            exit_buffer=exit_buffer,
            flip_rate_fn=_wrap_flip_rate_fn(flip_rate_fn),
        )
        self.device = torch.device(device)
        self.params = make_particle_params(
            self.config, beta=beta, rate_diffusion=rate_diffusion,
            rate_active=rate_active, k_on=k_on, k_off=k_off, k_exit=k_exit,
            device=self.device)
        self.beta = float(beta)
        self.record_pos = record_pos
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(_seed_from_rng(rng))
        if init == "poisson":
            assert rho0_plus is not None and rho0_minus is not None
            self.rho0_plus = eval_profile(rho0_plus, L)
            self.rho0_minus = eval_profile(rho0_minus, L)
        else:
            self.rho0_plus = self.rho0_minus = None
        self._dt = dt if dt is not None else auto_dt(self.config, self.params)
        self.last_run_info: Dict[str, Any] = {}

    # -- reference-compatible attributes ------------------------------------
    @property
    def L(self):
        return self.config.L

    @property
    def dx(self):
        return self.config.dx

    @property
    def xlim(self):
        return self.config.xlim

    @property
    def K(self):
        return self.config.site_capacity

    @property
    def rate_diffusion(self):
        return float(self.params.rate_diffusion)

    @property
    def rate_active(self):
        return float(self.params.rate_active)

    @property
    def dt(self):
        return self._dt

    # -----------------------------------------------------------------------
    def _next_seed(self) -> int:
        """A fresh run seed from the system's generator (the JAX facade
        splits its key per run)."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                 device=self.device))

    def init_particles(self) -> ParticleState:
        """One replica's initial state, (1, n_buf) tensors."""
        st = init_particles(self.config, self.generator, self.rho0_plus,
                            self.rho0_minus, B=1, device=self.device)
        return ParticleState(pos=st.pos, sigma=st.sigma,
                             wind=torch.zeros_like(st.pos), alive=st.alive)

    def run_raw(self, T: float = 10.0, obs_dt: float = 0.01,
                state0: Optional[ParticleState] = None,
                record_fft: bool = True) -> ParticleRunResult:
        """Device-side run returning the raw frames (leaves (1, M, ...))."""
        if state0 is None:
            state0 = self.init_particles()
        res = run_particles(self.config, self.params, state0, T=T,
                            obs_dt=obs_dt, dt=self._dt,
                            record_pos=self.record_pos,
                            record_fft=record_fft, seed=self._next_seed())
        self.last_run_info = {"engine": res.engine}
        return res

    def run(self, T: float = 10.0, obs_dt: float = 0.01,
            record_fft: bool = False, record_var: bool = False,
            engine: str = "particle") -> Dict[str, Any]:
        """Reference-schema output dict (PARTICLE_solver_CLASS.py:542-557),
        with the JAX package's extensions ``pos_frames``/``alive_frames``/
        ``bound_frames``, ``exit_init_bin`` and ``dt_eff``.

        ``engine='particle'``: any configuration through ``run_particles``
        (``last_run_info['engine']`` names the route: the τ-leap step, or
        on the mean-field configuration kernel B1 or the torch fast path),
        with the exit log of the run's final state.  ``engine='pallas'``:
        the fused exclusion class on kernel B3/B4; ``engine='lattice_gas'``:
        any exclusion configuration without anchors on the slot engine;
        both with every particle tagged.  ``var_list`` holds the true variances
        whenever ``record_var`` is set (the JAX package's deviation from a
        reference quirk)."""
        if engine in ("pallas", "lattice_gas"):
            return self._run_slots(T, obs_dt, record_fft, record_var, engine)
        if engine != "particle":
            raise ValueError(f"unknown engine {engine!r}")
        res = self.run_raw(T=T, obs_dt=obs_dt, record_fft=record_fft)
        return self._frames_to_out(res, T, obs_dt, record_fft, record_var)

    def run_checkpointed(self, T: float = 10.0, obs_dt: float = 0.01,
                         *, ckpt_dir, chunk_frames: int = 64,
                         record_fft: bool = False, record_var: bool = False,
                         resume: bool = True,
                         engine: str = "particle") -> Dict[str, Any]:
        """Preemption-safe ``run``: the frames run in chunks of
        ``chunk_frames`` with an atomic checkpoint (frames and the carry:
        state, B1's seeds, the generator's state) after each, through
        ``utils.checkpoint.run_particles_checkpointed`` on every route of
        ``engine='particle'``.  A killed run resumes from the newest
        complete chunk when called again on a system made with the same
        ``rng`` (the initial state and the run's seed are drawn as ``run``
        draws them), and the out dict is bit-identical to ``run``'s.
        ``engine='lattice_gas'`` checkpoints the slot engine instead
        (``run_lattice_gas_k_checkpointed``), as the JAX facade does."""
        if engine == "lattice_gas":
            return self._run_slots(T, obs_dt, record_fft, record_var, engine,
                                   ckpt=dict(ckpt_dir=ckpt_dir,
                                             chunk_frames=chunk_frames,
                                             resume=resume))
        assert engine == "particle", engine
        state0 = self.init_particles()
        res = run_particles_checkpointed(
            self.config, self.params, state0, T=T, obs_dt=obs_dt,
            dt=self._dt, ckpt_dir=ckpt_dir, chunk_frames=chunk_frames,
            record_pos=self.record_pos, record_fft=record_fft,
            resume=resume, seed=self._next_seed())
        self.last_run_info = {"engine": res.engine}
        return self._frames_to_out(res, T, obs_dt, record_fft, record_var)

    def _frames_to_out(self, res: ParticleRunResult, T: float,
                       obs_dt: float, record_fft: bool,
                       record_var: bool) -> Dict[str, Any]:
        f = type(res.frames)(*(a[0].detach().cpu().numpy()
                               for a in res.frames))
        L = self.config.L
        times_obs = np.arange(0.0, T, obs_dt)
        pos_list, bound_list = [], []
        if self.record_pos:
            for k in range(len(times_obs)):
                a = f.alive[k]
                pos_list.append((f.pos[k][a] % L).astype(np.int64))
                bound_list.append(f.bound[k][a])
        ri = f.rho_hat_ri
        return {
            "times_obs": times_obs,
            "pos_list": pos_list,
            "rho_p_list": np.asarray(f.rho_p, dtype=float),
            "rho_m_list": np.asarray(f.rho_m, dtype=float),
            "total_list": np.asarray(f.total, dtype=float),
            "particle_count_list": [int(c) for c in f.particle_count],
            "bound_list": bound_list,
            "m_local_list": np.asarray(f.m_local, dtype=float),
            "m_global": np.asarray(f.m_global, dtype=float),
            "rho_hat_complex": ((ri[..., 0] + 1j * ri[..., 1]).astype(
                np.complex64) if record_fft else None),
            "fft_amp_list": (np.asarray(f.fft_amp, dtype=float)
                             if record_fft else None),
            "var_list": np.asarray(f.var, dtype=float) if record_var
            else None,
            # the τ-leap step's log; the mean-field routes have none
            **exit_log_lists(res.final_state, 0, self.config.n_exit_buf),
            "pos_frames": f.pos if self.record_pos else None,
            "alive_frames": f.alive if self.record_pos else None,
            "bound_frames": f.bound if self.record_pos else None,
            "dt_eff": obs_dt / substeps_for(obs_dt, self._dt),
        }

    def _run_slots(self, T: float, obs_dt: float, record_fft: bool,
                   record_var: bool, engine: str,
                   ckpt: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Single run on a slot route, the JAX facade's
        ``_run_lattice_gas``: kernel B3/B4 (``'pallas'``) or the slot
        engine (``'lattice_gas'``, its ``kernel='xla'``; checkpointed with
        the keywords ``ckpt``).  Every particle is a tagged tracer, so
        ``pos_list``/``pos_frames`` carry exact identities."""
        config = self.config
        if engine == "pallas" and not (config.exclusion
                                       and is_fused_exclusion_path(config)):
            raise ValueError(
                "engine='pallas' requires the fused-kernel configuration "
                "class (exclusion with K<=8, no anchors/crowding, default "
                "flip rate)")
        if not config.exclusion or config.anchor_positions is not None:
            raise ValueError(
                "engine='lattice_gas' supports exclusion configs without "
                "anchors/binding")
        # Poisson inits realize a count that follows the profiles: tag the
        # whole buffer; surplus tags are TRACER_INVALID and masked below
        n_tags = config.n_buf if config.init == "poisson" else config.N
        one = lambda v: v.reshape(1)
        params_b = type(self.params)(*(one(getattr(self.params, k))
                                       for k in ("beta", "rate_diffusion",
                                                 "rate_active", "k_on",
                                                 "k_off", "k_exit")))
        if ckpt is not None:
            assert engine == "lattice_gas", (
                "checkpointing uses the XLA slot engine")
            runner = functools.partial(run_lattice_gas_k_checkpointed,
                                       **ckpt)
        else:
            runner = (run_exclusion_sweep if engine == "pallas"
                      else run_lattice_gas_k)
        frames, _ = runner(
            config, params_b, T=T, obs_dt=obs_dt, dt=self._dt,
            seed=self._next_seed(), device=self.device,
            rho0_plus=self.rho0_plus, rho0_minus=self.rho0_minus,
            record_fft=False, n_tracers=n_tags)
        self.last_run_info = {"engine": "exclusion_multi_step"
                              if engine == "pallas" else "lgk_step"}
        g = lambda a: a[0].detach().cpu().numpy()
        times_obs = np.arange(0.0, T, obs_dt)
        M = len(times_obs)
        pos_u = g(frames.tracer_pos)                 # (M, n_tags) unwrapped
        alive = tracer_valid_mask(pos_u)
        n_real = int(alive[0].sum()) if M else 0
        pos_list = [(pos_u[k][alive[k]] % config.L).astype(np.int64)
                    for k in range(M)]
        zeros = np.zeros((M, n_tags), bool)
        total = g(frames.total)
        if record_fft:
            rho_hat = np.fft.fft(total, axis=-1)
            fft_amp = np.abs(rho_hat)
        else:
            rho_hat = fft_amp = None
        return {
            "times_obs": times_obs,
            "pos_list": pos_list,
            "rho_p_list": g(frames.rho_p).astype(float),
            "rho_m_list": g(frames.rho_m).astype(float),
            "total_list": total.astype(float),
            "particle_count_list": [n_real] * M,
            "bound_list": [zeros[k][alive[k]] for k in range(M)],
            "m_local_list": g(frames.m_local).astype(float),
            "m_global": g(frames.m_global).astype(float),
            "rho_hat_complex": rho_hat,
            "fft_amp_list": fft_amp,
            "var_list": g(frames.var).astype(float) if record_var else None,
            "exit_times": [],
            "exit_positions": [],
            "exit_init_bin": [],
            "pos_frames": pos_u,
            "alive_frames": alive,
            "bound_frames": zeros,
            "dt_eff": obs_dt / substeps_for(obs_dt, self._dt),
        }

    # -- visualization (PARTICLE_solver_CLASS.py:561-1093) ------------------
    def visualize_all(self, out, **kw):
        from hydrolim_tpu_torch.viz.particle_plots import visualize_all
        return visualize_all(self, out, **kw)

    def plot_individuals(self, out, **kw):
        from hydrolim_tpu_torch.viz.particle_plots import plot_individuals
        return plot_individuals(self, out, **kw)

    def animate_profiles(self, out, **kw):
        from hydrolim_tpu_torch.viz.particle_plots import animate_profiles
        return animate_profiles(self, out, **kw)

    def show_realtime(self, out, **kw):
        """Interactive looping playback of the profile series — the
        reference's vispy realtime canvas (PARTICLE_solver_CLASS.py:980-
        1093); see viz/realtime.py for the backend ladder."""
        from hydrolim_tpu_torch.viz.realtime import show_profiles
        kw.setdefault("xlim", self.config.xlim)
        return show_profiles(out, **kw)

    @staticmethod
    def empirical_densities_from_particles(pos, sigma, L, dx, total_norm=None):
        """Static-method parity shim (PARTICLE_solver_CLASS.py:197-214)."""
        pos = np.asarray(pos)
        sigma = np.asarray(sigma)
        counts_p = np.bincount(pos[sigma == 1], minlength=L)
        counts_m = np.bincount(pos[sigma == -1], minlength=L)
        denom = (float(max(1, pos.size)) if total_norm is None
                 else float(total_norm)) * dx
        return counts_p / denom, counts_m / denom
