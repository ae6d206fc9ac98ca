"""Replica/parameter ensembles of the particle engine.

The (β-grid × replicas) batch is one (B, n_buf) state: β enters only
through the flip rate, so it batches as the leading axis of
``ParticleParams``; replicas differ only by their draws.
``run_particle_ensemble`` initialises (``ensemble_states``) and runs the
batch through ``particles.run.run_particles`` (kernel B1 inside its scope,
the τ-leap step outside the mean-field configuration), and
``frames_to_out`` slices
one replica into the reference's ``out`` dict, with its exit log.
``chunk_seed`` gives each replica chunk of a sweep its own seed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import (
    ParticleConfig,
    ParticleParams,
    auto_dt,
    make_particle_params,
)
from hydrolim_tpu_torch.particles.init import init_particles
from hydrolim_tpu_torch.particles.run import (
    TAU_LEAP_ROUTE,
    ParticleRunResult,
    particle_route,
    run_particles,
)
from hydrolim_tpu_torch.particles.stepper import ParticleState, with_exit_log


def chunk_seed(seed: int, c0: int) -> int:
    """The seed of the replica chunk starting at ``c0``: a pure function of
    (seed, c0), so a chunk's draws do not depend on the chunks before it."""
    return int(np.random.SeedSequence([seed, c0]).generate_state(1)[0])


def broadcast_params(config: ParticleConfig, *, beta, rate_diffusion,
                     rate_active, k_on=0.0, k_off=0.0, k_exit=0.0,
                     n_runs: int = 1, device="cuda") -> ParticleParams:
    """Params with leading axis (n_beta·n_runs,): β varies across the grid
    (each value repeated ``n_runs`` times), the other rates broadcast."""
    beta = np.atleast_1d(np.asarray(beta, dtype=np.float32))
    flat = np.repeat(beta, n_runs)
    B = flat.shape[0]
    ref = make_particle_params(
        config, beta=0.0, rate_diffusion=rate_diffusion,
        rate_active=rate_active, k_on=k_on, k_off=k_off, k_exit=k_exit,
        device=device)
    return ParticleParams(
        beta=torch.tensor(flat, dtype=torch.float32, device=device),
        rate_diffusion=ref.rate_diffusion.expand(B).clone(),
        rate_active=ref.rate_active.expand(B).clone(),
        k_on=ref.k_on.expand(B).clone(),
        k_off=ref.k_off.expand(B).clone(),
        k_exit=ref.k_exit.expand(B).clone(),
    )


def ensemble_dt(config: ParticleConfig, *, beta_max: float, rate_diffusion,
                rate_active, k_on=0.0, k_off=0.0, k_exit=0.0) -> float:
    """Static Δt for a sweep: bound the per-particle rate at the largest β."""
    p = make_particle_params(config, beta=beta_max,
                             rate_diffusion=rate_diffusion,
                             rate_active=rate_active, k_on=k_on, k_off=k_off,
                             k_exit=k_exit, device="cpu")
    return auto_dt(config, p, beta_max=beta_max)


def ensemble_states(config: ParticleConfig, B: int, seed: int, *,
                    rho0_plus: Optional[np.ndarray] = None,
                    rho0_minus: Optional[np.ndarray] = None,
                    engine: str = "auto", device="cuda") -> ParticleState:
    """The B replicas' initial state, drawn from a generator seeded with
    ``seed`` (``rho0_plus/minus`` as in ``run_particle_ensemble``); outside
    the mean-field configuration the τ-leap step's (birth sites, an empty
    exit log)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    st = init_particles(config, gen, rho0_plus, rho0_minus, B=B,
                        device=device)
    state0 = ParticleState(pos=st.pos, sigma=st.sigma,
                           wind=torch.zeros_like(st.pos), alive=st.alive)
    if particle_route(config, engine) == TAU_LEAP_ROUTE:
        state0 = with_exit_log(config, state0)
    return state0


def run_particle_ensemble(config: ParticleConfig, params_b: ParticleParams,
                          seed: int = 0, *, T: float, obs_dt: float,
                          dt: float, rho0_plus: Optional[np.ndarray] = None,
                          rho0_minus: Optional[np.ndarray] = None,
                          record_pos: bool = True, record_fft: bool = True,
                          engine: str = "auto", device="cuda", mesh=None
                          ) -> ParticleRunResult:
    """Initialise and run B = len(params_b.beta) replicas on ``device``.
    ``rho0_plus/minus`` are (L,) profiles shared by the batch or (B, L)
    rows per replica (the (N, β) double sweep: N varies only through the
    Poisson intensities).  The initial state is drawn from a generator
    seeded with ``seed`` (``ensemble_states``); the run's draws from one
    seeded with ``seed + 1`` (``utils.checkpoint.
    run_particle_ensemble_checkpointed`` runs the same in chunks).
    Returns a ``ParticleRunResult`` with leaves (B, M, ...).  ``mesh=``
    splits the run's batch over a sweep mesh (``run_particles``)."""
    state0 = ensemble_states(config, params_b.beta.shape[0], seed,
                             rho0_plus=rho0_plus, rho0_minus=rho0_minus,
                             engine=engine, device=device)
    return run_particles(config, params_b, state0, T=T, obs_dt=obs_dt,
                         dt=dt, record_pos=record_pos, record_fft=record_fft,
                         seed=seed + 1, engine=engine, mesh=mesh)


def frames_to_out(frames, rep_idx: int, config: ParticleConfig, T: float,
                  obs_dt: float, record_pos: bool = True,
                  final_state=None) -> Dict:
    """Slice one replica out of a batched ``ParticleRunResult.frames`` into
    the reference-schema ``out`` dict (numpy, on the host), with the JAX
    package's keys and value types.  Passing the batched ``final_state``
    adds the exit-event log (exit_times/exit_positions/exit_init_bin,
    PARTICLE_solver_CLASS.py:555-556): the τ-leap step's, empty on the
    mean-field routes, which have no exit channel."""
    g = lambda a: a[rep_idx].detach().cpu().numpy()
    f = frames
    L = config.L
    ri = g(f.rho_hat_ri)
    out = {
        "times_obs": np.arange(0.0, T, obs_dt),
        "rho_p_list": g(f.rho_p),
        "rho_m_list": g(f.rho_m),
        "total_list": g(f.total),
        "m_local_list": g(f.m_local),
        "m_global": g(f.m_global),
        "particle_count_list": list(g(f.particle_count)),
        "rho_hat_complex": ((ri[..., 0] + 1j * ri[..., 1]).astype(
            np.complex64) if ri.shape[-2] > 0 else None),
        "fft_amp_list": g(f.fft_amp) if f.fft_amp.shape[-1] > 0 else None,
        "var_list": g(f.var),
    }
    if record_pos and f.pos.shape[-1] > 0:
        pos, alive, bound = g(f.pos), g(f.alive), g(f.bound)
        out["pos_frames"] = pos
        out["alive_frames"] = alive
        out["bound_frames"] = bound
        out["pos_list"] = [(pos[k][alive[k]] % L).astype(np.int64)
                           for k in range(pos.shape[0])]
        out["bound_list"] = [bound[k][alive[k]] for k in range(pos.shape[0])]
    else:
        out["pos_frames"] = None
        out["alive_frames"] = None
        out["pos_list"] = None
    log = exit_log_lists(final_state, rep_idx, config.n_exit_buf)
    if final_state is None:
        del log["exit_init_bin"]
    out.update(log)
    return out


def exit_log_lists(final_state: Optional[ParticleState], rep_idx: int,
                   n_exit_buf: int) -> Dict[str, list]:
    """Replica ``rep_idx``'s exit log as the reference's lists
    (exit_times, exit_positions, exit_init_bin): the first min(count, E)
    entries of the τ-leap state's log, empty without one."""
    out = {"exit_times": [], "exit_positions": [], "exit_init_bin": []}
    if final_state is None or final_state.exit_count is None:
        return out
    ec = min(int(final_state.exit_count[rep_idx]), n_exit_buf)
    for key, log in (("exit_times", final_state.exit_times),
                     ("exit_positions", final_state.exit_pos),
                     ("exit_init_bin", final_state.exit_init_bin)):
        out[key] = list(log[rep_idx, :ec].cpu().numpy())
    return out
