"""β-sweep driver — the reference's flagship particle experiment.

Mirrors the JAX package's ``sweeps/beta_sweep.py``
(`PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py`):

- ``make_exp_gradient``, the exp-gradient ρ₀± profile factory (:16-53);
- ``sweep_over_betas`` (:828-1028): the whole (β × replicas) grid in one
  batch, the five estimators per replica on the device, means ± SE per β,
  the npz checkpoint (``run=False`` reloads it), the (θ, γ) NB fit and the
  standard figures (where matplotlib is installed);
- ``sweep_beta_ensemble`` (:56-117), one β with the reference's 14-tuple.

Routes, decided by the configuration and the engine name alone:

- ``engine='particle'`` (the default, as in the JAX package) →
  ``run_sweep_grid``: the particle engine (``particles.run``) in chunks of
  replicas — the general τ-leap step outside the mean-field configuration
  (anchors included), kernel B1 or the torch fast path inside it;
- the slot routes (``run_sweep_grid_lattice_gas``): anchors (bind /
  unbind / exit) → the anchored slot engine (``run_lattice_gas_anchored``);
  ``engine='lattice_gas'`` (``kernel='xla'``) → the XLA slot engines in
  plain torch, ``run_lattice_gas`` at K=1 and ``run_lattice_gas_k`` above;
  ``'fused'``, ``'pallas'`` and ``'auto'`` (``kernel='auto'``) → kernel
  B3/B4 where ``is_fused_exclusion_path`` holds, the slot engines
  otherwise (crowding, K > 8).

The route taken is returned with the grid and saved as the sweep's
``route``.  The host estimators, ``mesh=``/``n_devices=`` and ``ckpt_dir=``
are not ported yet: each raises ``NotImplementedError`` naming its
ROADMAP.md item (``core/scope.py``).
"""
from __future__ import annotations

from pathlib import Path
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.core.scope import not_ported
from hydrolim_tpu_torch.fit.veff_fit import fit_and_plot_v_eff
from hydrolim_tpu_torch.observables.batched import batched_estimates
from hydrolim_tpu_torch.particles.init import eval_profile
from hydrolim_tpu_torch.particles.lattice_gas import (
    LatticeGasFrames,
    run_lattice_gas,
    tracer_valid_mask,
)
from hydrolim_tpu_torch.particles.lattice_gas_k import (
    run_lattice_gas_anchored,
    run_lattice_gas_k,
)
from hydrolim_tpu_torch.particles.run import ParticleRunResult
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    chunk_seed,
    ensemble_dt,
    frames_to_out,
    run_particle_ensemble,
)
from hydrolim_tpu_torch.sweeps.fast_exclusion import (
    is_fused_exclusion_path,
    run_exclusion_sweep,
)

# the JAX package's names of the fused route
FUSED_ENGINES = ("fused", "pallas", "auto")
SWEEP_ENGINES = ("particle",) + FUSED_ENGINES + ("lattice_gas",)

# the routes of run_sweep_grid_lattice_gas
FUSED_ROUTE = "exclusion_multi_step"
K1_ROUTE = "lg_step"
SLOT_ROUTE = "lgk_step"
ANCHORED_ROUTE = "lgk_step anchored"


def check_engine(engine: str) -> None:
    """Accept the JAX package's engine names: ``'particle'``, the names of
    the fused route and ``'lattice_gas'`` (the slot engines)."""
    if engine not in SWEEP_ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


# ---------------------------------------------------------------------------
# IC factory
# ---------------------------------------------------------------------------

def _profile_lookup(profile: np.ndarray, L: int):
    """x ∈ [0, 1] → nearest-site profile value; scalar in → float out."""

    def f(x):
        idx = np.clip(np.rint(np.asarray(x) * L).astype(int), 0, L - 1)
        val = profile[idx]
        return float(val) if np.ndim(x) == 0 else val

    return f


def make_exp_gradient(L: int, N: int, frac_plus: float, decay_length: float,
                      anchor_positions=(0.25, 0.60),
                      anchor_peak_width: float = 0.01,
                      anchor_peak_mass: float = 0.03):
    """ρ₀± profile factory (PARTICLE_solver_BIOLOGY_EXCLUSION.py:16-53):
    the + species decays exponentially from x = 0 with scale
    ``decay_length``; the − species is flat (baseline 0.05) plus one
    Gaussian bump of mass weight ``anchor_peak_mass`` per anchor; each shape
    is normalised to unit mass and scaled to ``N·frac_plus`` /
    ``N·(1−frac_plus)`` particles.  Returns ``[ρ₀₊ callable, ρ₀₋ callable,
    ρ₊ array, ρ₋ array]``."""
    xs = np.arange(L) / float(L)
    plus_shape = np.exp(-xs / decay_length)
    minus_shape = np.full(L, 0.05)
    if anchor_positions is not None and len(tuple(anchor_positions)):
        centers = np.asarray(tuple(anchor_positions), float)[:, None]
        minus_shape = minus_shape + anchor_peak_mass * np.exp(
            -0.5 * ((xs[None, :] - centers) / anchor_peak_width) ** 2
        ).sum(axis=0)
    rho_plus = N * frac_plus * plus_shape / plus_shape.sum()
    rho_minus = N * (1.0 - frac_plus) * minus_shape / minus_shape.sum()
    return [_profile_lookup(rho_plus, L), _profile_lookup(rho_minus, L),
            rho_plus, rho_minus]


# ---------------------------------------------------------------------------
# kwargs → config plumbing
# ---------------------------------------------------------------------------

DEFAULT_PS_KWARGS: Dict = dict(
    L=1000, xlim=1, rate_diffusion=0.02, rate_active=5, flip_rate_fn=None,
    init="poisson", N=500, scale_rates=False, local_kernel_sigma=0.005,
    minus_anchor=True, periodic=False, immobilize_when_anchored=True,
    anchor_radius=0.003, anchor_positions=None, site_capacity=1,
    crowding_suppresses_rates=False, k_on=0, k_off=0, k_exit=0,
)  # reference sweep configuration (:837-857)

DEFAULT_RUN_KWARGS: Dict = dict(T=20, obs_dt=0.1, record_fft=True,
                                record_var=True)  # (:829-834)


def config_from_kwargs(ps_kwargs: Dict, **extra) -> ParticleConfig:
    kw = dict(ps_kwargs)
    flip_fn = kw.pop("flip_rate_fn", None)
    anchors = kw.pop("anchor_positions", None)
    # a particle exits at most once -> N slots always bound the exit log
    exit_buffer = (int(kw["N"]) if float(kw.get("k_exit", 0)) and anchors
                   else 0)
    extra.setdefault("exit_buffer", exit_buffer)
    if flip_fn is not None:
        extra.setdefault("flip_rate_fn", flip_fn)
    return ParticleConfig(
        L=int(kw["L"]), xlim=float(kw["xlim"]), init=kw.get("init", "fixed"),
        N=int(kw["N"]), scale_rates=bool(kw.get("scale_rates", True)),
        local_kernel_sigma=float(kw.get("local_kernel_sigma", 0.005)),
        periodic=bool(kw.get("periodic", False)),
        minus_anchor=bool(kw.get("minus_anchor", True)),
        immobilize_when_anchored=bool(kw.get("immobilize_when_anchored",
                                             True)),
        anchor_positions=tuple(anchors) if anchors else None,
        anchor_radius=float(kw.get("anchor_radius", 0.005)),
        site_capacity=kw.get("site_capacity", 1),
        crowding_suppresses_rates=bool(kw.get("crowding_suppresses_rates",
                                              False)),
        suppress_flip_when_bound=bool(kw.get("suppress_flip_when_bound",
                                             True)),
        active_model=kw.get("active_model", "plus_forward"),
        **extra)


def _profiles(config: ParticleConfig, init_kwargs: Optional[Dict]):
    if config.init != "poisson":
        return None, None
    assert init_kwargs is not None, "poisson init requires init_kwargs"
    return (eval_profile(init_kwargs["rho0_plus"], config.L),
            eval_profile(init_kwargs["rho0_minus"], config.L))


# ---------------------------------------------------------------------------
# the batched sweep core
# ---------------------------------------------------------------------------

def _rates(ps_kwargs: Dict) -> Dict:
    return dict(rate_diffusion=float(ps_kwargs["rate_diffusion"]),
                rate_active=float(ps_kwargs["rate_active"]),
                k_on=float(ps_kwargs.get("k_on", 0)),
                k_off=float(ps_kwargs.get("k_off", 0)),
                k_exit=float(ps_kwargs.get("k_exit", 0)))


def run_sweep_grid(beta_values, n_runs: int, ps_kwargs: Dict,
                   init_kwargs: Optional[Dict], run_kwargs: Dict,
                   seed: int = 0, chunk_size: int = 256, mesh=None,
                   n_devices: Optional[int] = None, ckpt_dir=None,
                   device="cuda"):
    """The (β × replicas) grid on the particle engine (JAX ``beta_sweep.py:
    302-396``); returns (config, ``ParticleRunResult`` with leaves (B, …)
    on ``device``, dt).  Grids larger than ``chunk_size`` replicas run in
    chunks, the chunk starting at c0 drawing from ``chunk_seed(seed, c0)``
    (its initial state and its run), so a replica's trajectory does not
    depend on the chunks before it.  ``res.engine`` names the route."""
    if mesh is not None or n_devices is not None:
        raise not_ported("mesh= / n_devices=", "parallelism")
    if ckpt_dir is not None:
        raise not_ported("ckpt_dir=", "checkpointing")
    config = config_from_kwargs(ps_kwargs)
    rho0_p, rho0_m = _profiles(config, init_kwargs)
    rates = _rates(ps_kwargs)
    beta_flat = np.repeat(np.asarray(beta_values, dtype=np.float32), n_runs)
    B = beta_flat.shape[0]
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)), **rates)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    chunks = []
    for c0 in range(0, B, chunk_size):
        params = broadcast_params(config, beta=beta_flat[c0:c0 + chunk_size],
                                  device=device, **rates)
        chunks.append(run_particle_ensemble(
            config, params, chunk_seed(seed, c0), T=T, obs_dt=obs_dt, dt=dt,
            rho0_plus=rho0_p, rho0_minus=rho0_m,
            record_pos=bool(run_kwargs.get("record_pos", True)),
            record_fft=bool(run_kwargs.get("record_fft", True)),
            device=device))
    if len(chunks) == 1:
        return config, chunks[0], dt
    cat = lambda *a: None if a[0] is None else torch.cat(a, dim=0)
    frames = type(chunks[0].frames)(*map(cat, *(c.frames for c in chunks)))
    final = type(chunks[0].final_state)(**{
        f.name: cat(*(getattr(c.final_state, f.name) for c in chunks))
        for f in dataclasses.fields(chunks[0].final_state)})
    return config, ParticleRunResult(frames, final, chunks[0].engine), dt


def _device_estimates(config: ParticleConfig, frames, times, pos, alive
                      ) -> Dict[str, np.ndarray]:
    """The five estimators of every replica on the device, as float64
    numpy arrays keyed by name."""
    est = batched_estimates(
        frames.total, frames.m_global, frames.rho_p, times, pos, alive,
        dx=config.dx, xlim=float(config.xlim),
        has_positions=pos.shape[-1] > 0)
    return {k: getattr(est, k).cpu().numpy().astype(float)
            for k in ("v_eff", "D_eff", "m_mean", "rho_eff", "p_block")}


def _stats(vals):
    """(mean, std (ddof 1), standard error) of one β's replicas."""
    a = np.asarray(vals, dtype=float)
    std = float(a.std(ddof=1)) if a.size > 1 else 0.0
    return float(a.mean()), std, std / np.sqrt(max(1, a.size))


def sweep_beta_ensemble(beta, n_runs: int = 10,
                        ps_kwargs: Optional[Dict] = None,
                        init_kwargs: Optional[Dict] = None,
                        run_kwargs: Optional[Dict] = None, rng_seeds=None,
                        seed: int = 0, estimator: str = "device", mesh=None,
                        n_devices: Optional[int] = None, device="cuda"):
    """Single-β ensemble on the particle engine with the reference's
    14-tuple return (:56-117): (v mean, std, SE, per-run v, out dicts,
    m mean, std, SE, ρ mean, SE, p_block mean, SE, D mean, SE).  The
    estimators run on the device (``estimator='device'``); the host
    estimators are not ported yet."""
    if estimator != "device":
        raise not_ported(f"estimator={estimator!r}", "host")
    ps_kwargs = dict(DEFAULT_PS_KWARGS, **(ps_kwargs or {}))
    run_kwargs = dict(DEFAULT_RUN_KWARGS, **(run_kwargs or {}))
    if rng_seeds is not None:
        seed = int(np.asarray(rng_seeds).flat[0])
    config, res, _ = run_sweep_grid(np.asarray([beta]), n_runs, ps_kwargs,
                                    init_kwargs, run_kwargs, seed=seed,
                                    mesh=mesh, n_devices=n_devices,
                                    device=device)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    f = res.frames
    est = _device_estimates(config, f, np.arange(0.0, T, obs_dt), f.pos,
                            f.alive)
    out_list = [frames_to_out(f, r, config, T, obs_dt,
                              final_state=res.final_state)
                for r in range(n_runs)]
    mean, std, se = _stats(est["v_eff"])
    m_mean, m_std, m_se = _stats(est["m_mean"])
    rho_mean, _, rho_se = _stats(est["rho_eff"])
    block_mean, _, block_se = _stats(est["p_block"])
    D_mean, _, D_se = _stats(est["D_eff"])
    return (mean, std, se, est["v_eff"], out_list, m_mean, m_std, m_se,
            rho_mean, rho_se, block_mean, block_se, D_mean, D_se)


def run_sweep_grid_lattice_gas(beta_values, n_runs: int, ps_kwargs: Dict,
                               init_kwargs: Optional[Dict],
                               run_kwargs: Dict, seed: int = 0,
                               n_tracers: Optional[int] = None,
                               kernel: str = "fused", device="cuda"):
    """(β × replicas) grid on the slot engines (JAX ``beta_sweep.py:
    158-266``); returns (config, out_for(i) accessor, dt, frames, the final
    (B, K, L) slot spins, the route taken).  Tagged tracers give the
    displacements for D_eff; the default tags EVERY particle (the whole
    buffer for Poisson inits, whose realised count varies), matching the
    reference's all-particle tracking (``..._sweep_beta.py:500-525``).

    ``kernel``: ``'xla'`` runs the plain-torch slot engines; ``'auto'``
    kernel B3/B4 where ``is_fused_exclusion_path(config)`` holds, the slot
    engines otherwise; ``'pallas'`` (the port's ``'fused'``, the default)
    B3/B4 or a ``ValueError``.  Anchors run the anchored engine under every
    kernel, as in the JAX package.  The route (one of ``FUSED_ROUTE``,
    ``K1_ROUTE``, ``SLOT_ROUTE``, ``ANCHORED_ROUTE``) is decided by the
    configuration and the kernel name alone."""
    config = config_from_kwargs(ps_kwargs)
    assert config.exclusion, "lattice-gas engines require site_capacity"
    if kernel not in ("xla", "auto", "pallas", "fused"):
        raise ValueError(f"unknown kernel {kernel!r}")
    rho0_p, rho0_m = _profiles(config, init_kwargs)
    rates = _rates(ps_kwargs)
    params = broadcast_params(config, beta=beta_values, n_runs=n_runs,
                              device=device, **rates)
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)), **rates)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    times = np.arange(0.0, T, obs_dt)
    kw = dict(T=T, obs_dt=obs_dt, dt=dt, seed=seed, device=device,
              rho0_plus=rho0_p, rho0_minus=rho0_m,
              record_fft=bool(run_kwargs.get("record_fft", True)))
    if config.anchor_positions is not None:
        frames, slots, exit_log = run_lattice_gas_anchored(config, params,
                                                           **kw)
        return (config, _lattice_gas_out_accessor(frames, times, exit_log),
                dt, frames, torch.sign(slots).to(torch.int32),
                ANCHORED_ROUTE)
    full_tags = config.n_buf if config.init == "poisson" else config.N
    kw["n_tracers"] = (full_tags if n_tracers is None
                       else min(n_tracers, full_tags))
    fused = is_fused_exclusion_path(config)
    if kernel in ("pallas", "fused") and not fused:
        raise ValueError(f"kernel={kernel!r} requires the fused-kernel "
                         "configuration class (K<=8, no anchors/crowding, "
                         "default flip rate)")
    if kernel != "xla" and fused:
        frames, spins_final = run_exclusion_sweep(config, params, **kw)
        route = FUSED_ROUTE
    elif config.K == 1:
        frames, occ = run_lattice_gas(config, params, **kw)
        spins_final, route = occ[:, None, :], K1_ROUTE
    else:
        frames, spins_final = run_lattice_gas_k(config, params, **kw)
        route = SLOT_ROUTE
    return (config, _lattice_gas_out_accessor(frames, times), dt, frames,
            spins_final, route)


def _lattice_gas_out_accessor(frames, times, exit_log=None):
    """out_for(i): replica i's frames as the reference's per-run dict of
    numpy arrays, with its exit log (``(exit_count, exit_times,
    exit_pos)``) where the run has one.  The first call copies the frames
    to the host, one copy per field for the whole batch."""
    on_host = []

    def out_for(i):
        if not on_host:
            on_host.append((LatticeGasFrames(*(a.cpu().numpy()
                                               for a in frames)),
                            None if exit_log is None else
                            tuple(a.cpu().numpy() for a in exit_log)))
        f, log = on_host[0]
        tr = f.tracer_pos[i]
        if log is not None:
            ec, et, ep = log
            k = min(int(ec[i]), et.shape[1])
            exit_times, exit_positions = list(et[i][:k]), list(ep[i][:k])
        else:
            exit_times, exit_positions = [], []
        return {
            "times_obs": times,
            "rho_p_list": f.rho_p[i],
            "rho_m_list": f.rho_m[i],
            "total_list": f.total[i],
            "m_local_list": f.m_local[i],
            "m_global": f.m_global[i],
            "var_list": f.var[i],
            "fft_amp_list": f.fft_amp[i] if f.fft_amp.shape[-1] else None,
            # tracer positions play the role of pos_frames for D_eff
            "pos_frames": tr,
            "alive_frames": tracer_valid_mask(tr),
            "pos_list": None,
            "exit_times": exit_times,
            "exit_positions": exit_positions,
        }

    return out_for


_STAT_KEYS = ("means", "stds", "ses", "D_means", "D_ses", "m_means",
              "m_stds", "m_ses", "rho_means", "rho_ses", "block_means",
              "block_ses")


def sweep_over_betas(beta_values, n_runs_per_beta: int = 10, run: bool = True,
                     save_dict: Optional[Dict] = None,
                     ps_kwargs: Optional[Dict] = None,
                     init_kwargs: Optional[Dict] = None,
                     run_kwargs: Optional[Dict] = None,
                     npz_path: str = "beta_sweep_results.npz",
                     outdir: str = ".", seed: int = 0,
                     keep_outs: bool = False, do_fit: bool = True,
                     plot_result: bool = True, engine: str = "particle",
                     estimator: str = "device", mesh=None,
                     n_devices: Optional[int] = None, ckpt_dir=None,
                     device="cuda") -> Dict:
    """Full β sweep (:828-1028): one batched grid run on ``device`` →
    estimator means ± SE per β → npz checkpoint → (θ, γ) fit and figures.
    ``run=False`` reloads ``npz_path`` and re-fits without simulating.
    ``engine``: ``'particle'`` (the default) runs the particle engine
    (``run_sweep_grid``; the estimators read the frames' positions and
    alive masks); ``'lattice_gas'`` the slot engines (``kernel='xla'``);
    the fused names (``FUSED_ENGINES``) kernel B3/B4 where it covers the
    configuration and the slot engines elsewhere (``kernel='auto'``, as the
    JAX package maps ``'pallas'``).  Beside the JAX package's keys the
    result holds ``route``, the engine that ran, and on the slot routes
    ``spins_final``, the (β·runs, K, L) slot spins at the end of the run."""
    check_engine(engine)
    if estimator != "device":
        raise not_ported(f"estimator={estimator!r}", "host")
    if mesh is not None or n_devices is not None:
        raise not_ported("mesh= / n_devices=", "parallelism")
    if ckpt_dir is not None:
        raise not_ported("ckpt_dir=", "checkpointing")
    beta_values = np.asarray(beta_values, dtype=float)
    ps_kwargs = dict(DEFAULT_PS_KWARGS, **(ps_kwargs or {}))
    run_kwargs = dict(DEFAULT_RUN_KWARGS, **(run_kwargs or {}))
    if init_kwargs is None and ps_kwargs.get("init") == "poisson":
        grad = make_exp_gradient(L=int(ps_kwargs["L"]), N=int(ps_kwargs["N"]),
                                 frac_plus=0.75, decay_length=0.35,
                                 anchor_positions=None)
        init_kwargs = dict(rho0_plus=grad[0], rho0_minus=grad[1])

    outs = []
    if run:
        T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
        times = np.arange(0.0, T, obs_dt)
        extra = {}
        if engine == "particle":
            config, res, dt = run_sweep_grid(
                beta_values, n_runs_per_beta, ps_kwargs, init_kwargs,
                run_kwargs, seed=seed, device=device)
            f = res.frames
            est = _device_estimates(config, f, times, f.pos, f.alive)
            out_for = lambda i: frames_to_out(f, i, config, T, obs_dt,
                                              final_state=res.final_state)
            route = res.engine
        else:
            (config, out_for, dt, f, spins_final,
             route) = run_sweep_grid_lattice_gas(
                beta_values, n_runs_per_beta, ps_kwargs, init_kwargs,
                run_kwargs, seed=seed, device=device,
                kernel="xla" if engine == "lattice_gas" else "auto")
            tr = f.tracer_pos
            est = _device_estimates(config, f, times, tr,
                                    tracer_valid_mask(tr))
            extra["spins_final"] = spins_final.cpu().numpy()
        per_beta = {k: [] for k in _STAT_KEYS}
        n = n_runs_per_beta
        for b in range(len(beta_values)):
            rows = slice(b * n, (b + 1) * n)
            vm, vs, vse = _stats(est["v_eff"][rows])
            Dm, _, Dse = _stats(est["D_eff"][rows])
            mm, ms, mse = _stats(est["m_mean"][rows])
            rm, _, rse = _stats(est["rho_eff"][rows])
            bm, _, bse = _stats(est["p_block"][rows])
            for k, x in zip(_STAT_KEYS, (vm, vs, vse, Dm, Dse, mm, ms, mse,
                                         rm, rse, bm, bse)):
                per_beta[k].append(x)
            if keep_outs:
                outs.append([out_for(b * n + r) for r in range(n)])
        arrays = {k: np.asarray(v) for k, v in per_beta.items()}
        save_dict = {"beta_values": beta_values, **arrays,
                     "ps_kwargs": ps_kwargs, "dt": dt, **extra,
                     "route": np.str_(route)}
        Path(npz_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(npz_path, **{k: v for k, v in save_dict.items()
                              if k != "ps_kwargs"},
                 ps_kwargs=np.asarray(
                     {k: v for k, v in ps_kwargs.items()
                      if not callable(v)}, dtype=object))
    else:
        data = np.load(npz_path, allow_pickle=True)
        save_dict = dict(data)
        beta_values = save_dict["beta_values"]
        ps_kwargs = save_dict["ps_kwargs"].item()
        arrays = {k: save_dict[k] for k in _STAT_KEYS}

    if do_fit:
        popt, pcov, fit_out = fit_and_plot_v_eff(
            beta_values, ps_kwargs, arrays["means"], arrays["stds"],
            arrays["ses"], arrays["m_means"], arrays["m_stds"],
            arrays["m_ses"], arrays["rho_means"], arrays["rho_ses"],
            arrays["block_means"], arrays["block_ses"],
            plot_result=plot_result, outdir=outdir)
        save_dict.update(popt=popt, pcov=pcov, fit_out=fit_out)
        if plot_result:
            from hydrolim_tpu_torch.viz.sweep_plots import plot_D_eff_vs_beta

            plot_D_eff_vs_beta(beta_values, arrays["D_means"],
                               arrays["D_ses"], ps_kwargs, outdir=outdir)
    if keep_outs:
        save_dict["outs"] = outs
    return save_dict
