"""β-sweep driver — the reference's flagship particle experiment.

Mirrors the JAX package's ``sweeps/beta_sweep.py``
(`PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py`):

- ``make_exp_gradient``, the exp-gradient ρ₀± profile factory (:16-53);
- ``sweep_over_betas`` (:828-1028): the whole (β × replicas) grid in one
  batch, the five estimators per replica on the device, means ± SE per β,
  the npz checkpoint (``run=False`` reloads it), the (θ, γ) NB fit and the
  standard figures (where matplotlib is installed).

Routes (``run_sweep_grid_lattice_gas``), decided by the configuration and
the engine name alone:

- anchors (bind / unbind / exit) → the anchored slot engine
  (``run_lattice_gas_anchored``), whatever the engine;
- ``engine='lattice_gas'`` (``kernel='xla'``) → the XLA slot engines in
  plain torch: ``run_lattice_gas`` at K=1, ``run_lattice_gas_k`` above;
- ``'fused'``, ``'pallas'`` and ``'auto'`` (``kernel='auto'``) → kernel
  B3/B4 where ``is_fused_exclusion_path`` holds, the slot engines
  otherwise (crowding, K > 8).

The route taken is returned with the grid and saved as the sweep's
``route``.  The particle-centric engine (``engine='particle'``), the host estimators,
``mesh=`` and ``ckpt_dir=`` are not ported yet: each raises
``NotImplementedError`` naming its ROADMAP.md item (``core/scope.py``).
"""
from __future__ import annotations

from pathlib import Path
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
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_dt
from hydrolim_tpu_torch.sweeps.fast_exclusion import (
    is_fused_exclusion_path,
    run_exclusion_sweep,
)

# the JAX package's names of the fused route
FUSED_ENGINES = ("fused", "pallas", "auto")
SWEEP_ENGINES = FUSED_ENGINES + ("lattice_gas",)

# the routes of run_sweep_grid_lattice_gas
FUSED_ROUTE = "exclusion_multi_step"
K1_ROUTE = "lg_step"
SLOT_ROUTE = "lgk_step"
ANCHORED_ROUTE = "lgk_step anchored"


def check_fused_engine(engine: str) -> None:
    """Accept the names of the fused route and ``'lattice_gas'`` (the slot
    engines); the particle engine raises with the ROADMAP.md item that
    ports it."""
    if engine == "particle":
        raise not_ported("engine='particle'", "tau-leap")
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
    rates = dict(
        rate_diffusion=float(ps_kwargs["rate_diffusion"]),
        rate_active=float(ps_kwargs["rate_active"]),
        k_on=float(ps_kwargs.get("k_on", 0)),
        k_off=float(ps_kwargs.get("k_off", 0)),
        k_exit=float(ps_kwargs.get("k_exit", 0)))
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
                     plot_result: bool = True, engine: str = "fused",
                     estimator: str = "device", device="cuda") -> Dict:
    """Full β sweep (:828-1028): one batched grid run on ``device`` →
    estimator means ± SE per β → npz checkpoint → (θ, γ) fit and figures.
    ``run=False`` reloads ``npz_path`` and re-fits without simulating.
    ``engine``: ``'lattice_gas'`` runs the slot engines (``kernel='xla'``);
    the fused names (``FUSED_ENGINES``) take kernel B3/B4 where it covers
    the configuration and the slot engines elsewhere (``kernel='auto'``, as
    the JAX package maps ``'pallas'``).  Beside the JAX package's keys the
    result holds ``spins_final``, the (β·runs, K, L) slot spins at the end
    of the run, and ``route``, the engine that ran."""
    check_fused_engine(engine)
    if estimator != "device":
        raise not_ported(f"estimator={estimator!r}", "host")
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
        (config, out_for, dt, f, spins_final,
         route) = run_sweep_grid_lattice_gas(
            beta_values, n_runs_per_beta, ps_kwargs, init_kwargs,
            run_kwargs, seed=seed, device=device,
            kernel="xla" if engine == "lattice_gas" else "auto")
        T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
        tr = f.tracer_pos
        est = batched_estimates(
            f.total, f.m_global, f.rho_p, np.arange(0.0, T, obs_dt), tr,
            tracer_valid_mask(tr), dx=config.dx, xlim=float(config.xlim),
            has_positions=tr.shape[-1] > 0)
        est = {k: getattr(est, k).cpu().numpy().astype(float)
               for k in ("v_eff", "D_eff", "m_mean", "rho_eff", "p_block")}
        per_beta = {k: [] for k in _STAT_KEYS}
        nb, n = len(beta_values), n_runs_per_beta

        def stat(a):
            std = np.std(a, ddof=1) if len(a) > 1 else 0.0
            return np.mean(a), std, std / np.sqrt(max(1, len(a)))

        for b in range(nb):
            rows = slice(b * n, (b + 1) * n)
            vm, vs, vse = stat(est["v_eff"][rows])
            Dm, _, Dse = stat(est["D_eff"][rows])
            mm, ms, mse = stat(est["m_mean"][rows])
            rm, _, rse = stat(est["rho_eff"][rows])
            bm, _, bse = stat(est["p_block"][rows])
            for k, x in zip(_STAT_KEYS, (vm, vs, vse, Dm, Dse, mm, ms, mse,
                                         rm, rse, bm, bse)):
                per_beta[k].append(x)
            if keep_outs:
                outs.append([out_for(b * n + r) for r in range(n)])
        arrays = {k: np.asarray(v) for k, v in per_beta.items()}
        save_dict = {"beta_values": beta_values, **arrays,
                     "ps_kwargs": ps_kwargs, "dt": dt,
                     "spins_final": spins_final.cpu().numpy(),
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
