"""Local-structure β-sweep (pattern-formation analysis).

The port of the JAX package's ``sweeps/local_structure.py``
(`PARTICLE_solver_BIOLOGY_local_structure.py`):
``sweep_beta_structure_ensemble`` (:105-165), ``sweep_betas_for_structures``
(:167-193), the npz persistence (:625-641) and the reference's ``__main__``
configuration (:671-753).  The (β × replicas) grid runs as one batch on
the device:

- ``engine='particle'`` (the default, as in the JAX package): the particle
  engine (``beta_sweep.run_sweep_grid``), the general τ-leap step at the
  reference configuration (K=1 exclusion, walls, local m);
- ``engine='pallas'``: kernel B3/B4 (``run_exclusion_sweep``), for the
  configurations inside its scope;
- ``engine='lattice_gas'``: the plain-torch slot engines (``run_lattice_gas``
  at K=1, ``run_lattice_gas_k`` above).

The structure observables need no particle identity, so the slot routes
tag no tracers.  ``ckpt_dir=`` checkpoints the ``'particle'`` and
``'lattice_gas'`` routes (``utils/checkpoint.py``); ``'pallas'`` refuses it,
as in the JAX package.  ``n_devices=`` splits the batch over a sweep mesh
(``parallel.mesh``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np

from hydrolim_tpu_torch.parallel.mesh import resolve_sweep_mesh
from hydrolim_tpu_torch.observables.structure import (
    extract_structure_observables_from_out,
)
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu_torch.sweeps.beta_sweep import (
    _profiles,
    config_from_kwargs,
    make_exp_gradient,
    run_sweep_grid,
)
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    ensemble_dt,
    frames_to_out,
)
from hydrolim_tpu_torch.sweeps.fast_exclusion import (
    is_fused_exclusion_path,
    run_exclusion_sweep,
)
from hydrolim_tpu_torch.utils.checkpoint import (
    run_lattice_gas_checkpointed,
    run_lattice_gas_k_checkpointed,
)

STRUCTURE_ENGINES = ("particle", "lattice_gas", "pallas")

# Reference local-structure configuration
# (PARTICLE_solver_BIOLOGY_local_structure.py:671-726): faster diffusion
# than the β-sweep (0.05), non-periodic, 'fixed' init at N=900, obs_dt=1.
# (The reference passes exp-gradient ρ₀± callables alongside init='fixed',
# but its _init_fixed ignores them, so they are dead kwargs.)
DEFAULT_STRUCTURE_PS_KWARGS: Dict = dict(
    L=1000, xlim=1, rate_diffusion=0.05, rate_active=5, flip_rate_fn=None,
    init="fixed", N=900, scale_rates=False, local_kernel_sigma=0.005,
    minus_anchor=True, periodic=False, immobilize_when_anchored=True,
    anchor_radius=0.003, anchor_positions=None, site_capacity=1,
    crowding_suppresses_rates=False, k_on=0, k_off=0, k_exit=0,
)
DEFAULT_STRUCTURE_RUN_KWARGS: Dict = dict(T=40, obs_dt=1.0, record_fft=True,
                                          record_var=True)


def _ensemble_stats(per_run, n_runs: int) -> Dict:
    """The reference's per-β summary of the per-run observables (:105-165
    return schema)."""
    arr = lambda key: np.array([x[key] for x in per_run])
    se = lambda a: a.std(ddof=1) / np.sqrt(n_runs) if n_runs > 1 else 0.0
    fft_stack = np.stack([x["fft_mean"] for x in per_run], axis=0)
    return {
        "var_mean": arr("var_mean").mean(),
        "var_se": se(arr("var_mean")),
        "low_k_power_mean": arr("low_k_power").mean(),
        "low_k_power_se": se(arr("low_k_power")),
        "dominant_k_mode": int(np.round(arr("dominant_k").mean())),
        "m_local_var_mean": arr("m_local_var").mean(),
        "m_local_var_se": se(arr("m_local_var")),
        "fft_mean_mean": fft_stack.mean(axis=0),
        "fft_mean_se": (fft_stack.std(axis=0, ddof=1) / np.sqrt(n_runs)
                        if n_runs > 1 else np.zeros(fft_stack.shape[1])),
        "lowk_var_mean": arr("lowk_variance").mean(),
        "lowk_var_se": se(arr("lowk_variance")),
        "raw": per_run,
    }


def _observed(out: Dict, start_fraction: float, k_max: Optional[int],
              keep_outs: bool) -> Dict:
    obs = extract_structure_observables_from_out(
        out, start_fraction=start_fraction, k_max=k_max)
    return {**obs, "out": out if keep_outs else None}


def sweep_beta_structure_ensemble(beta, n_runs: int, ps_kwargs: Dict,
                                  init_kwargs: Optional[Dict],
                                  run_kwargs: Dict,
                                  start_fraction: float = 0.5,
                                  k_max: Optional[int] = None,
                                  rng_seeds=None, seed: int = 0,
                                  keep_outs: bool = True,
                                  device="cuda") -> Dict:
    """One β, n replicas on the particle engine → ensemble-averaged
    structure observables (:105-165 return schema)."""
    if rng_seeds is not None:
        seed = int(np.asarray(rng_seeds).flat[0])
    config, res, _ = run_sweep_grid(np.asarray([beta]), n_runs, ps_kwargs,
                                    init_kwargs, run_kwargs, seed=seed,
                                    device=device)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    per_run = [_observed(frames_to_out(res.frames, r, config, T, obs_dt,
                                       final_state=res.final_state),
                         start_fraction, k_max, keep_outs)
               for r in range(n_runs)]
    return _ensemble_stats(per_run, n_runs)


def _lattice_gas_outs(beta_values, n_runs, ps_kwargs, init_kwargs,
                      run_kwargs, seed, kernel: str = "xla",
                      n_devices: Optional[int] = None, ckpt_dir=None,
                      device="cuda"):
    """The (β × replicas) grid on a slot route, as reference-schema out
    dicts per replica (``out_for(i)``): ``kernel='xla'`` the plain-torch
    slot engines, ``'auto'``/``'pallas'`` kernel B3/B4, which must cover
    the configuration (``is_fused_exclusion_path``).  ``ckpt_dir=`` runs
    the slot engines' checkpointed runners (``kernel='xla'`` only);
    ``n_devices=`` splits the batch over a sweep mesh."""
    mesh = resolve_sweep_mesh(None, n_devices, device)
    config = config_from_kwargs(ps_kwargs)
    assert config.exclusion, "lattice-gas engines require site_capacity"
    if kernel != "xla":
        if not is_fused_exclusion_path(config):
            raise ValueError("the fused structure sweep requires the "
                             "fused-kernel configuration class (K<=8, no "
                             "anchors/crowding, default flip rate)")
        runner = run_exclusion_sweep
    else:
        runner = run_lattice_gas_k if config.K > 1 else run_lattice_gas
    if ckpt_dir is not None:
        assert kernel == "xla", (
            "ckpt_dir requires the XLA lattice-gas engines (the fused "
            "Pallas route runs uncheckpointed)")
        runner = functools.partial(
            run_lattice_gas_k_checkpointed if config.K > 1
            else run_lattice_gas_checkpointed, ckpt_dir=ckpt_dir)
    rho0_p, rho0_m = _profiles(config, init_kwargs)
    rates = dict(rate_diffusion=float(ps_kwargs["rate_diffusion"]),
                 rate_active=float(ps_kwargs["rate_active"]))
    params = broadcast_params(config, beta=beta_values, n_runs=n_runs,
                              device=device, **rates)
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)), **rates)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    frames, _ = runner(config, params, T=T, obs_dt=obs_dt, dt=dt, seed=seed,
                       device=device, rho0_plus=rho0_p, rho0_minus=rho0_m,
                       mesh=mesh)
    frames = type(frames)(*(a.cpu().numpy() for a in frames))
    times = np.arange(0.0, T, obs_dt)

    def out_for(i):
        return {
            "times_obs": times,
            "rho_p_list": frames.rho_p[i],
            "rho_m_list": frames.rho_m[i],
            "total_list": frames.total[i],
            "m_local_list": frames.m_local[i],
            "m_global": frames.m_global[i],
            "var_list": frames.var[i],
            "fft_amp_list": frames.fft_amp[i],
        }

    return config, out_for


def sweep_betas_for_structures(beta_values, n_runs_per_beta: int,
                               ps_kwargs: Optional[Dict] = None,
                               init_kwargs: Optional[Dict] = None,
                               run_kwargs: Optional[Dict] = None,
                               start_fraction: float = 0.5,
                               k_max: Optional[int] = None, seed: int = 0,
                               keep_outs: bool = True,
                               engine: str = "particle",
                               n_devices: Optional[int] = None,
                               ckpt_dir=None, device="cuda") -> Dict:
    """β grid → {β: ensemble results} (:167-193), the whole (β × replicas)
    grid in one batch on ``device``; ``engine`` names the route (module
    docstring).  ``n_devices=`` splits the batch over a sweep mesh on
    every route, the one-device result bit for bit; only ``'pallas'``
    (kernel B3) can gain wall time from more cards (``parallel.mesh``)."""
    if engine not in STRUCTURE_ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    ps_kwargs = dict(DEFAULT_STRUCTURE_PS_KWARGS, **(ps_kwargs or {}))
    run_kwargs = dict(DEFAULT_STRUCTURE_RUN_KWARGS, **(run_kwargs or {}))
    if init_kwargs is None and ps_kwargs.get("init") == "poisson":
        # reference profile shape (:683-691; only reaches the sampler when
        # a caller overrides init='poisson' — 'fixed' ignores profiles)
        g = make_exp_gradient(L=int(ps_kwargs["L"]), N=int(ps_kwargs["N"]),
                              frac_plus=0.75, decay_length=0.2,
                              anchor_positions=None)
        init_kwargs = dict(rho0_plus=g[0], rho0_minus=g[1])
    beta_values = np.asarray(beta_values, dtype=float)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    if ckpt_dir is not None:
        assert engine in ("lattice_gas", "particle"), (
            "ckpt_dir requires engine='lattice_gas' or 'particle' (the "
            "fused Pallas route runs uncheckpointed)")
    if engine == "particle":
        config, res, _ = run_sweep_grid(beta_values, n_runs_per_beta,
                                        ps_kwargs, init_kwargs, run_kwargs,
                                        seed=seed, ckpt_dir=ckpt_dir,
                                        device=device, n_devices=n_devices)
        out_for = lambda i: frames_to_out(res.frames, i, config, T, obs_dt,
                                          final_state=res.final_state)
    else:
        config, out_for = _lattice_gas_outs(
            beta_values, n_runs_per_beta, ps_kwargs, init_kwargs,
            run_kwargs, seed,
            kernel="auto" if engine == "pallas" else "xla",
            n_devices=n_devices, ckpt_dir=ckpt_dir, device=device)
    n = n_runs_per_beta
    return {float(beta): _ensemble_stats(
        [_observed(out_for(b * n + r), start_fraction, k_max, keep_outs)
         for r in range(n)], n)
        for b, beta in enumerate(beta_values)}


def save_structure_results(results: Dict, path: str) -> None:
    """npz persistence of the β→observables map (:625-633)."""
    flat = {}
    for beta, res in results.items():
        key = f"b{beta:.6f}"
        for name, val in res.items():
            if name == "raw":
                continue
            flat[f"{key}__{name}"] = np.asarray(val)
    flat["beta_values"] = np.asarray(sorted(results.keys()))
    np.savez(path, **flat)


def load_structure_results(path: str) -> Dict:
    """Inverse of :func:`save_structure_results` (:636-641)."""
    data = np.load(path, allow_pickle=True)
    betas = data["beta_values"]
    results = {}
    for beta in betas:
        key = f"b{float(beta):.6f}"
        res = {}
        for name in data.files:
            if name.startswith(key + "__"):
                val = data[name]
                res[name[len(key) + 2:]] = (val.item() if val.ndim == 0
                                            else val)
        results[float(beta)] = res
    return results
