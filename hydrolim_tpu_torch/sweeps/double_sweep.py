"""(N, β) double sweep — calibration of the exclusion constants C0/C1/C2.

The port of the JAX package's ``sweeps/double_sweep.py``
(`PARTICLE_solver_BIOLOGY_EXCLUSION_double_sweep.py`): per particle count
N, the blocking probability p_block(β) is fitted with the 2-parameter model
ρ_block = (ρ̄/K)·(f + g/cosh(β·m_β)) (:290-317); the per-N (f, g) fits are
then meta-fitted over x = ρ̄ with f(x) = C0 − C1·x and g(x) = C2/x^{3/2}
(:877-961), the pipeline that produced the frozen C0/C1/C2 constants.

The defaults are ``DOUBLE_SWEEP_PS_KWARGS``, the reference double sweep's
own physics block (:666-694).

``double_sweep_fused`` runs the whole (N × β × replicas) grid on the
particle engine (``engine='particle'``, the default as in the JAX package:
the general τ-leap step, no positions recorded), on kernel B3/B4
(``'pallas'``) or on the plain-torch slot engine (``'lattice_gas'``,
``run_lattice_gas_k``): N enters only through the per-replica Poisson
profiles, so one (B, L) batch of ``chunk_size`` replicas per call holds
any N.  The JAX package's ``ckpt_dir=`` chunk ledger and ``n_devices=`` are
not ported yet (``core/scope.py`` names their ROADMAP.md items).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
from scipy.optimize import curve_fit

from hydrolim_tpu_torch.core.scope import not_ported
from hydrolim_tpu_torch.fit.veff_fit import _pyplot
from hydrolim_tpu_torch.observables.batched import batched_estimates
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu_torch.sweeps.beta_sweep import (
    DEFAULT_PS_KWARGS,
    check_engine,
    config_from_kwargs,
    make_exp_gradient,
    sweep_over_betas,
)
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    chunk_seed,
    ensemble_dt,
    run_particle_ensemble,
)
from hydrolim_tpu_torch.sweeps.fast_exclusion import run_exclusion_sweep
from hydrolim_tpu_torch.theory.meanfield import compute_m_of_beta_non

# The reference's double sweep runs a DIFFERENT physics configuration than
# its β-sweep (:666-694): slower diffusion, faster active hopping, a 4×
# wider interaction kernel, and a steeper initial plus-gradient
# (decay_length 0.2, :698-714).  The frozen C0/C1/C2 were produced here.
DOUBLE_SWEEP_PS_KWARGS: Dict = dict(
    DEFAULT_PS_KWARGS, rate_diffusion=0.005, rate_active=10,
    local_kernel_sigma=0.02)
DOUBLE_SWEEP_DECAY_LENGTH = 0.2


def rho_model(beta, f, g, rho_bar, K, m_beta):
    """ρ_block model (:290-292)."""
    return (rho_bar / K) * (f + g / np.cosh(np.asarray(beta) * m_beta))


def fit_blocking_fg(beta_values, block_means, block_ses, rho_bar, K,
                    p0=(4.0, 1.0), bounds=([0, 0], [100, 20])):
    """(f, g) fit of p_block(β) (:294-317)."""
    beta_values = np.asarray(beta_values, dtype=float)

    def model(beta, f, g):
        m_beta = compute_m_of_beta_non(beta)
        return rho_model(beta, f, g, rho_bar, K, m_beta)

    sigma = np.asarray(block_ses, dtype=float)
    sigma = np.where(sigma > 0, sigma, max(1e-6, np.nanmax(sigma)))
    popt, pcov = curve_fit(model, beta_values, np.asarray(block_means),
                           sigma=sigma, absolute_sigma=True, p0=list(p0),
                           bounds=bounds, maxfev=2_000_000)
    f_err, g_err = np.sqrt(np.diag(pcov))
    return popt[0], popt[1], f_err, g_err


def f_model(x, C0, C1):
    return C0 - C1 * x


def g_model(x, C2):
    return C2 / x ** 1.5


def _plot_fg(out: Path, x_vals, f_vals, f_errs, g_vals, g_errs,
             C0: float, C1: float, C2: float) -> None:
    """f_fit.png / g_fit.png, the reference's meta-fit figures (:877-961);
    skipped where matplotlib is not installed."""
    plt = _pyplot()
    if plt is None:
        return
    x_dense = np.linspace(np.min(x_vals), np.max(x_vals), 300)
    for vals, errs, model, args, label, fname in (
            (f_vals, f_errs, f_model, (C0, C1), r"$C_0 - C_1 x$",
             "f_fit.png"),
            (g_vals, g_errs, g_model, (C2,), r"$C_2 / x^{3/2}$",
             "g_fit.png")):
        plt.figure(figsize=(6, 4))
        plt.errorbar(x_vals, vals, yerr=errs, fmt="o", capsize=3,
                     label="fit data")
        plt.plot(x_dense, model(x_dense, *args), "--", label=label)
        plt.xlabel("x")
        plt.ylabel(fname[0])
        plt.legend()
        plt.grid(True)
        plt.tight_layout()
        plt.savefig(out / fname, dpi=200)
        plt.close()


def _meta_fit(out: Path, list_N_part, L: int, f_fit, f_err, g_fit, g_err,
              plot_result: bool) -> Dict:
    """C0/C1 of f(x) = C0 − C1·x and C2 of g(x) = C2/x^{3/2} over the
    per-N fits, x = N/L (:877-961)."""
    x_vals = np.asarray(list_N_part, dtype=float) / L
    f_vals = np.asarray(f_fit)
    f_errs = np.where(np.asarray(f_err) > 0, f_err, 1e-3)
    g_vals = np.asarray(g_fit)
    g_errs = np.where(np.asarray(g_err) > 0, g_err, 1e-3)
    (C0, C1), pcov_f = curve_fit(f_model, x_vals, f_vals, sigma=f_errs,
                                 absolute_sigma=True)
    (C2,), pcov_g = curve_fit(g_model, x_vals, g_vals, sigma=g_errs,
                              absolute_sigma=True)
    C0_err, C1_err = np.sqrt(np.diag(pcov_f))
    if plot_result:
        _plot_fg(out, x_vals, f_vals, f_errs, g_vals, g_errs,
                 float(C0), float(C1), float(C2))
    return {"N_values": np.asarray(list_N_part, dtype=float),
            "f_fit": f_vals, "f_err": np.asarray(f_err), "g_fit": g_vals,
            "g_err": np.asarray(g_err), "C0": float(C0), "C1": float(C1),
            "C2": float(C2), "C0_err": float(C0_err),
            "C1_err": float(C1_err), "C2_err": float(np.sqrt(pcov_g[0, 0]))}


def double_sweep_fused(beta_values, list_N_part: Sequence[float],
                       n_runs_per_beta: int = 4,
                       ps_kwargs: Optional[Dict] = None,
                       run_kwargs: Optional[Dict] = None, outdir: str = ".",
                       seed: int = 0, plot_result: bool = True,
                       chunk_size: int = 44, engine: str = "particle",
                       n_devices: Optional[int] = None, ckpt_dir=None,
                       device="cuda") -> Dict:
    """The whole (N × β × replicas) grid on the particle engine
    (``'particle'``: ``run_particle_ensemble`` without positions, the
    τ-leap step), kernel B3/B4 (the fused names) or the slot engine
    (``'lattice_gas'``) in chunks of ``chunk_size`` replicas (per-replica
    Poisson profiles, (B, L)), each chunk's draws from a generator seeded
    by ``chunk_seed(seed, c0)``; the blocking estimator runs on the device
    per chunk, the (f, g) fits and the C0/C1/C2 meta-fit on the host.
    Returns the JAX package's keys."""
    check_engine(engine)
    if ckpt_dir is not None:
        raise not_ported("ckpt_dir= (the chunk ledger)", "checkpointing")
    if n_devices is not None:
        raise not_ported("n_devices=", "parallelism")
    beta_values = np.asarray(beta_values, dtype=float)
    list_N_part = np.asarray(list_N_part, dtype=float)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    base = dict(DOUBLE_SWEEP_PS_KWARGS, **(ps_kwargs or {}))
    rk = dict(T=10, obs_dt=0.1, record_fft=False, record_var=True)
    rk.update(run_kwargs or {})

    L = int(base["L"])
    config = config_from_kwargs(dict(base, N=int(list_N_part.max())))
    nN, nB, nr = len(list_N_part), len(beta_values), n_runs_per_beta
    B = nN * nB * nr
    # per-replica Poisson profiles, (N, β, run)-major
    prof_p = np.zeros((B, L), np.float32)
    prof_m = np.zeros((B, L), np.float32)
    per_N = nB * nr
    for i, N_part in enumerate(list_N_part):
        g = make_exp_gradient(L=L, N=int(N_part), frac_plus=0.75,
                              decay_length=DOUBLE_SWEEP_DECAY_LENGTH,
                              anchor_positions=None)
        prof_p[i * per_N:(i + 1) * per_N] = g[2]
        prof_m[i * per_N:(i + 1) * per_N] = g[3]
    flat_beta = np.tile(np.repeat(beta_values, nr), nN).astype(np.float32)
    rates = dict(rate_diffusion=float(base["rate_diffusion"]),
                 rate_active=float(base["rate_active"]))
    dt = ensemble_dt(config, beta_max=float(beta_values.max()), **rates)
    T, obs_dt = float(rk["T"]), float(rk["obs_dt"])
    times = np.arange(0.0, T, obs_dt)

    record_fft = bool(rk.get("record_fft", False))
    p_block_flat = np.zeros((B,), float)
    for c0 in range(0, B, chunk_size):
        sl = slice(c0, min(c0 + chunk_size, B))
        params_c = broadcast_params(config, beta=flat_beta[sl],
                                    device=device, **rates)
        kw = dict(T=T, obs_dt=obs_dt, dt=dt, rho0_plus=prof_p[sl],
                  rho0_minus=prof_m[sl], record_fft=record_fft,
                  device=device)
        if engine == "particle":
            frames = run_particle_ensemble(config, params_c,
                                           chunk_seed(seed, c0),
                                           record_pos=False, **kw).frames
        else:
            runner = (run_lattice_gas_k if engine == "lattice_gas"
                      else run_exclusion_sweep)
            frames, _ = runner(config, params_c, seed=chunk_seed(seed, c0),
                               **kw)
        est = batched_estimates(frames.total, frames.m_global, frames.rho_p,
                                times, dx=config.dx, xlim=float(config.xlim),
                                has_positions=False)
        p_block_flat[sl] = est.p_block.cpu().numpy()

    K = int(base["site_capacity"])
    f_fit, f_err, g_fit, g_err, per_N_out = [], [], [], [], []
    for i, N_part in enumerate(list_N_part):
        blks = p_block_flat[i * per_N:(i + 1) * per_N].reshape(nB, nr)
        block_means = list(blks.mean(1))
        block_ses = list(blks.std(1, ddof=1) / np.sqrt(nr) if nr > 1
                         else np.zeros(nB))
        f_v, g_v, f_e, g_e = fit_blocking_fg(beta_values, block_means,
                                             block_ses, float(N_part) / L, K)
        f_fit.append(f_v)
        f_err.append(f_e)
        g_fit.append(g_v)
        g_err.append(g_e)
        per_N_out.append({"N": float(N_part), "block_means": block_means,
                          "block_ses": block_ses})
    res = _meta_fit(out, list_N_part, L, f_fit, f_err, g_fit, g_err,
                    plot_result)
    res["per_N"] = per_N_out
    return res


def double_sweep(beta_values, list_N_part: Sequence[float],
                 n_runs_per_beta: int = 4, ps_kwargs: Optional[Dict] = None,
                 run_kwargs: Optional[Dict] = None, outdir: str = ".",
                 seed: int = 0, plot_result: bool = True,
                 device="cuda") -> Dict:
    """Full (N × β × replicas) pipeline (:851-961), one ``sweep_over_betas``
    per N on its default engine (``'particle'``), as in the JAX package.
    Returns {'N_values', 'f_fit', 'f_err',
    'g_fit', 'g_err', 'C0', 'C1', 'C2', ..., 'per_N'}; also saves
    f_fit.png / g_fit.png where matplotlib is installed."""
    beta_values = np.asarray(beta_values, dtype=float)
    list_N_part = np.asarray(list_N_part, dtype=float)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    base = dict(DOUBLE_SWEEP_PS_KWARGS, **(ps_kwargs or {}))
    rk = dict(T=10, obs_dt=0.1, record_fft=True, record_var=True)
    rk.update(run_kwargs or {})

    f_fit, f_err, g_fit, g_err, per_N = [], [], [], [], []
    for n_idx, N_part in enumerate(list_N_part):
        pk = dict(base, N=int(N_part))
        grad = make_exp_gradient(L=int(pk["L"]), N=int(N_part),
                                 frac_plus=0.75,
                                 decay_length=DOUBLE_SWEEP_DECAY_LENGTH,
                                 anchor_positions=None)
        save = sweep_over_betas(
            beta_values, n_runs_per_beta=n_runs_per_beta, run=True,
            ps_kwargs=pk, run_kwargs=rk,
            init_kwargs=dict(rho0_plus=grad[0], rho0_minus=grad[1]),
            npz_path=str(out / f"beta_sweep_N{int(N_part)}.npz"),
            outdir=str(out), seed=seed + 10_000 * n_idx, do_fit=False,
            plot_result=False, device=device)
        f_v, g_v, f_e, g_e = fit_blocking_fg(
            beta_values, save["block_means"], save["block_ses"],
            float(N_part) / float(pk["L"]), int(pk["site_capacity"]))
        f_fit.append(f_v)
        f_err.append(f_e)
        g_fit.append(g_v)
        g_err.append(g_e)
        per_N.append({"N": float(N_part), "save": {
            k: save[k] for k in ("means", "ses", "D_means", "D_ses",
                                 "block_means", "block_ses", "m_means")}})
    res = _meta_fit(out, list_N_part, int(base["L"]), f_fit, f_err, g_fit,
                    g_err, plot_result)
    res["per_N"] = per_N
    return res
