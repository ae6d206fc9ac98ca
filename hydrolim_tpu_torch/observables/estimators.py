"""Estimator suite over particle-run outputs.

Re-implementations of the estimator layer duplicated across the reference
sweep scripts (canonical copies in
PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py):

- ``compute_v_eff_and_window`` (:123-162) — density-center-of-mass drift with
  a boundary-safety measurement window.  The reference applies ``~`` to an
  integer index array (:147), so whenever any frame exceeds the boundary-mass
  threshold the window collapses to [0.65·M, 0.65·M + max(3, 0.1·M)]
  (SURVEY.md §2.4).  ``window_mode='legacy'`` (default — the frozen baselines
  were produced this way) reproduces that behavior; ``'strict'`` implements
  the intended first-unsafe-frame cutoff.
- ``compute_D_eff_active`` (:500-525) — displacement-variance slope.  The
  reference pairs particles by truncated array index, which breaks when exits
  shift indices (np.delete); here particles carry stable buffer slots
  (alive-mask), so displacement pairing is exact.
- ``compute_mean_magnetization`` (:316-319), ``compute_rho_eff`` (:165-194,
  flagged WRONG in the reference but part of its API), and
  ``compute_blocking_probability`` (:197-229, vectorized over frames/sites).

The JAX package's module (``hydrolim_tpu/observables/estimators.py``) in
NumPy: these are the host estimators behind ``estimator='host'`` of the
β-sweep drivers, one replica's ``out`` dict at a time (the device path is
``observables/batched.py``).  Dict wrappers keep the reference call
signatures ``f(out, ...)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# v_eff + measurement window
# ---------------------------------------------------------------------------

def measurement_window(total_density, *, boundary_xmin: float = 0.99,
                       max_boundary_fraction: float = 0.06,
                       min_window_fraction: float = 0.10,
                       window_mode: str = "legacy",
                       xlim: float = 1.0) -> Tuple[int, int, np.ndarray]:
    """(start_idx, end_idx, frac_boundary) — host-side (python ints).

    ``xlim`` sets the physical x grid (the reference hardcodes [0, 1],
    ..._sweep_beta.py:131; ``boundary_xmin`` stays in absolute units, so pass
    e.g. ``boundary_xmin=0.99*xlim`` for the scaled equivalent)."""
    total_density = np.asarray(total_density)
    M, L = total_density.shape
    x = np.linspace(0.0, float(xlim), L)
    dx = x[1] - x[0]
    bmask = x >= boundary_xmin
    boundary_mass = total_density[:, bmask].sum(axis=1) * dx
    N_t = total_density.sum(axis=1) * dx
    frac_boundary = boundary_mass / (N_t + 1e-12)

    start = int(0.65 * M)
    unsafe = frac_boundary >= max_boundary_fraction
    min_len = max(3, int(min_window_fraction * M))
    if window_mode == "legacy":
        # The reference quirk, decoded (..._sweep_beta.py:141-153): `safe`
        # holds the INDICES of boundary-heavy frames; `safe[start:]` is
        # nonempty only when their COUNT exceeds 0.65·M, and `~index` is
        # always truthy, so the window is [0.65·M, M) unless MORE THAN
        # 65% of all frames are boundary-heavy — then it collapses to
        # min_len.  (An earlier round collapsed on ANY unsafe frame —
        # the opposite of the reference for the common drifting-front
        # case with a handful of late unsafe frames.)
        end = M if int(unsafe.sum()) <= start else min(M, start + min_len)
    elif window_mode == "strict":
        rel = np.where(unsafe[start:])[0]
        end = M if rel.size == 0 else start + int(rel[0])
        if end - start < min_len:
            end = min(M, start + min_len)
    else:
        raise ValueError(window_mode)
    return start, end, frac_boundary


def v_eff_timeseries(total_density, times, xlim: float = 1.0):
    """v_eff(t) = d⟨x⟩/dt of the normalized density center of mass."""
    total_density = np.asarray(total_density)
    M, L = total_density.shape
    x = np.linspace(0.0, float(xlim), L)
    mean_x = (total_density * x).sum(axis=1) / (
        total_density.sum(axis=1) + 1e-12)
    return np.gradient(mean_x, np.asarray(times))


def compute_v_eff_and_window(out: Dict, ps=None, *, boundary_xmin=None,
                             max_boundary_fraction=0.06,
                             min_window_fraction=0.10,
                             window_mode="legacy"):
    """Reference signature (:123): returns
    (mean_v, v_eff_ts, times, start_idx, end_idx, frac_boundary).

    The x grid spans ``ps.xlim`` (default 1.0 — the reference hardcodes
    ``linspace(0, 1, L)``, :131, correct only for xlim=1); the default
    boundary threshold is the reference's 0.99 scaled to the domain."""
    times = np.asarray(out["times_obs"])
    total = np.asarray(out["total_list"])
    xlim = float(getattr(ps, "xlim", 1.0) or 1.0) if ps is not None else 1.0
    if boundary_xmin is None:
        boundary_xmin = 0.99 * xlim
    start, end, frac_boundary = measurement_window(
        total, boundary_xmin=boundary_xmin,
        max_boundary_fraction=max_boundary_fraction,
        min_window_fraction=min_window_fraction, window_mode=window_mode,
        xlim=xlim)
    v_ts = np.asarray(v_eff_timeseries(total, times, xlim=xlim))
    mean_v = float(np.mean(v_ts[start:end]))
    return mean_v, v_ts, times, start, end, frac_boundary


# ---------------------------------------------------------------------------
# D_eff from per-particle displacements
# ---------------------------------------------------------------------------

def d_eff_from_positions(pos_frames, alive_frames, times, dx,
                         start_idx: int, end_idx: int) -> float:
    """Slope of the displacement-variance growth S(t) over the window.

    ``pos_frames`` are unwrapped positions on stable buffer slots; only
    particles alive at both the window start and frame t contribute."""
    pos_frames = np.asarray(pos_frames, dtype=float) * dx
    alive_frames = np.asarray(alive_frames, dtype=bool)
    t = np.asarray(times)
    p0 = pos_frames[start_idx]
    a0 = alive_frames[start_idx]
    S_vals, t_vals = [], []
    for k in range(start_idx + 1, end_idx):
        ok = a0 & alive_frames[k]
        n = int(ok.sum())
        if n < 2:
            continue
        r = pos_frames[k][ok] - p0[ok]
        S_vals.append(np.sum((r - r.mean()) ** 2) / (n - 1))
        t_vals.append(t[k] - t[start_idx])
    if len(S_vals) < 2:
        return float("nan")
    return float(np.polyfit(t_vals, S_vals, 1)[0])


def compute_D_eff_active(out: Dict, ps, start_idx: int, end_idx: int) -> float:
    """Reference signature (:500).  Uses the framework's stable-slot frames
    when present; falls back to index-paired pos_list otherwise."""
    times = np.asarray(out["times_obs"])
    if out.get("pos_frames") is not None:
        return d_eff_from_positions(out["pos_frames"], out["alive_frames"],
                                    times, ps.dx, start_idx, end_idx)
    pos_list = out["pos_list"]
    p0 = np.asarray(pos_list[start_idx], dtype=float) * ps.dx
    S_vals, t_vals = [], []
    for k in range(start_idx + 1, end_idx):
        pt = np.asarray(pos_list[k], dtype=float) * ps.dx
        n = min(len(p0), len(pt))
        if n < 2:
            continue
        r = pt[:n] - p0[:n]
        S_vals.append(np.sum((r - r.mean()) ** 2) / (n - 1))
        t_vals.append(times[k] - times[start_idx])
    if len(S_vals) < 2:
        return float("nan")
    return float(np.polyfit(t_vals, S_vals, 1)[0])


# ---------------------------------------------------------------------------
# magnetization / front density / blocking probability
# ---------------------------------------------------------------------------

def compute_mean_magnetization(out: Dict, start_idx: int, end_idx: int) -> float:
    m = np.asarray(out["m_global"], dtype=float)
    return float(np.mean(m[start_idx:end_idx]))


# reference-spelling alias (:316 `compute_mean_magnetizatoin`)
compute_mean_magnetizatoin = compute_mean_magnetization


def compute_rho_eff(out: Dict, start_idx: int, end_idx: int,
                    window_fraction: float = 0.05,
                    xlim: float = 1.0) -> float:
    """Front density behind the rightmost occupied site (:165-194);
    ``window_fraction`` is in absolute x units like the reference's 0.05."""
    total = np.asarray(out["total_list"])
    M, L = total.shape
    x = np.linspace(0.0, float(xlim), L)
    dx = x[1] - x[0]
    vals = []
    for k in range(start_idx, end_idx):
        rho = total[k]
        occ = np.where(rho > 0)[0]
        if occ.size == 0:
            continue
        x_max = x[occ[-1]]
        mask = (x >= x_max - window_fraction) & (x <= x_max)
        if mask.sum() == 0:
            continue
        vals.append(rho[mask].sum() * dx / window_fraction)
    return float(np.mean(vals)) if vals else float("nan")


def blocking_probability(rho_p_frames, total_frames,
                         start_idx: int, end_idx: int):
    """P(forward + move blocked) — vectorized form of (:197-229):
    Σ_t Σ_{i<L−1} ρ₊(i)·1[ρ_tot(i+1) ≥ 1] / Σ_t Σ_{i<L−1} ρ₊(i)."""
    rho_p = np.asarray(rho_p_frames)[start_idx:end_idx, :-1]
    nxt = np.asarray(total_frames)[start_idx:end_idx, 1:]
    attempts = np.sum(rho_p)
    blocked = np.sum(rho_p * (nxt >= 1.0))
    return blocked / attempts if attempts > 0 else 0.0


def compute_blocking_probability(out: Dict, start_idx: int,
                                 end_idx: int) -> float:
    return float(blocking_probability(out["rho_p_list"], out["total_list"],
                                      start_idx, end_idx))
