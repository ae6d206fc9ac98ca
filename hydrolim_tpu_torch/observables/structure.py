"""Structure-factor / pattern-formation observables.

Re-implementations of the local-structure analysis layer
(PARTICLE_solver_BIOLOGY_local_structure.py):

- ``extract_structure_observables`` (:55-103): steady-state variance, mean
  FFT spectrum ± std, dominant mode k*, low-k power, local-magnetization
  variance, low-k variance,
- pattern metrics (:195-264): time-to-pattern, cluster-size distribution,
  temporal autocorrelation, low-k variance time series, spectral entropy,
  mode-competition ratio, log-linear growth-rate fit of |A_k(t)|.

All take reference-schema ``out`` dicts (or raw arrays) on host.  A copy
of the JAX package's ``observables/structure.py`` (numpy only; the port
does not import that package).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


#: steady-state window convention shared by every metric below: statistics
#: are taken over frames [start_fraction·T, T).  The k-space cuts follow the
#: reference's k_cut = 25 with the k = 0 (mean-density) bin excluded.
_K_CUT = 25


def structure_observables(var_ts: np.ndarray, fft_amp: np.ndarray,
                          m_local: np.ndarray, *, start: int,
                          k_cut: int = _K_CUT) -> Dict:
    """Array-first core of the structure-observable extraction (observable
    DEFINITIONS per PARTICLE_solver_BIOLOGY_local_structure.py:55-103; the
    values are the correctness spec, pinned by
    tests/test_aux.py::test_structure_observables_golden):

    - density-variance mean/std over the steady-state window,
    - mean spectrum ± std (per k), dominant mode k* = argmax over k ≥ 1,
    - low-k power Σ_{1≤k<k_cut} ⟨|A_k|⟩ and the windowed mean of the
      per-frame low-k energy Σ |A_k|²,
    - local-magnetization variance over the window.
    """
    win = slice(start, None)
    spec = np.asarray(fft_amp, float)[win]
    fft_mean = spec.mean(axis=0)
    fft_std = spec.std(axis=0, ddof=1)
    var_win = np.asarray(var_ts, float)[win]
    cut_mean = min(k_cut, fft_mean.shape[0])
    cut_frame = min(k_cut, spec.shape[1])
    return {
        "var_mean": float(var_win.mean()),
        "var_std": float(var_win.std(ddof=1)),
        "fft_mean": fft_mean,
        "fft_std": fft_std,
        "dominant_k": int(np.argmax(fft_mean[1:]) + 1),
        "low_k_power": float(fft_mean[1:cut_mean].sum()),
        "m_local_var": float(np.var(np.asarray(m_local, float)[win])),
        "lowk_variance": float(
            (spec[:, 1:cut_frame] ** 2).sum(axis=1).mean()),
    }


def extract_structure_observables_from_out(out: Dict,
                                           start_fraction: float = 0.5,
                                           k_max: Optional[int] = None) -> Dict:
    """Reference-schema ``out``-dict adapter over
    :func:`structure_observables`."""
    T = len(out["times_obs"])
    fft_amp = np.asarray(out["fft_amp_list"], dtype=float)
    if k_max is not None:
        fft_amp = fft_amp[:, :k_max]
    return structure_observables(
        np.asarray(out["var_list"], dtype=float), fft_amp,
        np.asarray(out["m_local_list"], dtype=float),
        start=int(start_fraction * T))


def time_to_pattern(out: Dict, threshold: float = 0.05, k: int = 1) -> float:
    """First time |A_k(t)| exceeds threshold (:195-202)."""
    amps = np.asarray(out["fft_amp_list"])[:, k]
    times = np.asarray(out["times_obs"])
    hits = np.where(amps > threshold)[0]
    return float(times[hits[0]]) if hits.size else float("nan")


def ensemble_time_to_pattern(raw_outs, k: int = 1, threshold: float = 0.05):
    times = [t for out in raw_outs
             if not np.isnan(t := time_to_pattern(out, threshold, k))]
    if not times:
        return float("nan"), float("nan")
    return float(np.mean(times)), float(np.std(times) / np.sqrt(len(times)))


def cluster_size_distribution(rho: np.ndarray, threshold: float) -> np.ndarray:
    """Run lengths of above-threshold stretches (:210-222), vectorized."""
    occ = np.asarray(rho) > threshold
    if not occ.any():
        return np.array([], dtype=int)
    padded = np.concatenate([[False], occ, [False]])
    d = np.diff(padded.astype(int))
    starts = np.where(d == 1)[0]
    ends = np.where(d == -1)[0]
    return ends - starts


def temporal_autocorrelation(out: Dict, lag: int = 1) -> float:
    total = np.asarray(out["total_list"])
    if len(total) <= lag:
        return float("nan")
    return float(np.mean(total[:-lag] * total[lag:]))


def lowk_variance_time(out: Dict, k_cut: int = 25) -> np.ndarray:
    fft_amp = np.asarray(out["fft_amp_list"])
    return np.sum(fft_amp[:, 1:k_cut + 1] ** 2, axis=1)


def spectral_entropy(fft_mean: np.ndarray, k_max: Optional[int] = None) -> float:
    if k_max is not None:
        fft_mean = fft_mean[:k_max]
    power = np.asarray(fft_mean[1:]) ** 2
    p = power / np.sum(power)
    return float(-np.sum(p * np.log(p + 1e-12)))


def mode_competition_ratio(fft_mean: np.ndarray) -> float:
    amps = np.asarray(fft_mean[1:])
    k_star = int(np.argmax(amps))
    return float(amps[k_star] / (np.sum(amps) - amps[k_star] + 1e-12))


def extract_growth_rate(out: Dict, k: int = 1, t_min: float = 0.0,
                        t_max: Optional[float] = None,
                        amp_min: float = 1e-4) -> float:
    """Log-linear fit of |A_k(t)| growth (:246-264)."""
    times = np.asarray(out["times_obs"])
    amps = np.asarray(out["fft_amp_list"])[:, k]
    mask = times >= t_min
    if t_max is not None:
        mask &= times <= t_max
    mask &= amps > amp_min
    if mask.sum() < 3:
        return float("nan")
    return float(np.polyfit(times[mask], np.log(amps[mask]), 1)[0])
