"""Mean-field (Curie–Weiss) theory curves (numpy only).

- spontaneous magnetization m_β solving m = tanh(βm),
- v = λ·tanh(β·m_β),
- D = γ + λ²/(2·cosh³(β·m_β)).

A copy of the JAX package's ``theory/meanfield.py``: the port cannot import
it without importing ``jax``.
"""
from __future__ import annotations

import numpy as np


def m_fixed_point(beta_values, *, tol: float = 1e-14,
                  scale: float = 1.0) -> np.ndarray:
    """Largest solution of m = tanh(βm) per β (0 for β ≤ 1), by bisection
    on g(m) = tanh(βm) − m over (0, 1]."""
    beta = np.atleast_1d(np.asarray(beta_values, dtype=float))
    m = np.zeros_like(beta)
    sup = beta > 1.0
    if sup.any():
        b = beta[sup]
        lo = np.full_like(b, 1e-12)
        hi = np.ones_like(b)
        for _ in range(80):  # 2^-80 ≪ tol
            mid = 0.5 * (lo + hi)
            g = np.tanh(b * mid) - mid
            lo = np.where(g > 0, mid, lo)
            hi = np.where(g > 0, hi, mid)
        m[sup] = 0.5 * (lo + hi)
    out = scale * m
    return out if np.ndim(beta_values) else float(out[0])


def compute_m_of_beta(beta_values, rho_bar=None, K=None, lambda_eff=None,
                      *, scale: float = 1.0) -> np.ndarray:
    """Reference-signature wrapper (the extra arguments are unused)."""
    return np.atleast_1d(m_fixed_point(beta_values, scale=scale))


def v_theory(beta_values, lam: float) -> np.ndarray:
    """Non-exclusion effective velocity λ·tanh(β·m_β)."""
    beta = np.asarray(beta_values, dtype=float)
    m = compute_m_of_beta(beta)
    return lam * np.tanh(beta * m)


def D_theory(beta_values, gamma: float, lam: float) -> np.ndarray:
    """Non-exclusion effective diffusivity γ + λ²/(2·cosh³(β·m_β))."""
    beta = np.asarray(beta_values, dtype=float)
    m = compute_m_of_beta(beta)
    return gamma + lam ** 2 / (2.0 * np.cosh(beta * m) ** 3)


# identical twin in the reference (`..._sweep_beta.py:256-278`)
compute_m_of_beta_non = compute_m_of_beta
