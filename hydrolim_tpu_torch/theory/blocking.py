"""Exclusion/blocking theory: occupancy-tail probabilities and the v_eff /
D_eff prediction family (`..._sweep_beta.py:281-314, 528-560`).

The exclusion-correction constants C0/C1/C2 are the fit outputs of the (N,β)
double sweep (`..._sweep_beta.py:549-551`, `fit_over_real_data.py:117`,
BASELINE.md) and are frozen here as the framework's reference constants.

A copy of the JAX package's ``theory/blocking.py`` (numpy/scipy only): the
port cannot import it without importing ``jax``.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import nbinom, poisson

from hydrolim_tpu_torch.theory.meanfield import compute_m_of_beta_non

# frozen exclusion-fit constants (BASELINE.md)
C0 = 1.2552899764748897
C1 = 0.6022927624714487
C2 = 0.15327283599951863


def phi_poisson(rho_bar, K):
    """P(site occupancy ≥ K) under a Poisson site law with μ = ρ̄/K
    (:281-283)."""
    mu = np.asarray(rho_bar, dtype=float) / K
    return 1.0 - poisson.cdf(K - 1, mu)


def phi_nb(rho_bar, K, r_disp):
    """Negative-binomial tail with mean μ = ρ̄/K and dispersion r
    (:285-290)."""
    r = float(r_disp)
    mu = float(rho_bar) / K
    p = r / (r + mu)
    return 1.0 - float(nbinom.cdf(K - 1, r, p))


def v_pred_from_phi(phi_values, lambda_eff, m_beta, beta_values=None):
    """v = λ_eff · p₊ · (1 − Φ) with p₊ = (1+m_β)/2 (:292-294)."""
    p_plus = 0.5 * (1.0 + np.asarray(m_beta, dtype=float))
    return lambda_eff * p_plus * (1.0 - np.asarray(phi_values, dtype=float))


def v_pred_TASEP(lambda_eff, rho_bar, K, m_beta):
    """TASEP exclusion factor (1 − ρ̄/K) (:296-298)."""
    p_plus = 0.5 * (1.0 + np.asarray(m_beta, dtype=float))
    return lambda_eff * p_plus * (1.0 - rho_bar / K)


def v_pred_new_theory(lambda_eff, rho_bar, K, beta, m_beta, m_beta_non,
                      gamma_eff, q=1):
    """Cosh-corrected exclusion curve (:300-301)."""
    beta = np.asarray(beta, dtype=float)
    ch = np.cosh(beta * np.asarray(m_beta_non, dtype=float))
    return (lambda_eff * (1.0 - rho_bar / K)
            * 0.5 * (1.0 + np.asarray(m_beta, dtype=float))
            * (1.0 - 0.25 / ch + 0.1 / ch ** 2))


def v_pred_without_phi(lambda_eff, m_beta, beta_values=None):
    """Non-exclusion v = λ_eff·(1+m_β)/2 (:306-307)."""
    return lambda_eff * 0.5 * (1.0 + np.asarray(m_beta, dtype=float))


def v_pred_block(lambda_eff, m_beta_dense, beta_dense, rho_bar, K):
    """Blocking-corrected curve (:309-311)."""
    beta_dense = np.asarray(beta_dense, dtype=float)
    m_non = compute_m_of_beta_non(beta_dense, rho_bar, K, lambda_eff)
    return (lambda_eff * 0.5 * (1.0 + np.asarray(m_beta_dense, dtype=float))
            * (1.0 - rho_bar / K * (1.37 + 4.0 / np.cosh(beta_dense * m_non))))


def v_eff_fit(rho_bar, k, beta, lambda_eff, m_beta=None, m_beta_non=None):
    """Fitted exclusion curve with the frozen C0/C1/C2 constants (:313-314;
    the sweep variant subtracts 0.1 from C0 and adds 0.01 to C2 — this is
    the `fit_over_real_data.py:116-118` canonical form when ``m_beta`` is
    omitted, and the sweep form when both magnetizations are supplied)."""
    beta = np.asarray(beta, dtype=float)
    rho = np.asarray(rho_bar, dtype=float)
    if m_beta is None:
        m_beta = compute_m_of_beta_non(beta)
        m_beta_non = m_beta
        c0, c2 = C0, C2
    else:
        c0, c2 = C0 - 0.1, C2 + 0.01
    m_beta = np.asarray(m_beta, dtype=float)
    m_beta_non = np.asarray(m_beta_non, dtype=float)
    x = rho / k
    return (lambda_eff * 0.5 * (1.0 + np.tanh(beta * m_beta))
            * (1.0 - x * ((c0 - C1 * x)
                          + c2 / (x ** 1.5) / np.cosh(beta * m_beta_non))))


def p_block_prediction(beta_dense, rho_bar, K):
    """Blocking-probability prediction curve as plotted at
    `..._sweep_beta.py:465` (its own C0−0.18 / C2+0.019 offsets)."""
    beta_dense = np.asarray(beta_dense, dtype=float)
    m_non = compute_m_of_beta_non(beta_dense)
    x = rho_bar / K
    return x * ((C0 - 0.18 - C1 * x)
                + (C2 + 0.019) / (x ** 1.5) / np.cosh(beta_dense * m_non))


# ---------------------------------------------------------------------------
# D_eff prediction family — the canonical v1 copy
# (PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:528-560).  The _2 file
# carries divergent variants (a /2 in global/theory, a different theory_4);
# the v1 forms are the ones the β-sweep figures plot.  Pinned numerically
# by tests/test_theory_pins.py.
# ---------------------------------------------------------------------------

def D_eff_global(beta, m_beta, gamma_eff, lambda_eff):
    beta = np.asarray(beta, dtype=float)
    return gamma_eff + lambda_eff ** 2 / np.cosh(beta * m_beta) ** 3


def D_eff_local(beta, m_beta, gamma_eff, lambda_eff):
    return (gamma_eff + lambda_eff ** 2) * np.ones_like(
        np.asarray(beta, dtype=float))


def D_eff_theory(beta, m_beta, gamma_eff, lambda_eff, m_beta_non, rho_bar, K):
    beta = np.asarray(beta, dtype=float)
    return gamma_eff + lambda_eff ** 2 * (1.0 - rho_bar / K) / \
        np.cosh(beta * m_beta_non) ** 3


def D_eff_theory_2(beta, m_beta, gamma_eff, lambda_eff, m_beta_non, rho_bar, K):
    beta = np.asarray(beta, dtype=float)
    x = 1.0 - rho_bar / K
    return gamma_eff + lambda_eff ** 2 * x * abs(x) / \
        np.cosh(beta * m_beta_non) ** 3


def D_eff_theory_3(beta, m_beta, gamma_eff, lambda_eff, m_beta_non, rho_bar, K):
    beta = np.asarray(beta, dtype=float)
    ch = np.cosh(beta * m_beta_non)
    sh = np.sinh(beta * m_beta_non)
    x = rho_bar / K
    return (gamma_eff
            + lambda_eff ** 2 * (1 - x) * np.abs(1 - 2 * x) / ch
            - lambda_eff ** 2 * (1 - x) ** 2 * sh ** 2 / ch ** 3)


def D_eff_theory_4(beta, m_beta, gamma_eff, lambda_eff, m_beta_non, rho_bar, K):
    beta = np.asarray(beta, dtype=float)
    ch = np.cosh(beta * m_beta_non)
    x = rho_bar / K
    return gamma_eff + lambda_eff ** 2 * (1 - x) / ch * (
        np.abs(1 - 2 * x) + x / ch ** 2)


def f_exclusion(beta, m_beta, rho_bar, K):
    """f-correction with frozen constants (:548-553)."""
    beta = np.asarray(beta, dtype=float)
    x = rho_bar / K
    return x * (C0 - C1 * x + C2 / (x ** 1.5 * np.cosh(beta * m_beta)))


def h_exclusion(A, beta, m_beta):
    return A / np.cosh(np.asarray(beta, dtype=float) * m_beta)


def fit_D_eff(beta, m_beta, rho_bar, K, gamma_eff, lambda_eff, A=2.5):
    """Composite D_eff fit (:558-560)."""
    beta = np.asarray(beta, dtype=float)
    return gamma_eff + lambda_eff ** 2 / np.cosh(beta * m_beta) ** 3 * (
        1.0 - f_exclusion(beta, m_beta, rho_bar, K)) ** 2 * \
        h_exclusion(A, beta, m_beta)
