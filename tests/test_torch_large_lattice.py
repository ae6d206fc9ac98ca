"""The port's large-lattice driver (``experiments/large_lattice.py``) on the
CPU, against the JAX package's ``experiments/run_large_lattice.py``.

- ``python -m hydrolim_tpu_torch large-lattice --small`` (L = 4096, 300 PDE
  steps) through the launcher: the driver's own asserts (exact particle
  conservation, |m| against the tanh fixed point, PDE mass to 1e-4, dm/dt
  within 15% of the CW law) pass, and ``wall_time.json`` holds the JAX
  driver's record keys.
- Its PDE half against the JAX driver's loop (``pde_step`` with the banded
  solve, ``magnetization`` and the mass every ``rec_every`` steps) from the
  same ρ₀, at the driver's --small grid.  The tolerance is the JAX
  package's own spread, measured here: the same run with its exact ('fft')
  solve in place of the banded one.
- The driver's halves with the lattice split over a 'space' mesh, and
  ``--n-devices``/``--grid`` past the host's devices, are held in
  ``tests/test_torch_spatial.py``.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import __main__ as launcher
from hydrolim_tpu_torch.experiments import large_lattice as ll

L = 4096


@pytest.fixture(autouse=True)
def _argv(monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))


def test_small_through_the_launcher_passes_its_asserts(tmp_path):
    assert launcher.main(["large-lattice", "--small", "--device", "cpu",
                          "--outdir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "wall_time.json").read_text())
    assert (rec["L"], rec["N"], rec["n_devices"]) == (L, L // 2, 1)
    part = rec["particle"]
    assert part["steps"] == 532
    assert part["m_sub"] < 0.1
    assert abs(part["m_super"] - part["m_theory"]) < 0.05
    assert part["us_per_step"] == pytest.approx(
        1e6 * part["wall_s"] / part["steps"])
    assert rec["pde"]["steps"] == 600
    for r in rec["pde"]["rates"].values():
        assert abs(r["measured"] - r["theory"]) < 0.15 * abs(r["theory"]) \
            + 1e-3
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert (tmp_path / "large_lattice_overview.png").stat().st_size > 10_000


def _jax_pde(beta, rho0, config, gamma, rec_every, solver):
    """The JAX driver's PDE loop (``run_large_lattice.py:151-199``) on one
    device, with ``diffusion_solver=solver``."""
    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.pde.stepper import build_pde_ops, magnetization
    from hydrolim_tpu.pde.stepper import pde_step

    pcfg = PDEConfig(L=config.L, T=config.T, dt=config.dt, bc="periodic",
                     gaussian_kernel=False, diffusion_solver=solver,
                     snapshot_interval=config.snapshot_interval,
                     n_tracers=1)
    pp = make_pde_params(gamma=gamma, lam=ll.LAM, beta=float(beta))
    ops = build_pde_ops(pcfg, pp)

    @jax.jit
    def advance(rp, rm):
        def body(c, _):
            return pde_step(pcfg, pp, ops, c[0], c[1]), ()

        def outer(c, _):
            c, _ = jax.lax.scan(body, c, None, length=rec_every)
            return c, (jnp.mean(magnetization(pcfg, ops, c[0], c[1])),
                       jnp.sum(c[0] + c[1]))

        (rp, rm), (m_t, mass_t) = jax.lax.scan(
            outer, (rp, rm), None, length=config.nsteps // rec_every)
        return rp + rm, m_t, mass_t

    rho, m_t, mass_t = advance(jnp.asarray(1.2 * rho0[0], jnp.float32),
                               jnp.asarray(0.8 * rho0[1], jnp.float32))
    return np.asarray(m_t), np.asarray(mass_t), np.asarray(rho)


@pytest.mark.parametrize("bi", [0, 1])
def test_pde_half_agrees_with_the_jax_driver(bi):
    """m(t), the mass and the final density from the same ρ₀ agree with the
    JAX driver's within the JAX package's banded-vs-exact spread."""
    torch.set_num_threads(1)
    config, gamma, rec_every = ll.pde_grid(L, small=True)
    beta = ll.BETAS[bi]
    rho0 = ll.pde_rho0(L, 0, bi)
    m_p, mass_p, rho_p = ll.pde_run(config, gamma, beta, rec_every, rho0,
                                    "cpu")
    m_j, mass_j, rho_j = _jax_pde(beta, rho0, config, gamma, rec_every,
                                  "banded")
    m_f, _, rho_f = _jax_pde(beta, rho0, config, gamma, rec_every, "fft")
    spread_m = np.abs(m_j - m_f).max()
    spread_rho = np.abs(rho_j - rho_f).max()
    assert 0 < spread_m < 1e-4 and 0 < spread_rho < 1e-4
    assert m_p.shape == m_j.shape == (100,)
    assert np.abs(m_p - m_j).max() <= spread_m
    assert np.abs(rho_p - rho_j).max() <= spread_rho
    np.testing.assert_allclose(mass_p, mass_j, rtol=1e-5)
