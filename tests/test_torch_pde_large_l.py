"""The port's PDE entry points at L = 16,384 against the JAX XLA path, on
the CPU.

Past one CTA's shared memory kernel B2 runs on a cluster of CTAs per
replica (``ops/pde_kernel.pde_launch_plan``); here, on CPU tensors, the
same entry points run its plain version, which the card's tests hold the
kernel to.  At L = 16,384 the JAX auto solver takes the banded solve on a
periodic lattice and ``banded_dct`` on a Neumann one (its "large-L scale
path", ``hydrolim_tpu/core/config.py``); the port maps ``banded_dct`` to
the exact solve (``pde/fast_solve.py``), which its plain version applies by
a float64 FFT past ``DENSE_MAX_L`` (``ops/diffusion.spectral_solve``).

The lattices follow the large-lattice driver's recipe (dt = 0.5·dx/λ,
γ = 2.5·dx²/dt: the banded inverse's 97 taps), 50 steps from the JAX
path's own initial states.  The fields do not depend on the tracers, so
the fields, the m and Var records and the spectra agree over every step:
- periodic, banded (pointwise and narrow m): to float32 roundoff, the
  tolerances of ``test_torch_pde_modes.py`` (fields rtol 2e-4 / atol 1e-7,
  m rtol 1e-4 / atol 1e-6, Var rtol 1e-3);
- Neumann (narrow m): the port's exact solve against JAX's ``banded_dct``,
  whose taps are cut where they fall below 1e-9 of the centre.  The test
  measures the two solves' difference on the initial fields (one solve of
  each: 1.66e-7 of the fields' scale, float32 roundoff, the truncation
  itself below it), holds it under 1e-6, and holds the 50-step fields to
  the tolerances above.
The tracers' draws differ between the packages (``pde/fast_solve.py``), so
v_eff and D_eff are held to their NaN warm-up and finite values after it.
"""
import jax
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import PDEConfig as JPDEConfig
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step

L, LAM, STEPS, N_T = 16_384, 0.6, 50, 16
DX = 1.0 / L
DT = 0.5 * DX / LAM
GAMMA = 2.5 * DX * DX / DT
BETAS = [0.5, 2.5]


def _config_kw(**over):
    kw = dict(L=L, T=STEPS * DT, dt=DT, snapshot_interval=25, fft_kmax=8,
              tracer_window_time=10 * DT * (1 + 1e-9))
    kw.update(over)
    return kw


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("over", [
    dict(),                                                 # pointwise
    dict(gaussian_kernel=True, kernel_sigma=5e-4),          # narrow, r=48
], ids=["pointwise", "narrow"])
def test_run_pde_ensemble_matches_jax_at_16384(over, monkeypatch):
    """``run_pde_ensemble`` on ``device="cpu"`` (kernel B2's plain
    version, the banded solve) from the JAX ensemble's initial states
    against ``run_pde_ensemble(engine='xla')``: the final fields, the
    snapshots, m, Var and the 8 spectral bins at every step."""
    from hydrolim_tpu.pde.init import pde_initialize as j_init
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble as j_run

    from hydrolim_tpu_torch.pde import fast_solve as pfs
    from hydrolim_tpu_torch.sweeps import pde_sweeps as psw

    jcfg, cfg = JPDEConfig(**_config_kw(**over)), PDEConfig(**_config_kw(
        **over))
    assert jcfg.solver_kind == cfg.solver_kind == "banded"
    m_mode, solve_mode, _, _ = pfs.kernel_operands(cfg, GAMMA, "cpu")
    assert (m_mode, solve_mode) == (
        "narrow" if over else "pointwise", "banded")
    kw = dict(gamma=GAMMA, lam=LAM, n_runs=1, seed=3, n_tracers=N_T)
    jres, _ = j_run(jcfg, BETAS, engine="xla", **kw)

    keys = jax.random.split(jax.random.PRNGKey(3), len(BETAS))
    rp, rm, tr = jax.vmap(lambda k: j_init(
        jcfg, k, mode="homogeneous", rho0=1.0, noise=0.3,
        n_tracers=N_T))(keys)
    state = (interop.to_torch(np.asarray(rp), torch.float32, "cpu"),
             interop.to_torch(np.asarray(rm), torch.float32, "cpu"),
             interop.tracer_state(jax.device_get(tr), "cpu"))
    monkeypatch.setattr(psw, "pde_initialize", lambda *a, **k: state)
    n0 = pde_multi_step.launches
    pres, beta = psw.run_pde_ensemble(cfg, BETAS, device="cpu", **kw)
    assert pde_multi_step.launches == n0         # the plain version ran
    np.testing.assert_array_equal(beta, np.float32(BETAS))

    _close(pres.rho_p, jres.rho_p, "rho_p")
    _close(pres.rho_m, jres.rho_m, "rho_m")
    _close(pres.snapshots, jres.snapshots, "snapshots")
    rec, jrec = pres.records, jres.records
    assert rec.m_mean.shape == (len(BETAS), STEPS + 1)
    np.testing.assert_allclose(rec.m_mean, jrec.m_mean, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(rec.var, jrec.var, rtol=1e-3, atol=1e-12)
    np.testing.assert_allclose(rec.fft_ri, jrec.fft_ri, rtol=2e-4,
                               atol=1e-7)
    W = cfg.tracer_window
    for f in (rec.v_eff, rec.D_eff):
        assert np.isnan(f[:, :W]).all() and np.isfinite(f[:, W:]).all()
    # the fields moved: β = 2.5 grows |m| from its seed
    assert not np.array_equal(pres.rho_p, np.asarray(rp))


def test_imexpde_neumann_matches_jax_banded_dct_at_16384(tmp_path):
    """The ``IMEXPDE`` facade on a Neumann lattice (narrow m, the port's
    exact solve: its plain version's float64 FFT) from the JAX facade's
    initial state against the JAX facade's XLA solve (``banded_dct``).
    The truncation of JAX's taps, measured on the initial fields, is far
    below the fields' tolerance; the fields and records then agree."""
    import jax.numpy as jnp
    from hydrolim_tpu.ops.diffusion import build_diffusion_op as j_op
    from hydrolim_tpu.ops.diffusion import diffusion_solve as j_solve
    from hydrolim_tpu.pde.system import IMEXPDE as JIMEXPDE

    from hydrolim_tpu_torch.ops.diffusion import (
        diffusion_solve,
        spectral_solve,
    )
    from hydrolim_tpu_torch.pde.system import IMEXPDE

    kw = dict(L=L, T=STEPS * DT, dt=DT, gamma=GAMMA, lam=LAM, beta=2.5,
              bc="neumann", gaussian_kernel=True, kernel_sigma=5e-4,
              snapshot_interval=25, seed=11)
    js = JIMEXPDE(outdir=str(tmp_path / "j"), **kw)
    js.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=N_T)
    assert js.config.solver_kind == "banded_dct"
    rho0 = np.asarray(js.rho_p)

    # the truncation of the banded taps: one solve of each on rho_p(0)
    banded = np.asarray(j_solve(
        j_op(L, DX, DT, GAMMA, "neumann", "banded_dct"), jnp.asarray(rho0),
        "banded_dct"))
    exact = diffusion_solve(spectral_solve(L, DX, DT, GAMMA, "neumann",
                                           "cpu"),
                            torch.tensor(rho0), "spectral").numpy()
    trunc = float(np.abs(banded - exact).max() / np.abs(exact).max())
    assert trunc < 1e-6, trunc            # 1.66e-7: float32 roundoff

    js.solve()
    jout = js.get_output()
    ps = IMEXPDE(outdir=str(tmp_path / "p"), device="cpu", **kw)
    ps.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=N_T)
    ps.rho_p, ps.rho_m, ps.tracers = interop.imexpde_state(js, device="cpu")
    ps.solve()
    pout = ps.get_output()
    assert ps.config.solver_kind == "banded_dct"
    for k in ("rho_p", "rho_m", "snapshots", "m_snapshots"):
        _close(pout[k], jout[k], k)
    np.testing.assert_allclose(pout["m_series"], jout["m_series"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pout["var_series"], jout["var_series"],
                               rtol=1e-3, atol=1e-12)
    assert not np.array_equal(pout["rho_p"], rho0)
