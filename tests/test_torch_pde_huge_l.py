"""The port's PDE entry points at L = 262,144 against the JAX XLA path, on
the CPU.

Past a cluster's shared memory kernel B2 runs its device-memory route
(``ops/pde_kernel.gmem_launch_plan``: the fields in device memory, G
co-resident CTAs a replica); here, on CPU tensors, the same entry points
run its plain version, which the card's tests hold both routes to.  At
L = 262,144 the JAX auto solver takes the banded solve on a periodic
lattice and ``banded_dct`` on a Neumann one; the port maps ``banded_dct``
to the exact solve, which its plain version applies by a float64 FFT.

The lattices follow the large-lattice driver's recipe (dt = 0.5·dx/λ,
γ = 2.5·dx²/dt), 20 steps from the JAX path's own initial states, at the
tolerances of ``test_torch_pde_large_l.py`` (fields rtol 2e-4 / atol
1e-7, m rtol 1e-4 / atol 1e-6, Var rtol 1e-3).  The narrow smoothing's σ
keeps its radius under the kernel's 63 taps (σ·L = 8.2 sites, r = 33);
σ = 0.05 (13,107 sites) is the full smoothing, which the card runs on its
device-memory route's FFT stage and the plain version by a float64 FFT;
the JAX XLA path convolves it by its native FFT (``HYDROLIM_FFT_MODE``
'native': its default 'matmul' mode would build the L×L circulant).
The tracers' draws differ between the packages, so v_eff and D_eff are
held to their NaN warm-up and finite values after it.
"""
import jax
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import PDEConfig as JPDEConfig
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step

L, LAM, STEPS, N_T = 262_144, 0.6, 20, 16
DX = 1.0 / L
DT = 0.5 * DX / LAM
GAMMA = 2.5 * DX * DX / DT
BETAS = [0.5, 2.5]
SIGMA = 5e-4 * 16_384 / L


def _config_kw(**over):
    kw = dict(L=L, T=STEPS * DT, dt=DT, snapshot_interval=10, fft_kmax=8,
              tracer_window_time=5 * DT * (1 + 1e-9))
    kw.update(over)
    return kw


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("over", [
    dict(),                                                 # pointwise
    dict(gaussian_kernel=True, kernel_sigma=SIGMA),         # narrow, r=33
    dict(gaussian_kernel=True, kernel_sigma=0.05),          # smooth
], ids=["pointwise", "narrow", "smooth"])
def test_run_pde_ensemble_matches_jax_at_262144(over, monkeypatch):
    """``run_pde_ensemble`` on ``device="cpu"`` (kernel B2's plain
    version, the banded solve) from the JAX ensemble's initial states
    against ``run_pde_ensemble(engine='xla')``: the final fields, the
    snapshots, m, Var and the 8 spectral bins at every step."""
    from hydrolim_tpu.ops import dft
    from hydrolim_tpu.pde.init import pde_initialize as j_init
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble as j_run

    from hydrolim_tpu_torch.pde import fast_solve as pfs
    from hydrolim_tpu_torch.sweeps import pde_sweeps as psw

    jcfg, cfg = JPDEConfig(**_config_kw(**over)), PDEConfig(**_config_kw(
        **over))
    assert jcfg.solver_kind == cfg.solver_kind == "banded"
    m_mode, solve_mode, smooth, _ = pfs.kernel_operands(cfg, GAMMA, "cpu")
    want = ("pointwise" if not over else
            "smooth" if over["kernel_sigma"] == 0.05 else "narrow")
    assert (m_mode, solve_mode) == (want, "banded")
    if m_mode == "narrow":
        assert smooth.radius <= 63
    if m_mode == "smooth":      # the XLA path's FFT, not its L×L circulant
        monkeypatch.setattr(dft, "_FFT_MODE", "native")
    kw = dict(gamma=GAMMA, lam=LAM, n_runs=1, seed=5, n_tracers=N_T)
    jres, _ = j_run(jcfg, BETAS, engine="xla", **kw)

    keys = jax.random.split(jax.random.PRNGKey(5), len(BETAS))
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
    assert not np.array_equal(pres.rho_p, np.asarray(rp))


def test_imexpde_neumann_matches_jax_banded_dct_at_262144(tmp_path):
    """The ``IMEXPDE`` facade on a Neumann lattice (pointwise m, the
    port's exact solve: its plain version's float64 FFT) from the JAX
    facade's initial state against the JAX facade's XLA solve
    (``banded_dct``): the fields, snapshots and records."""
    from hydrolim_tpu.pde.system import IMEXPDE as JIMEXPDE

    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands
    from hydrolim_tpu_torch.pde.system import IMEXPDE

    kw = dict(L=L, T=STEPS * DT, dt=DT, gamma=GAMMA, lam=LAM, beta=2.5,
              bc="neumann", snapshot_interval=10, fft_kmax=8, seed=13)
    js = JIMEXPDE(outdir=str(tmp_path / "j"), **kw)
    js.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=N_T)
    assert js.config.solver_kind == "banded_dct"
    rho0 = np.asarray(js.rho_p)
    js.solve()
    jout = js.get_output()
    ps = IMEXPDE(outdir=str(tmp_path / "p"), device="cpu", **kw)
    ps.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=N_T)
    ps.rho_p, ps.rho_m, ps.tracers = interop.imexpde_state(js, device="cpu")
    assert kernel_operands(ps.config, GAMMA, "cpu")[:2] == ("pointwise",
                                                            "exact")
    ps.solve()
    pout = ps.get_output()
    for k in ("rho_p", "rho_m", "snapshots", "m_snapshots"):
        _close(pout[k], jout[k], k)
    np.testing.assert_allclose(pout["m_series"], jout["m_series"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pout["var_series"], jout["var_series"],
                               rtol=1e-3, atol=1e-12)
    assert not np.array_equal(pout["rho_p"], rho0)
