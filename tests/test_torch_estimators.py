"""The port's host estimators (``observables/estimators.py``, NumPy)
against the JAX package's module on the same NumPy inputs made from a
seed, to 1e-6, mirroring ``tests/test_estimators.py`` (the legacy and
strict measurement windows included); the device estimators
(``observables/batched.py``) against the host ones on the same frames, as
JAX's ``test_batched_matches_host``; and ``estimator='host'`` on the
β-sweep drivers.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu.observables import estimators as jest
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.observables import estimators as est
from hydrolim_tpu_torch.observables.batched import batched_estimates
from hydrolim_tpu_torch.sweeps.beta_sweep import (
    sweep_beta_ensemble,
    sweep_over_betas,
)
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    frames_to_out,
    run_particle_ensemble,
)

CPU = "cpu"
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drifting(M=40, L=50, v=0.01, xlim=1.0):
    """A Gaussian density bump drifting right (``test_estimators.py``)."""
    times = np.arange(M) * 0.5
    x = np.linspace(0, xlim, L)
    total = np.stack([np.exp(-0.5 * ((x / xlim - 0.2 - v * t) / 0.05) ** 2)
                      for t in times])
    total /= total.sum(axis=1, keepdims=True) * (x[1] - x[0])
    return {"times_obs": times, "total_list": total}


def _random_out(seed, M=30, L=40, n=60):
    """A random out dict: densities, m, stable-slot positions with exits."""
    rng = np.random.default_rng(seed)
    total = rng.gamma(2.0, 1.0, (M, L)).astype(np.float32)
    total[:, rng.random(L) < 0.2] = 0.0
    rho_p = (total * rng.random((M, L))).astype(np.float32)
    pos = np.cumsum(rng.integers(-2, 3, (M, n)), axis=0) + rng.integers(
        0, L, n)
    alive = np.ones((M, n), bool)
    alive[M // 2:, : n // 6] = False                      # exits
    return {"times_obs": np.arange(M) * 0.25, "total_list": total,
            "rho_p_list": rho_p, "m_global": rng.uniform(-1, 1, M),
            "pos_frames": pos.astype(np.int32), "alive_frames": alive,
            "pos_list": [p[a] for p, a in zip(pos, alive)]}


class _PS:
    def __init__(self, dx, xlim=1.0):
        self.dx, self.xlim = dx, xlim


@pytest.mark.parametrize("mode", ["legacy", "strict"])
@pytest.mark.parametrize("case", ["drift-late", "parked-on-boundary",
                                  "random"])
def test_measurement_window_equals_jax(mode, case):
    if case == "drift-late":
        total = _drifting(v=0.05)["total_list"]
    elif case == "parked-on-boundary":
        x = np.linspace(0, 1, 50)
        bump = np.exp(-0.5 * ((x - 0.995) / 0.02) ** 2)
        total = np.tile(bump, (40, 1))
    else:
        total = _random_out(1)["total_list"]
    s, e, frac = est.measurement_window(total, window_mode=mode)
    js, je, jfrac = jest.measurement_window(total, window_mode=mode)
    assert (s, e) == (js, je)
    np.testing.assert_allclose(frac, jfrac, **TOL)
    with pytest.raises(ValueError):
        est.measurement_window(total, window_mode="other")


def test_legacy_and_strict_windows_as_the_jax_tests_pin_them():
    """``test_window_legacy_vs_strict``'s pins on the port's module."""
    total = _drifting(v=0.05)["total_list"]
    s_leg, e_leg, frac = est.measurement_window(total, window_mode="legacy")
    s_str, e_str, _ = est.measurement_window(total, window_mode="strict")
    M = total.shape[0]
    assert s_leg == s_str == int(0.65 * M) and e_leg == M
    assert 0 < (frac >= 0.06).sum() <= s_leg
    assert s_str + 3 <= e_str < M


@pytest.mark.parametrize("xlim", [1.0, 2.0])
@pytest.mark.parametrize("v", [0.004, 0.05])
def test_v_eff_equals_jax(xlim, v):
    out = _drifting(v=v)
    ps = _PS(dx=0.02, xlim=xlim)
    got = est.compute_v_eff_and_window(out, ps)
    want = jest.compute_v_eff_and_window(out, ps)
    assert got[3:5] == want[3:5]
    for a, b in zip(got[:3] + got[5:], want[:3] + want[5:]):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    np.testing.assert_allclose(
        est.v_eff_timeseries(out["total_list"], out["times_obs"], xlim),
        np.asarray(jest.v_eff_timeseries(out["total_list"],
                                         out["times_obs"], xlim)), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_displacement_magnetization_front_and_blocking_equal_jax(seed):
    """D_eff (stable slots and the index-paired fallback), the mean m, the
    front density and the blocking probability on a random out dict."""
    out = _random_out(seed)
    ps = _PS(dx=1.0 / 40)
    si, ei = 5, 27
    pairs = (
        (est.compute_D_eff_active(out, ps, si, ei),
         jest.compute_D_eff_active(out, ps, si, ei)),
        (est.compute_D_eff_active(dict(out, pos_frames=None), ps, si, ei),
         jest.compute_D_eff_active(dict(out, pos_frames=None), ps, si, ei)),
        (est.d_eff_from_positions(out["pos_frames"], out["alive_frames"],
                                  out["times_obs"], ps.dx, si, ei),
         jest.d_eff_from_positions(out["pos_frames"], out["alive_frames"],
                                   out["times_obs"], ps.dx, si, ei)),
        (est.compute_mean_magnetization(out, si, ei),
         jest.compute_mean_magnetization(out, si, ei)),
        (est.compute_rho_eff(out, si, ei), jest.compute_rho_eff(out, si, ei)),
        (est.compute_rho_eff(out, si, ei, window_fraction=0.1, xlim=2.0),
         jest.compute_rho_eff(out, si, ei, window_fraction=0.1, xlim=2.0)),
        (est.compute_blocking_probability(out, si, ei),
         jest.compute_blocking_probability(out, si, ei)),
        (est.blocking_probability(out["rho_p_list"], out["total_list"], si,
                                  ei),
         float(jest.blocking_probability(out["rho_p_list"],
                                         out["total_list"], si, ei))),
    )
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, err_msg=str(i), **TOL)
    assert est.compute_mean_magnetizatoin is est.compute_mean_magnetization


def test_estimator_limits():
    """``test_blocking_probability_limits`` and the too-short windows."""
    rho_p = np.ones((5, 10))
    assert est.blocking_probability(rho_p, np.full((5, 10), 2.0), 0, 5) == 1
    assert est.blocking_probability(rho_p, np.zeros((5, 10)), 0, 5) == 0
    assert est.blocking_probability(np.zeros((5, 10)), rho_p, 0, 5) == 0
    out = _random_out(3)
    assert np.isnan(est.d_eff_from_positions(
        out["pos_frames"], out["alive_frames"], out["times_obs"], 1.0, 3, 5))
    speeds = np.random.default_rng(0).normal(0, 1.0, 200)
    times = np.arange(20) * 1.0
    pos = np.outer(times, speeds) + 100.0
    assert est.d_eff_from_positions(pos, np.ones((20, 200), bool), times,
                                    1.0, 0, 20) > 0


def test_device_estimates_match_host():
    """The batched device estimators reproduce the host estimators per
    replica on a real ensemble (JAX ``test_batched_matches_host``, its
    configuration and tolerances)."""
    T, obs_dt = 4.0, 0.25
    config = ParticleConfig(L=64, N=40, n_pad=40, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=False, site_capacity=1,
                            active_model="plus_forward")
    params = broadcast_params(config, beta=[0.5, 1.5, 2.5],
                              rate_diffusion=0.5, rate_active=2.0, n_runs=2,
                              device=CPU)
    res = run_particle_ensemble(config, params, 0, T=T, obs_dt=obs_dt,
                                dt=2e-3, device=CPU)
    f = res.frames
    times = np.arange(0.0, T, obs_dt)
    dev = batched_estimates(f.total, f.m_global, f.rho_p, times, f.pos,
                            f.alive, dx=config.dx, xlim=1.0)
    ps = _PS(dx=config.dx)
    for r in range(6):
        out = frames_to_out(f, r, config, T, obs_dt)
        mean_v, _, _, si, ei, _ = est.compute_v_eff_and_window(out, ps)
        assert si == int(dev.start_idx[r]) and ei == int(dev.end_idx[r])
        np.testing.assert_allclose(float(dev.v_eff[r]), mean_v, rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(
            float(dev.m_mean[r]), est.compute_mean_magnetization(out, si, ei),
            rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(float(dev.rho_eff[r]),
                                   est.compute_rho_eff(out, si, ei),
                                   rtol=5e-4, atol=1e-5)
        np.testing.assert_allclose(
            float(dev.p_block[r]),
            est.compute_blocking_probability(out, si, ei), rtol=5e-4,
            atol=1e-6)
        np.testing.assert_allclose(
            float(dev.D_eff[r]), est.compute_D_eff_active(out, ps, si, ei),
            rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("engine", ["particle", "fused"])
def test_sweep_estimator_host_agrees_with_device(engine, tmp_path):
    """``sweep_over_betas(estimator='host')`` on the same frames as
    ``'device'`` (same seed): every per-β statistic within the batched
    estimators' tolerances; ``sweep_beta_ensemble`` alike."""
    kw = dict(n_runs_per_beta=3, ps_kwargs=dict(
        L=64, N=40, init="fixed", periodic=False, site_capacity=1,
        local_kernel_sigma=0.0, rate_diffusion=0.5, rate_active=2.0),
        run_kwargs=dict(T=3.0, obs_dt=0.25), outdir=str(tmp_path), seed=2,
        do_fit=False, plot_result=False, engine=engine, device=CPU)
    host = sweep_over_betas([0.5, 2.5], estimator="host",
                            npz_path=str(tmp_path / "h.npz"), **kw)
    dev = sweep_over_betas([0.5, 2.5], npz_path=str(tmp_path / "d.npz"),
                           **kw)
    for k in ("means", "m_means", "block_means", "D_means", "rho_means"):
        np.testing.assert_allclose(host[k], dev[k], rtol=5e-4, atol=1e-5,
                                   err_msg=k)
    if engine == "particle":
        one = dict(ps_kwargs=kw["ps_kwargs"], run_kwargs=kw["run_kwargs"],
                   seed=2, device=CPU)
        h = sweep_beta_ensemble(2.5, 3, estimator="host", **one)
        d = sweep_beta_ensemble(2.5, 3, **one)
        for i in (0, 5, 8, 10, 12):
            np.testing.assert_allclose(h[i], d[i], rtol=5e-4, atol=1e-5)
