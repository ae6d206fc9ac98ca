"""The port's drivers on the fused exclusion route against the JAX package,
on the CPU: the double sweep's fit helpers and the phase diagram's
read-outs on the same arrays (rtol 1e-9), the double sweep, the σ sweep
(with its resume reload) and the particle phase diagram at ``--small``, the
β-sweep's engine names, and the dense reflect smoothing band (radius ≥ L)
against scipy's reflect filter.
"""
import json

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    build_smoothing_band,
    exclusion_multi_step,
    halo_width,
    smooth_with_band,
)
from hydrolim_tpu_torch.sweeps import double_sweep as port_ds


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test processes on the host's cores, and torch's thread pool in each
    would only contend (a test of thousands of tiny ops then runs tens of
    times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_phase_diagram():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).parent.parent / "experiments"
            / "run_particle_phase_diagram.py")
    spec = importlib.util.spec_from_file_location("_jax_ppd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_blocking_fits_match_jax():
    """``fit_blocking_fg``, ``rho_model`` and the f/g meta-fit models on one
    set of arrays: the port's values equal the JAX package's within rtol
    1e-9."""
    from hydrolim_tpu.sweeps import double_sweep as jax_ds

    rng = np.random.default_rng(0)
    beta = np.linspace(0, 3, 11)
    for rho_bar, K in ((0.2, 1), (0.6, 3)):
        m = jax_ds.compute_m_of_beta_non(beta)
        clean = jax_ds.rho_model(beta, 1.1, 0.4, rho_bar, K, m)
        means = clean + rng.normal(0, 0.01, beta.shape)
        ses = rng.uniform(0.005, 0.02, beta.shape)
        np.testing.assert_allclose(
            port_ds.fit_blocking_fg(beta, means, ses, rho_bar, K),
            jax_ds.fit_blocking_fg(beta, means, ses, rho_bar, K), rtol=1e-9)
        np.testing.assert_allclose(
            port_ds.rho_model(beta, 1.1, 0.4, rho_bar, K, m), clean,
            rtol=1e-9)
    x = np.linspace(0.05, 0.95, 19)
    np.testing.assert_allclose(port_ds.f_model(x, 1.25, 0.6),
                               jax_ds.f_model(x, 1.25, 0.6), rtol=1e-9)
    np.testing.assert_allclose(port_ds.g_model(x, 0.15),
                               jax_ds.g_model(x, 0.15), rtol=1e-9)
    f_fit = 1.25 - 0.6 * x + rng.normal(0, 0.01, x.shape)
    g_fit = 0.15 / x ** 1.5 * (1 + rng.normal(0, 0.02, x.shape))
    errs = np.full_like(x, 0.02)
    got = port_ds._meta_fit(None, x * 1000, 1000, f_fit, errs, g_fit, errs,
                            plot_result=False)
    from scipy.optimize import curve_fit

    (C0, C1), _ = curve_fit(jax_ds.f_model, x, f_fit, sigma=errs,
                            absolute_sigma=True)
    (C2,), _ = curve_fit(jax_ds.g_model, x, g_fit, sigma=errs,
                         absolute_sigma=True)
    np.testing.assert_allclose([got["C0"], got["C1"], got["C2"]],
                               [C0, C1, C2], rtol=1e-9)


def test_phase_diagram_readouts_match_jax():
    """``crossing_curve`` and ``check_physics`` on the same grids give the
    JAX driver's values (rtol 1e-9) and verdicts."""
    from hydrolim_tpu_torch.experiments import particle_phase_diagram as pd

    jx = _jax_phase_diagram()
    beta = np.linspace(0, 3, 32)
    rng = np.random.default_rng(1)
    rows = np.clip(np.tanh(2.0 * (beta - rng.uniform(0.8, 1.6, (5, 1))))
                   + rng.normal(0, 0.02, (5, 32)), 0, 1)
    rows[1] = 0.1                              # never orders → NaN
    np.testing.assert_allclose(pd.crossing_curve(beta, rows),
                               jx.crossing_curve(beta, rows), rtol=1e-9)
    data = dict(beta=beta.tolist(), m=rows.tolist(), N=1500, n_seeds=2)
    ordered = np.clip(np.tanh(2.0 * (beta - 0.9)), 0, 1)
    for m_last, ok in ((ordered, True), (np.full(32, 0.5), False)):
        data["m"] = np.vstack([rows[:-1], m_last]).tolist()
        verdicts = []
        for check in (pd.check_physics, jx.check_physics):
            try:
                check(data)
                verdicts.append(True)
            except AssertionError:
                verdicts.append(False)
        assert verdicts == [ok, ok]


# the JAX package's double_sweep_fused result keys
# (hydrolim_tpu/sweeps/double_sweep.py:318-322)
DOUBLE_SWEEP_KEYS = {"N_values", "f_fit", "f_err", "g_fit", "g_err", "C0",
                     "C1", "C2", "C0_err", "C1_err", "C2_err", "per_N"}


def test_double_sweep_small(tmp_path):
    """``particle_double_sweep --small`` (4 N × 4 β × 2 runs, L=200, T=3) on
    the CPU: the JAX package's keys, finite constants and their errors, and
    a second chunk seeding that does not depend on the chunks before it."""
    from hydrolim_tpu_torch.experiments import particle_double_sweep

    res = particle_double_sweep.main(small=True, outdir=str(tmp_path),
                                     device="cpu", engine="pallas")
    assert set(res) == DOUBLE_SWEEP_KEYS
    assert set(res["per_N"][0]) == {"N", "block_means", "block_ses"}
    assert len(res["per_N"]) == 4 and len(res["per_N"][0]["block_means"]) == 4
    for k in ("C0", "C1", "C2", "C0_err", "C1_err", "C2_err"):
        assert np.isfinite(res[k]), k
    assert port_ds.chunk_seed(0, 44) == port_ds.chunk_seed(0, 44)
    assert port_ds.chunk_seed(0, 44) != port_ds.chunk_seed(0, 88)
    assert exclusion_multi_step.launches == 0


@pytest.mark.parametrize("engine", ["particle", "lattice_gas"],
                         ids=["particle-item 2", "lattice_gas-item 1"])
def test_double_sweep_other_engines_raise(engine, tmp_path):
    """The JAX package's other engines, which raised before their ports:
    ``'particle'`` (the default, the τ-leap step) and ``'lattice_gas'``
    (the slot engine) each run the grid: the JAX package's keys, finite
    constants, no kernel launch."""
    n0 = exclusion_multi_step.launches
    kw = dict(engine=engine) if engine != "particle" else {}
    res = port_ds.double_sweep_fused(
        np.linspace(0, 3, 4), [40, 80, 120], n_runs_per_beta=2,
        ps_kwargs=dict(L=100), run_kwargs=dict(T=2.0, obs_dt=0.2),
        outdir=str(tmp_path), plot_result=False, device="cpu", **kw)
    assert set(res) == DOUBLE_SWEEP_KEYS
    for k in ("C0", "C1", "C2"):
        assert np.isfinite(res[k]), k
    assert exclusion_multi_step.launches == n0


def test_sigma_sweep_small_and_resume(tmp_path, monkeypatch):
    """``particle_sigma_sweep --small`` (σ ∈ {0.005, 0.05, 0} × 4 β × 2 runs,
    L=200) on the CPU; a second call reloads every σ from its npz without
    running, the JAX package's ``sweep_over_sigmas`` reads the same files
    to the same table, and ``--replot`` reloads the archive."""
    from hydrolim_tpu.sweeps.sigma_sweep import sweep_over_sigmas as j_sweep

    from hydrolim_tpu_torch.experiments import particle_sigma_sweep
    from hydrolim_tpu_torch.sweeps import sigma_sweep

    res = particle_sigma_sweep.main(small=True, outdir=str(tmp_path),
                                    device="cpu", engine="fused")
    assert sorted(res) == [0.0, 0.005, 0.05]
    for r in res.values():
        assert set(r) == {"beta", "v_mean", "v_se", "D_mean", "D_se",
                          "ps_kwargs"}
        assert np.isfinite(r["v_mean"]).all() and np.isfinite(r["D_mean"]).all()
    assert res[0.05]["ps_kwargs"]["rate_diffusion"] == 0.002

    def no_run(*a, **k):
        raise AssertionError("resume re-ran a sigma")

    monkeypatch.setattr(sigma_sweep, "sweep_over_betas", no_run)
    again = sigma_sweep.sweep_over_sigmas(
        [0.005, 0.05, 0], np.linspace(0, 3, 4), n_runs_per_beta=2,
        ps_kwargs=dict(L=200, N=100), outdir=str(tmp_path), engine="fused",
        device="cpu")
    replot = particle_sigma_sweep.main(small=True, outdir=str(tmp_path),
                                       run=False, device="cpu",
                                       engine="fused")
    jres = j_sweep([0.005, 0.05, 0], np.linspace(0, 3, 4),
                   n_runs_per_beta=2, ps_kwargs=dict(L=200, N=100),
                   outdir=str(tmp_path), engine="pallas")
    for s in res:
        for k in ("v_mean", "v_se", "D_mean", "D_se"):
            np.testing.assert_array_equal(again[s][k], res[s][k])
            np.testing.assert_array_equal(replot[s][k], res[s][k])
            np.testing.assert_array_equal(jres[s][k], res[s][k])


def test_particle_phase_diagram_small(tmp_path):
    """``particle_phase_diagram --small`` (6 β × 3 σ × 1 seed, L=128) on the
    CPU, pinned as the JAX driver's smoke test pins it: the mean-field
    (global-m) row disordered at β=0 and ordered at β=3, and the driver's
    own ``check_physics`` passes."""
    from hydrolim_tpu_torch.experiments import particle_phase_diagram

    particle_phase_diagram.main(small=True, outdir=str(tmp_path),
                                device="cpu")
    rec = json.loads((tmp_path / "particle_phase_diagram.json").read_text())
    m = np.asarray(rec["m"])
    assert m.shape == (3, 6) and np.asarray(rec["band"]).shape == (3, 6)
    assert m[-1, 0] < 0.3 and m[-1, -1] > 0.7
    assert rec["engine"] == "auto"
    assert rec["engines_used"] == ["exclusion_multi_step"] * 3
    assert len(rec["row_wall_s"]) == len(rec["row_steps"]) == 3


@pytest.mark.parametrize("engine", ["pallas", "auto"])
def test_sweep_over_betas_takes_the_jax_fused_names(tmp_path, engine):
    """``engine='pallas'`` and ``'auto'`` name the fused route: the same
    table as ``'fused'`` at the same seed."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    kw = dict(n_runs_per_beta=2, ps_kwargs=dict(L=64, N=40),
              run_kwargs=dict(T=1.0, obs_dt=0.25), seed=3, do_fit=False,
              plot_result=False, device="cpu")
    want = sweep_over_betas([0.5, 2.0], npz_path=str(tmp_path / "a.npz"),
                            engine="fused", **kw)
    got = sweep_over_betas([0.5, 2.0], npz_path=str(tmp_path / "b.npz"),
                           engine=engine, **kw)
    np.testing.assert_array_equal(got["means"], want["means"])
    np.testing.assert_array_equal(got["spins_final"], want["spins_final"])


@pytest.mark.parametrize("engine", ["particle", "lattice_gas"],
                         ids=["particle-item 2", "lattice_gas-item 1"])
def test_sweep_over_betas_other_engines_raise(engine, tmp_path):
    """The engines that raised before their ports now run:
    ``'particle'`` (the default) on the τ-leap step, ``'lattice_gas'`` on
    the slot engines."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    kw = dict(engine=engine) if engine != "particle" else {}
    save = sweep_over_betas([1.0], n_runs_per_beta=2,
                            ps_kwargs=dict(L=64, N=40),
                            run_kwargs=dict(T=2.0, obs_dt=0.2),
                            npz_path=str(tmp_path / "s.npz"), do_fit=False,
                            plot_result=False, device="cpu", **kw)
    assert str(save["route"]) == ("lg_step" if engine == "lattice_gas"
                                  else "tau_leap")
    assert np.isfinite(save["m_means"]).all()


@pytest.mark.parametrize("L,sigma", [(100, 0.3), (64, 0.5), (1000, 0.3)])
def test_dense_reflect_band_is_scipys_filter(L, sigma):
    """A reflect (non-periodic) band whose radius reaches L (σ=0.3 at
    L=1000 is the σ sweep's: radius 1200) is one dense band, every row
    reading all L sites: its smoothing of random signed counts equals
    ``hydrolim_tpu.ops.convolve.reflect_gaussian_filter`` and scipy's
    ``gaussian_filter1d(mode='reflect')`` within 1e-6, and its reach puts
    the launch plan at one CTA per replica."""
    from hydrolim_tpu.ops.convolve import reflect_gaussian_filter

    cfg = ParticleConfig(L=L, N=10, local_kernel_sigma=sigma,
                         periodic=False, site_capacity=3)
    band = build_smoothing_band(cfg, device="cpu")
    assert int(4.0 * cfg.sigma_grid + 0.5) >= L
    assert tuple(band.idx.shape) == (L, L)
    assert (band.idx.numpy() == np.arange(L)).all()
    rot = band.rot.numpy()
    assert ((rot == -1) | (rot >= 0)).all() and (rot == -1).sum() >= L - 1
    x = np.random.default_rng(L).integers(-3, 4, (3, L)).astype(np.float32)
    got = smooth_with_band(torch.tensor(x), band).numpy()
    np.testing.assert_allclose(
        got, np.asarray(reflect_gaussian_filter(x, cfg.sigma_grid)),
        atol=1e-6)
    np.testing.assert_allclose(
        got, ndi.gaussian_filter1d(x.astype(np.float64), cfg.sigma_grid,
                                   mode="reflect", truncate=4.0), atol=1e-6)
    assert 2 * halo_width(band, False) > L // 2     # no cluster of 2 fits


def test_jax_matrix_is_not_scipys_filter_past_L():
    """The reference behaviour the dense band does not follow: the JAX
    fused kernel's ``build_conv_matrix`` reflects each tap once, so at
    radius ≥ L its weights are not scipy's (ROADMAP.md, "Reference
    behaviours a parity test runs into"), while below L they are."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.ops.pallas_exclusion import build_conv_matrix

    L = 100
    eye = np.eye(L)
    for sigma, differs in ((0.3, True), (0.05, False)):
        jcfg = JConfig(L=L, N=10, local_kernel_sigma=sigma, periodic=False,
                       site_capacity=3)
        M = build_conv_matrix(jcfg)[:L, :L].astype(np.float64)
        S = ndi.gaussian_filter1d(eye, jcfg.sigma_grid, axis=1,
                                  mode="reflect", truncate=4.0)
        assert (np.abs(M - S).max() > 1e-5) == differs, sigma


# (JAX package callable, the port's) whose engine defaults must agree
ENGINE_DEFAULT_PAIRS = {
    "sweep_over_betas": ("hydrolim_tpu.sweeps.beta_sweep:sweep_over_betas",
                         "hydrolim_tpu_torch.sweeps.beta_sweep:"
                         "sweep_over_betas"),
    "sweep_over_sigmas": ("hydrolim_tpu.sweeps.sigma_sweep:sweep_over_sigmas",
                          "hydrolim_tpu_torch.sweeps.sigma_sweep:"
                          "sweep_over_sigmas"),
    "double_sweep_fused": ("hydrolim_tpu.sweeps.double_sweep:"
                           "double_sweep_fused",
                           "hydrolim_tpu_torch.sweeps.double_sweep:"
                           "double_sweep_fused"),
    "sweep_betas_for_structures": (
        "hydrolim_tpu.sweeps.local_structure:sweep_betas_for_structures",
        "hydrolim_tpu_torch.sweeps.local_structure:"
        "sweep_betas_for_structures"),
    "ParticleSystem.run": ("hydrolim_tpu.particles.system:ParticleSystem.run",
                           "hydrolim_tpu_torch.particles.system:"
                           "ParticleSystem.run"),
}

# (the JAX package's CLI script, the port's CLI module)
ENGINE_DEFAULT_CLIS = {
    "beta sweep": ("run_particle_beta_sweep", "particle_beta_sweep"),
    "double sweep": ("run_particle_double_sweep", "particle_double_sweep"),
    "sigma sweep": ("run_particle_sigma_sweep", "particle_sigma_sweep"),
    "local structure": ("run_particle_local_structure",
                        "particle_local_structure"),
}


def _resolve(spec):
    import importlib

    mod, name = spec.split(":")
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("pair", list(ENGINE_DEFAULT_PAIRS))
def test_engine_defaults_follow_the_jax_package(pair):
    """The same call with default arguments runs the same engine in both
    packages: each ``engine=`` default equals the JAX package's."""
    import inspect

    jax_fn, port_fn = (_resolve(s) for s in ENGINE_DEFAULT_PAIRS[pair])
    default = lambda f: inspect.signature(f).parameters["engine"].default
    assert default(port_fn) == default(jax_fn) == "particle", pair


@pytest.mark.parametrize("cli", list(ENGINE_DEFAULT_CLIS))
def test_cli_engine_defaults_follow_the_jax_package(cli):
    """Each particle CLI's ``--engine`` default and its ``main(engine=)``
    default equal the JAX package's CLI's."""
    import importlib
    import inspect
    import pathlib
    import re

    jax_name, port_name = ENGINE_DEFAULT_CLIS[cli]
    root = pathlib.Path(__file__).parent.parent
    pat = re.compile(r'add_argument\(\s*"--engine",\s*default="(\w+)"')
    jax_src = (root / "experiments" / f"{jax_name}.py").read_text()
    port_mod = importlib.import_module(
        f"hydrolim_tpu_torch.experiments.{port_name}")
    port_src = inspect.getsource(port_mod)
    assert pat.findall(port_src) == pat.findall(jax_src) == ["particle"]
    jax_main = re.search(r'def main\([^)]*engine: str = "(\w+)"', jax_src,
                         re.S).group(1)
    port_main = inspect.signature(port_mod.main).parameters["engine"].default
    assert port_main == jax_main == "particle"
