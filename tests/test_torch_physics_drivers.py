"""The port's hydrodynamic-limit convergence driver and the critical-scaling
driver's replot against the JAX package's drivers, on the CPU.

- ``convergence.pde_solution`` (plain-torch ``pde_step``, the dense
  inverse) against ``experiments/run_convergence.py``'s (the XLA step, the
  spectral solve) at ``--small`` (L=32, T=0.5, obs_dt=0.1): m(t) to 1e-5
  relative, ρ(x, T) within the spread of the JAX package's own two exact
  solves of the same run;
- ``fit_slope`` equal to the JAX driver's on the same ladders;
- the convergence CLI at ``--small`` passes its own asserts (both slopes in
  (−0.75, −0.25)) and writes ``convergence.json``, with and without
  matplotlib (the PNG only with it);
- ``critical_scaling --replot`` redraws from an existing JSON without
  simulating, holding the same asserts.

The critical-scaling CLI's ``--small`` run is in
``tests/test_torch_critical_scaling.py``.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.experiments import convergence, critical_scaling

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(L=32, T=0.5, obs_dt=0.1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_driver(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hide_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_pde_solution_equals_jax_driver(monkeypatch):
    """m(t) to 1e-5 relative.  ρ(x, T) after the 1600 steps to the
    spread of the JAX package's own two exact solves of this run: its
    driver solves spectrally ('auto' = 'fft'), and the same driver with
    ``diffusion_solver='dense'`` lands 1.2e-4 (relative) away in float32
    (the port applies a dense inverse, 1.4e-5 from that run); the port
    must be no farther from the driver's run than 1.5 times that spread."""
    import hydrolim_tpu.core.config as jcfg

    jconv = _jax_driver("run_convergence")
    m_want, rho_want = jconv.pde_solution(**SMALL)
    m_got, rho_got = convergence.pde_solution(**SMALL, device="cpu")
    assert m_got.shape == m_want.shape == (5,)
    assert rho_got.shape == rho_want.shape == (32,)
    np.testing.assert_allclose(m_got, m_want, rtol=1e-5)
    jax_pde_config = jcfg.PDEConfig
    monkeypatch.setattr(jcfg, "PDEConfig", lambda **kw: jax_pde_config(
        **dict(kw, diffusion_solver="dense")))
    m_dense, rho_dense = jconv.pde_solution(**SMALL)
    spread = _rel(rho_dense, rho_want)
    assert 0.0 < spread < 3e-4
    assert _rel(rho_got, rho_want) <= 1.5 * spread
    assert _rel(rho_got, rho_dense) < 5e-5
    np.testing.assert_allclose(m_got, m_dense, rtol=1e-5)
    # the CW relaxation really moved m (β = 1.5 from m₀ = 0.4)
    assert abs(m_got[-1] - m_got[0]) > 0.05


@pytest.mark.parametrize("err", [
    [0.2, 0.1, 0.05],                     # all in the fluctuation range
    [0.4, 0.2, 0.1, 0.08, 0.075],         # a saturated tail left out
    [0.1, 0.1, 0.1],                      # flat: keep every point
])
def test_fit_slope_equals_jax_driver(err):
    jconv = _jax_driver("run_convergence")
    Ns = [200, 800, 3200, 12800, 51200][:len(err)]
    se = np.full(len(err), 0.01)
    got, keep = convergence.fit_slope(Ns, err, se)
    want, jkeep = jconv.fit_slope(Ns, err, se)
    assert got == want
    np.testing.assert_array_equal(keep, jkeep)


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_convergence_cli_small(tmp_path, monkeypatch, with_matplotlib):
    """``--small --device cpu``: the driver's asserts hold, the JSON is
    written (with the walls), the errors fall along the ladder; the figure
    only where matplotlib is installed."""
    if not with_matplotlib:
        _hide_matplotlib(monkeypatch)
    rec = convergence.main(["--small", "--device", "cpu", "--outdir",
                            str(tmp_path)])
    on_disk = json.loads((tmp_path / "convergence.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert -0.75 < rec["slope_m"] < -0.25
    assert -0.75 < rec["slope_rho"] < -0.25
    assert rec["err_m"][0] > rec["err_m"][-1]
    assert rec["err_rho"][0] > rec["err_rho"][-1]
    assert rec["Ns"] == [200, 800, 3200] and len(rec["wall_s"]) == 3
    assert (tmp_path / "convergence.png").exists() == with_matplotlib


def _law_record(Ns, sub, crit) -> dict:
    """A critical_scaling.json whose RMS follows N^sub and N^crit."""
    Ns = np.asarray(Ns, float)
    mean = {"0.5": (0.8 * Ns ** sub).tolist(),
            "1.0": (1.2 * Ns ** crit).tolist()}
    return {"Ns": Ns.astype(int).tolist(), "n_runs": 16, "tau_mult": 6.0,
            "betas": [0.5, 1.0], "rms_mean": mean,
            "rms_se": {b: [1e-3] * len(Ns) for b in mean}}


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_critical_scaling_replot_redraws_without_simulating(
        tmp_path, monkeypatch, with_matplotlib):
    (tmp_path / "critical_scaling.json").write_text(
        json.dumps(_law_record([256, 1024, 4096], -0.5, -0.25)))
    monkeypatch.setattr(critical_scaling, "measure", lambda *a, **k: (
        pytest.fail("--replot must not simulate")))
    if not with_matplotlib:
        _hide_matplotlib(monkeypatch)
    rec = critical_scaling.main(["--replot", "--outdir", str(tmp_path)])
    assert rec["slope_subcritical"] == pytest.approx(-0.5, abs=1e-9)
    assert rec["slope_critical"] == pytest.approx(-0.25, abs=1e-9)
    on_disk = json.loads((tmp_path / "critical_scaling.json").read_text())
    assert on_disk["slope_critical"] == rec["slope_critical"]
    assert (tmp_path / "critical_scaling.png").exists() == with_matplotlib


def test_critical_scaling_replot_holds_the_laws(tmp_path, monkeypatch):
    """A record whose critical slope is the subcritical one fails the
    driver's assert."""
    (tmp_path / "critical_scaling.json").write_text(
        json.dumps(_law_record([256, 1024, 4096], -0.5, -0.5)))
    with pytest.raises(AssertionError, match="N\\^-1/4"):
        critical_scaling.main(["--replot", "--outdir", str(tmp_path)])
