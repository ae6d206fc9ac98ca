"""The port's kinesin-II fit, its datasets and the cross-engine figures
against the JAX package, on the CPU (host code: numpy and scipy only).

- every array of ``fit/datasets.py`` equal to the JAX module's;
- ``fit_kinesin`` (20 trust-region fits, one per capacity k) and
  ``plot_f_and_g``'s C0/C1/C2 equal to the JAX functions' to 1e-9
  relative, with and without matplotlib;
- ``plot_particle_vs_pde``'s displayed series equal;
- the real-data CLI writes ``kinesin_fit.json`` (and the figures where
  matplotlib is installed).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hydrolim_tpu.fit import datasets as j_ds
from hydrolim_tpu.fit.real_data import fit_kinesin as j_fit_kinesin
from hydrolim_tpu.viz.cross_engine import plot_f_and_g as j_plot_f_and_g
from hydrolim_tpu_torch.fit import datasets, real_data
from hydrolim_tpu_torch.viz import cross_engine

REPO = Path(__file__).resolve().parents[1]
FIT_KEYS = ("k", "beta", "lam", "cost", "chi2", "chi2_red", "chi2_tasep_lk",
            "chi2_tasep_lk_red")


def _hide_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)


@pytest.fixture(scope="module")
def fits():
    return real_data.fit_kinesin(), j_fit_kinesin()


def test_datasets_equal_jax():
    names = [n for n in dir(j_ds) if n.isupper()]
    assert {"KINESIN_RHO_BAR", "KINESIN_V_EFF", "KINESIN_V_ERR", "FG_X",
            "F_SERIES", "F_ERR", "G_SERIES", "G_ERR"} <= set(names)
    assert names == [n for n in dir(datasets) if n.isupper()]
    for n in names:
        got, want = getattr(datasets, n), getattr(j_ds, n)
        assert got.dtype == want.dtype, n
        np.testing.assert_array_equal(got, want, err_msg=n)


def test_fit_kinesin_equals_jax(fits):
    got, want = fits
    assert got["k"] == want["k"]
    for k in FIT_KEYS[1:]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(got["tasep_lk_at_data"],
                               want["tasep_lk_at_data"], rtol=1e-9)
    # the mean-field model fits better than the TASEP-LK curve
    assert got["chi2"] < got["chi2_tasep_lk"]


@pytest.mark.parametrize("with_matplotlib", [True, False])
def test_plot_f_and_g_constants_equal_jax(tmp_path, monkeypatch,
                                          with_matplotlib):
    want = j_plot_f_and_g(outdir=str(tmp_path / "jax"))
    if not with_matplotlib:
        _hide_matplotlib(monkeypatch)
    got = cross_engine.plot_f_and_g(outdir=str(tmp_path / "port"))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert (tmp_path / "port" / "f_and_g_fit.png").exists() == with_matplotlib


def test_plot_particle_vs_pde_series(tmp_path):
    """The PDE series' display transforms and the theory curves; both
    figures drawn."""
    s = cross_engine.plot_particle_vs_pde(outdir=str(tmp_path))
    np.testing.assert_allclose(
        s["pde_v"], 2.0 * (j_ds.PDE_V_EFF_RAW * 1000.0 - 0.3), rtol=1e-12)
    np.testing.assert_allclose(s["pde_D"], j_ds.PDE_D_EFF_RAW * 5e5,
                               rtol=1e-12)
    assert s["v_theory"][0] == 0.0 and np.all(np.isfinite(s["D_theory"]))
    for f in ("PDE_v_eff_vs_beta.png", "PDE_D_eff_vs_beta.png"):
        assert (tmp_path / f).stat().st_size > 0


def test_real_data_main_writes_its_fit_without_matplotlib(tmp_path,
                                                          monkeypatch, fits):
    """On a host without matplotlib (the GPU host) ``main`` still returns
    and writes the fit; no figure."""
    _hide_matplotlib(monkeypatch)
    fit = real_data.main(str(tmp_path))
    rec = json.loads((tmp_path / "kinesin_fit.json").read_text())
    for k in FIT_KEYS:
        assert rec[k] == pytest.approx(fits[1][k], rel=1e-9), k
        assert fit[k] == rec[k]
    assert not list(tmp_path.glob("*.png"))


def test_real_data_cli_writes_its_output(tmp_path, fits):
    """``python -m hydrolim_tpu_torch.experiments.real_data_fit``: the
    printed fit, the JSON and both figures."""
    run = subprocess.run(
        [sys.executable, "-m", "hydrolim_tpu_torch.experiments.real_data_fit",
         "--outdir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=True)
    assert f"k = {fits[1]['k']:.6f}" in run.stdout
    rec = json.loads((tmp_path / "kinesin_fit.json").read_text())
    assert rec["k"] == fits[1]["k"]
    for f in ("KinII_fit.png", "KinII_residual.png"):
        assert (tmp_path / f).stat().st_size > 0
