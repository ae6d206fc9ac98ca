"""The PyTorch port's PDE command-line drivers at their ``--small`` sizes on
the CPU: each runs end to end through the fused solve (the plain B2 on CPU
tensors) and writes the JSON its results are read from on a host without
matplotlib."""
import json

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.ops.pde_kernel import pde_multi_step


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


def _finite(a) -> bool:
    return bool(np.isfinite(np.asarray(a, dtype=float)).all())


@pytest.mark.parametrize("which", ["single", "magn2"])
def test_pde_experiments_write_their_json(tmp_path, which):
    from hydrolim_tpu_torch.experiments import pde_experiments

    pde_experiments.main(which, small=True, outdir=str(tmp_path),
                         device="cpu")
    assert pde_multi_step.launches == 0
    out = json.loads((tmp_path / f"{which}.json").read_text())
    if which == "single":           # L=128, T=2, dt=1e-3: 2001 records
        assert len(out["m_series"]) == len(out["fft_amp_k1"]) == 2001
        assert _finite(out["m_series"]) and _finite(out["fft_amp_k1"])
        assert len(out["rho_p"]) == 128
        # β = 2 orders the field from the initial noise
        assert abs(out["m_series"][-1]) > 0.5
    else:                           # γ = 0.2, β = 0.75: |m| decays
        assert out["sigmas"] == [0.005, 0.05, 1.0]
        assert (out["T"], out["gamma"], out["beta"]) == (2.0, 0.2, 0.75)
        assert _finite(out["final_abs_m"])
        for final, series in zip(out["final_abs_m"], out["mean_abs_m"]):
            assert len(series) == 2001 and final < series[0]


def test_pde_phase_diagram_small_grid(tmp_path):
    from hydrolim_tpu_torch.experiments import pde_phase_diagram

    data = pde_phase_diagram.main(small=True, outdir=str(tmp_path),
                                  device="cpu")
    saved = json.loads((tmp_path / "pde_phase_diagram.json").read_text())
    assert saved["m"] == data["m"] and saved["replicas"] == 18
    for key in ("m", "band", "v"):
        grid = np.asarray(saved[key])
        assert grid.shape == (3, 6) and _finite(grid), key
    assert (np.asarray(saved["m"]) <= 1.0 + 1e-6).all()
    assert len(saved["row_wall_s"]) == 3


def test_pde_beta_cli_writes_its_json_without_matplotlib(tmp_path,
                                                          monkeypatch):
    """On a host without matplotlib (the GPU host) ``pde_experiments beta``
    still writes ``beta.json``: its figures go through ``_pyplot()``, which
    skips them."""
    import sys

    from hydrolim_tpu_torch.experiments import pde_experiments

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    pde_experiments.main("beta", small=True, outdir=str(tmp_path),
                         device="cpu")
    out = json.loads((tmp_path / "beta.json").read_text())
    assert len(out["v_mean"]) == 4 and _finite(out["v_mean"])
    assert not list(tmp_path.glob("*.png"))
