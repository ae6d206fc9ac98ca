"""The frozen counts held to ``chip_smoke.py``'s at the four cells'
shapes, and to the bounds PERF.md publishes there."""
import math

import pytest

from portbench_tiny import ROOT
from portbench.counts import roofline

sys_path = str(ROOT)


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib
    import sys

    if sys_path not in sys.path:
        sys.path.insert(0, sys_path)
    return importlib.import_module("chip_smoke")


def _recipe(L, smooth):
    from hydrolim_tpu_torch.core.config import PDEConfig

    dt = 0.5 / L / 0.6
    kw = dict(L=L, T=1500 * dt, dt=dt, bc="periodic", n_tracers=64,
              fft_kmax=8, snapshot_interval=375, tracer_window_time=20 * dt)
    if smooth:
        kw.update(gaussian_kernel=True, kernel_sigma=0.05)
    return PDEConfig(**kw), 2.5 / L / L / dt


def _xeng_pde():
    from hydrolim_tpu_torch.core.config import PDEConfig

    return PDEConfig(L=1000, T=40.0, dt=5e-4, bc="periodic",
                     active_model="bidirectional", gaussian_kernel=True,
                     kernel_sigma=1e5 - 10, snapshot_interval=2000,
                     fft_kmax=8, n_tracers=1000), 0.2


def test_b1_bound_is_chip_smokes():
    # chip_smoke.b1_rate's bound at the main path's shape (33 × 5000,
    # a 20,000-step call): PERF.md §6's 0.2463 ms
    b = roofline.b1_bound(33, 5000, 20_000)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 4) == 0.2463
    # and at the cell's own call of 131,941 steps
    assert math.isclose(roofline.b1_bound(33, 5000, 131_941)["bound_ms"],
                        0.2463 * 131_941 / 20_000, rel_tol=1e-3)


@pytest.mark.parametrize("shape", ["xeng.pde", "pointwise_1m", "smooth_1m"])
@pytest.mark.parametrize("k", [1, 32, 375, 2000])
def test_b2_bound_is_chip_smokes(chip_smoke, shape, k):
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    if shape == "xeng.pde":
        config, gamma = _xeng_pde()
        B = 33
    else:
        config, gamma = _recipe(1 << 20, shape == "smooth_1m")
        B = 2
    ops = kernel_operands(config, gamma, "cpu")
    smooth_r = ops[2].radius if ops[2] is not None else None
    solve_r = ((ops[3].weights.shape[0] - 1) // 2
               if ops[1] == "banded" else None)
    want = chip_smoke.b2_step_bound(config, ops, B, k)
    got = roofline.b2_step_bound(config.L, config.n_tracers,
                                 config.tracer_window, config.kmax, B, k,
                                 smooth_r, solve_r)
    assert got["bound_ms"] == want["bound_ms"]
    assert got["bound_by"] == want["bound_by"]


def test_b2_bounds_published_in_perf():
    # PERF.md §6: 8.2635 µs a step at 1,048,576 sites (B = 2, the recipe,
    # operations); the main path's 2000-step call at B = 33 is 0.0777 ms
    # (PERF.md's older 0.0847 counted the spectra's direct sum before
    # their count took the FFT's where that is fewer)
    config, _ = _recipe(1 << 20, False)
    b = roofline.b2_step_bound(config.L, 64, config.tracer_window, 8, 2,
                               375, None, 48)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"] * 1e3 / 375, 4) == 8.2635
    config, _ = _xeng_pde()
    b = roofline.b2_step_bound(1000, 1000, config.tracer_window, 8, 33, 2000)
    assert round(b["bound_ms"], 4) == 0.0777


def test_spectra_bound_is_chip_smokes():
    # chip_smoke.py's count at its large calls (the rows and bins, no
    # table) and PERF.md's 500.8 µs for 200 steps × 2 rows at 1,048,576
    # with 8 bins; ~0.12 µs for 50 rows of 1000 with 501 bins
    b = roofline.spectra_bound(400, 1 << 20, 8)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"] * 1e3, 1) == 500.8
    b = roofline.spectra_bound(50, 1000, 501)
    assert round(b["bound_ms"] * 1e3, 2) == 0.12


def test_circulant_and_spectra_ops_are_chip_smokes(chip_smoke):
    for L, r in ((1000, 0), (1 << 20, 48), (1 << 20, 1 << 19), (4096, 63)):
        assert roofline.circulant_ops(L, r) == chip_smoke.circulant_ops(L, r)
    for rows, L, kmax in ((66000, 1000, 8), (750, 1 << 20, 8), (1, 1000, 501)):
        assert (roofline.spectra_ops(rows, L, kmax)
                == chip_smoke.spectra_ops(rows, L, kmax))
