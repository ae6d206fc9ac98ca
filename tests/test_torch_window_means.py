"""The β sweep's window means taken where the records are
(``sweeps.pde_sweeps.record_window_means`` through ``run_pde_ensemble``'s
``mean_window=``), on the CPU.

The JAX package's ``pde_beta_sweep`` is the yardstick: given the records
the port's sweep fetched (its ``run_pde_ensemble`` patched to return
them), its v_mean, v_err, D_mean and D_err equal the port's to 1e-6
relative, on a real small solve and on synthetic records with the
tracers' NaN lead-in, an all-NaN row and window ends on grid points.
Without ``mean_window`` the ensemble is the plain solve's result, bit for
bit; the span ``pde.window_means`` counts the rows it reduced and where.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused, result_to_numpy
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.pde.stepper import PDERecord, PDESolveResult
from hydrolim_tpu_torch.sweeps import pde_sweeps
from hydrolim_tpu_torch.sweeps.pde_sweeps import (
    pde_beta_sweep,
    record_window_means,
    run_pde_ensemble,
    window_columns,
)
from hydrolim_tpu_torch.utils import profiling

SMALL = dict(L=64, dt=1e-3, n_tracers=12)
T = 0.08                                   # 80 steps, 81 record columns
WINDOW = 50                                # the tracers' lead-in at dt=1e-3
KEYS = ("v_mean", "v_err", "D_mean", "D_err")


def jax_estimators(monkeypatch, fetched, betas, n_runs, t_min, t_max):
    """The JAX package's ``pde_beta_sweep`` on the port's fetched result:
    its ``run_pde_ensemble`` returns ``fetched`` (the numpy result and
    the flat β) in place of a solve.

    The port sums the float32 records in float64; the JAX package's
    ``np.nanmean`` sums them in their own float32, whose rounding alone
    moves a standard error of three close runs by ~1e-6 relative.  So the
    yardstick gets the same records widened to float64 (exact), and both
    average the same numbers."""
    from hydrolim_tpu.sweeps import pde_sweeps as jax_sweeps

    res, flat = fetched
    rec = dataclasses.replace(res.records,
                              v_eff=res.records.v_eff.astype(np.float64),
                              D_eff=res.records.D_eff.astype(np.float64))
    monkeypatch.setattr(jax_sweeps, "run_pde_ensemble", lambda *a, **kw: (
        dataclasses.replace(res, records=rec), flat))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return jax_sweeps.pde_beta_sweep(
            betas, n_runs=n_runs, T=T, t_min=t_min, t_max=t_max,
            plot_result=False, **SMALL)


def assert_estimators_close(got, want):
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0,
                                   equal_nan=True, err_msg=k)


def synthetic_records(B, n, seed=0):
    """float32 v_eff and D_eff rows as the kernel writes them: NaN over
    the tracers' first ``WINDOW`` columns, row 1 NaN throughout."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((B, n), generator=g) * 0.3 + 0.2
    D = torch.rand((B, n), generator=g) * 0.5 + 0.1
    for x in (v, D):
        x[:, :WINDOW] = float("nan")
        x[1] = float("nan")
    return v, D


def grid(nsteps=80):
    return np.linspace(0, T, nsteps + 1)


# ---------------------------------------------------------------------------
# the reduction and its columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [(60, 80), (50, 50), (0, 80), (10, 40)])
def test_window_columns_are_the_former_mask(cols):
    """Window ends exactly on grid points: the columns are the mask's
    one run, whatever the thinning."""
    t = grid()
    cfg = PDEConfig(T=T, **{k: SMALL[k] for k in ("L", "dt")})
    assert cfg.nsteps == 80
    t_min, t_max = t[cols[0]], t[cols[1]]
    assert window_columns(cfg, t_min, t_max) == cols
    mask = (t >= t_min) & (t <= t_max)
    assert np.flatnonzero(mask).tolist() == list(range(cols[0],
                                                       cols[1] + 1))
    thinned = PDEConfig(T=T, record_every=4,
                        **{k: SMALL[k] for k in ("L", "dt")})
    inside = np.flatnonzero(mask[::4])
    assert window_columns(thinned, t_min, t_max) == (
        (inside[0], inside[-1]) if inside.size else (0, -1))


@pytest.mark.parametrize("cols", [(60, 80), (50, 50), (0, 80), (10, 40),
                                  (40, 60)])
def test_record_window_means_is_the_rows_nanmean(cols):
    """Each row's NaN-ignoring mean over the columns, float64 sums of the
    float32 records; an all-NaN window reads NaN."""
    v, D = synthetic_records(5, 81)
    got = record_window_means(v, D, *cols).numpy()
    assert got.shape == (5, 2) and got.dtype == np.float64
    sl = slice(cols[0], cols[1] + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = np.stack([np.nanmean(v[:, sl].double().numpy(), axis=1),
                         np.nanmean(D[:, sl].double().numpy(), axis=1)], 1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                               equal_nan=True)
    assert np.isnan(got[1]).all()
    assert np.isnan(got).all() == (cols[1] < WINDOW)


def test_record_window_means_empty_window_reads_nan():
    v, D = synthetic_records(3, 81)
    got = record_window_means(v, D, 0, -1)
    assert got.shape == (3, 2) and torch.isnan(got).all()


def test_record_window_means_rows_do_not_depend_on_the_batch():
    """A row's means are those of the row alone, bit for bit."""
    v, D = synthetic_records(7, 81, seed=3)
    whole = record_window_means(v, D, 52, 77)
    for i in range(7):
        one = record_window_means(v[i:i + 1], D[i:i + 1], 52, 77)
        assert torch.equal(one.isnan(), whole[i:i + 1].isnan())
        assert torch.equal(one.nan_to_num(), whole[i:i + 1].nan_to_num())


# ---------------------------------------------------------------------------
# the β sweep against the JAX package's
# ---------------------------------------------------------------------------

def _tap_records(monkeypatch):
    """Keep what ``pde_beta_sweep`` gets from ``run_pde_ensemble``: the
    numpy result and the flat β."""
    kept = {}
    orig = pde_sweeps.run_pde_ensemble

    def run(*a, **kw):
        kept["out"] = out = orig(*a, **kw)
        return out
    monkeypatch.setattr(pde_sweeps, "run_pde_ensemble", run)
    return kept


@pytest.mark.parametrize("n_runs", [1, 3])
def test_beta_sweep_equals_the_jax_package(monkeypatch, n_runs):
    kept = _tap_records(monkeypatch)
    t = grid()
    betas = [0.5, 2.0]
    got = pde_beta_sweep(betas, n_runs=n_runs, T=T, t_min=t[55],
                         t_max=t[80], seed=7, plot_result=False,
                         device="cpu", **SMALL)
    want = jax_estimators(monkeypatch, kept["out"], betas, n_runs, t[55],
                          t[80])
    assert_estimators_close(got, want)
    assert set(got) == set(want) == {"beta_values", *KEYS}
    for k in KEYS:
        assert got[k].shape == (len(betas),)
        assert np.isfinite(got[k]).all(), k
    assert (got["v_err"] == 0).all() == (n_runs == 1)


def _synthetic_solve(v, D):
    """A stand-in for ``pde_solve_fused`` that returns the given records."""
    def solve(config, params_b, rho_p0, *a, **kw):
        B, n = v.shape
        empty = torch.zeros((B, 0, config.L))
        return PDESolveResult(
            rho_p=rho_p0, rho_m=rho_p0,
            records=PDERecord(m_mean=v * 0, var=v * 0,
                              fft_ri=torch.zeros((B, n, config.kmax, 2)),
                              v_eff=v, D_eff=D),
            snapshots=empty, m_snapshots=empty,
            snap_times=torch.zeros((B, 0)))
    return solve


@pytest.mark.parametrize("n_runs", [1, 3])
@pytest.mark.parametrize("cols", [(60, 80), (50, 50), (30, 70)])
def test_beta_sweep_on_synthetic_records(monkeypatch, n_runs, cols):
    """The NaN lead-in, an all-NaN row (its β reads NaN, with numpy's
    warning) and window ends on grid points, through the whole sweep."""
    n_beta = 2
    betas = [0.5, 2.0][:n_beta]
    v, D = synthetic_records(n_beta * n_runs, 81, seed=n_runs)
    monkeypatch.setattr(pde_sweeps, "pde_solve_fused", _synthetic_solve(v, D))
    kept = _tap_records(monkeypatch)
    t = grid()
    with pytest.warns(RuntimeWarning, match="Mean of empty slice"):
        got = pde_beta_sweep(betas, n_runs=n_runs, T=T, t_min=t[cols[0]],
                             t_max=t[cols[1]], plot_result=False,
                             device="cpu", **SMALL)
    assert np.array_equal(kept["out"][0].records.v_eff, v.numpy(),
                          equal_nan=True)
    want = jax_estimators(monkeypatch, kept["out"], betas, n_runs,
                          t[cols[0]], t[cols[1]])
    assert_estimators_close(got, want)
    nan_beta = 1 // n_runs                 # the β that holds row 1
    assert np.isnan(got["v_mean"][nan_beta])
    assert np.isfinite(got["v_mean"][1 - nan_beta])


def test_beta_sweep_empty_window_reads_nan_and_warns(monkeypatch):
    """A window between two grid points holds no column: NaN with numpy's
    warning, as the JAX package gives, not an exception."""
    kept = _tap_records(monkeypatch)
    t = grid()
    t_min, t_max = t[60] + 1e-6, t[61] - 1e-6
    with pytest.warns(RuntimeWarning, match="Mean of empty slice"):
        got = pde_beta_sweep([1.0], n_runs=2, T=T, t_min=t_min, t_max=t_max,
                             plot_result=False, device="cpu", **SMALL)
    for k in ("v_mean", "D_mean"):
        assert np.isnan(got[k]).all()
    assert_estimators_close(got, jax_estimators(monkeypatch, kept["out"],
                                                [1.0], 2, t_min, t_max))


# ---------------------------------------------------------------------------
# run_pde_ensemble with and without the window; the span
# ---------------------------------------------------------------------------

CFG = PDEConfig(L=64, T=0.06, dt=1e-3, bc="periodic",
                active_model="bidirectional", gaussian_kernel=True,
                kernel_sigma=0.05, snapshot_interval=20, fft_kmax=4,
                n_tracers=12)
ENS = dict(gamma=0.2, lam=0.6, n_runs=2, seed=9, n_tracers=12, device="cpu")
FIELDS = ("rho_p", "rho_m", "snapshots", "m_snapshots", "snap_times")
RECORDS = ("m_mean", "var", "fft_ri", "v_eff", "D_eff")


def _arrays(res):
    return {**{f: getattr(res, f) for f in FIELDS},
            **{f: getattr(res.records, f) for f in RECORDS}}


def _assert_bitwise(a, b):
    bits = lambda x: np.ascontiguousarray(x).view(np.uint8)
    for k, x in _arrays(a).items():
        y = _arrays(b)[k]
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert np.array_equal(bits(x), bits(y)), k


def test_run_pde_ensemble_without_the_window_is_the_plain_solve():
    """Without ``mean_window`` the ensemble is the initial state, the
    fused solve and the fetch, bit for bit, and has no means; with it,
    the same arrays and the means of its records."""
    betas = [0.5, 2.0]
    got, flat = run_pde_ensemble(CFG, betas, **ENS)
    assert got.window_means is None
    B = len(flat)
    gen = torch.Generator().manual_seed(ENS["seed"])
    full = lambda v: torch.full((B,), v, dtype=torch.float32)
    params = PDEParams(gamma=full(0.2), lam=full(0.6),
                       beta=torch.tensor(flat))
    start = pde_initialize(CFG, gen, B=B, mode="homogeneous", rho0=1.0,
                           noise=0.3, n_tracers=12, device="cpu")
    want = result_to_numpy(pde_solve_fused(CFG, params, *start, gen))
    _assert_bitwise(got, want)

    t_min, t_max = 0.02, 0.06
    with_means, _ = run_pde_ensemble(CFG, betas, mean_window=(t_min, t_max),
                                     **ENS)
    _assert_bitwise(with_means, want)
    cols = window_columns(CFG, t_min, t_max)
    assert np.array_equal(with_means.window_means, record_window_means(
        torch.from_numpy(want.records.v_eff),
        torch.from_numpy(want.records.D_eff), *cols).numpy())
    assert np.isfinite(with_means.window_means).all()


def test_window_means_span_counts_its_rows(monkeypatch):
    """``pde.window_means`` is two spans a sweep: the reduction's, with
    ``rows`` = B and ``device`` the records' device, and the host's per-β
    arithmetic."""
    monkeypatch.setattr(profiling, "_registry", profiling._Registry())
    profiling.enable()
    pde_beta_sweep([0.5, 2.0, 3.0], n_runs=2, T=T, t_min=0.06, t_max=T,
                   plot_result=False, device="cpu", **SMALL)
    spans = [e for e in profiling.events() if e.name == "pde.window_means"]
    assert len(spans) == 2
    reduced = [e for e in spans if "rows" in e.attrs]
    assert len(reduced) == 1
    assert reduced[0].attrs == dict(rows=6, device="cpu")
    fetch = [e for e in profiling.events() if e.name == "pde.fetch"]
    assert len(fetch) == 1 and reduced[0].end <= fetch[0].start
