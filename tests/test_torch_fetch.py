"""``pde.fast_solve.result_to_numpy`` on the CPU: the plain path's arrays
are the tensors' own values, shapes and dtypes, C-contiguous also where a
record column is a strided view (``record_every > 1``) or the snapshot
times an ``expand``, and the span ``pde.fetch`` counts their bytes with
none page-locked.  The card's path is held in ``test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import PDEConfig, PDEParams
from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused, result_to_numpy
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.utils import profiling

FIELDS = ("rho_p", "rho_m", "snapshots", "m_snapshots", "snap_times")
RECORDS = ("m_mean", "var", "fft_ri", "v_eff", "D_eff")


@pytest.fixture(autouse=True)
def clean_record(monkeypatch):
    """A fresh record, off, for each test."""
    monkeypatch.setattr(profiling, "_registry", profiling._Registry())


def _solve(record_every):
    cfg = PDEConfig(L=64, T=0.048, dt=1e-3, bc="periodic",
                    active_model="bidirectional", gaussian_kernel=True,
                    kernel_sigma=0.05, snapshot_interval=12, fft_kmax=6,
                    tracer_window_time=0.006, n_tracers=16,
                    record_every=record_every)
    full = lambda v: torch.full((2,), v)
    params = PDEParams(gamma=full(0.2), lam=full(0.6),
                       beta=torch.tensor([0.5, 2.0]))
    gen = torch.Generator()
    gen.manual_seed(7)
    rho_p, rho_m, tr = pde_initialize(cfg, gen, B=2, mode="homogeneous",
                                      noise=0.3, n_tracers=16, device="cpu")
    return pde_solve_fused(cfg, params, rho_p, rho_m, tr, gen)


def _tensors(res):
    return {**{f: getattr(res, f) for f in FIELDS},
            **{f: getattr(res.records, f) for f in RECORDS}}


@pytest.mark.parametrize("record_every", [1, 3])
def test_cpu_result_to_numpy_is_the_tensors_values_c_contiguous(
        record_every):
    res = _solve(record_every)
    src = _tensors(res)
    assert src["snap_times"].stride()[0] == 0          # an expand
    if record_every > 1:
        assert not src["m_mean"].is_contiguous()       # a strided view
        assert not src["fft_ri"].is_contiguous()
    profiling.enable()
    out = result_to_numpy(res)
    got = _tensors(out)
    assert set(got) == set(src)
    for name, t in src.items():
        a, want = got[name], t.numpy()
        assert isinstance(a, np.ndarray), name
        assert a.shape == want.shape and a.dtype == want.dtype, name
        assert a.flags.c_contiguous, name
        assert np.array_equal(a, want, equal_nan=True), name
        # a contiguous CPU tensor's array is its own memory, as before
        assert np.shares_memory(a, want) == t.is_contiguous(), name
    assert out.records.m_mean.shape[1] == 48 // record_every + 1
    (sp,) = [e for e in profiling.events() if e.name == "pde.fetch"]
    assert sp.attrs["bytes"] == sum(a.nbytes for a in got.values())
    assert sp.attrs["pinned_bytes"] == 0


def test_cpu_result_to_numpy_records_nothing_with_spans_off():
    out = result_to_numpy(_solve(1))
    assert profiling.events() == []
    assert all(a.flags.c_contiguous for a in _tensors(out).values())
