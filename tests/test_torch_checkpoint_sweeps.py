"""``ckpt_dir=`` on the port's drivers, on the CPU: each driver
checkpointed (stopped after one chunk where it can be, then resumed)
returns what it returns without a checkpoint, on every route, and refuses
or ignores ``ckpt_dir=`` where the JAX package does, with the same
exception type.  A signature test holds every JAX entry point that takes
``ckpt_dir`` or ``estimator`` to a port counterpart that takes it.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import PDEConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import exclusion_multi_step
from hydrolim_tpu_torch.sweeps import double_sweep as ds
from hydrolim_tpu_torch.sweeps.beta_sweep import (
    DEFAULT_PS_KWARGS,
    sweep_over_betas,
)
from hydrolim_tpu_torch.sweeps.local_structure import (
    _lattice_gas_outs,
    sweep_betas_for_structures,
)
from hydrolim_tpu_torch.sweeps.pde_sweeps import (
    pde_beta_sweep,
    pde_kernel_sigma_sweep,
    pde_single_run,
    run_pde_ensemble,
)
from hydrolim_tpu_torch.sweeps.sigma_sweep import sweep_over_sigmas

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
BETAS = [0.5, 2.0]
RUN = dict(T=1.2, obs_dt=0.1)                   # 12 frames
STATS = ("means", "stds", "ses", "D_means", "D_ses", "m_means", "m_stds",
         "m_ses", "rho_means", "rho_ses", "block_means", "block_ses")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ps(**over):
    kw = dict(L=64, N=48, init="fixed", periodic=True, site_capacity=1,
              local_kernel_sigma=0.02, rate_diffusion=0.5, rate_active=2.0)
    kw.update(over)
    return kw


def _assert_equal(a, b, path=""):
    """Equal values, arrays element by element (NaN equals NaN)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        np.testing.assert_array_equal(x, y, err_msg=path)


def _sweep(tmp_path, engine, ps, **kw):
    save = sweep_over_betas(
        BETAS, n_runs_per_beta=2, ps_kwargs=ps, run_kwargs=RUN,
        npz_path=str(tmp_path / "s.npz"), outdir=str(tmp_path), seed=3,
        keep_outs=True, do_fit=False, plot_result=False, engine=engine,
        device=CPU, **kw)
    return None if save is None else {
        k: save[k] for k in STATS + ("outs", "route", "dt", "spins_final")
        if k in save}


# engine, ps_kwargs, the route the sweep takes
SWEEP_CASES = {
    "particle-tau_leap": ("particle", _ps(), "tau_leap"),
    "particle-b1": ("particle", _ps(site_capacity=None,
                                    local_kernel_sigma=0.0),
                    "meanfield_multi_step"),
    "fused-K3": ("fused", _ps(site_capacity=3, N=96), "exclusion_multi_step"),
    "lattice_gas-K1": ("lattice_gas", _ps(), "lg_step"),
    "lattice_gas-K3": ("lattice_gas", _ps(site_capacity=3, N=96,
                                          periodic=False), "lgk_step"),
}


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_sweep_over_betas_ckpt_dir_equals_plain(case, tmp_path):
    """``sweep_over_betas(ckpt_dir=)`` on every route: halted after one
    chunk (returns None), then resumed, its statistics, out dicts, route
    and final slots equal the sweep's without a checkpoint."""
    engine, ps, route = SWEEP_CASES[case]
    want = _sweep(tmp_path, engine, ps)
    assert str(want["route"]) == route
    ck = tmp_path / "ck"
    assert _sweep(tmp_path, engine, ps, ckpt_dir=ck, chunk_frames=5,
                  stop_after_chunks=1) is None
    got = _sweep(tmp_path, engine, ps, ckpt_dir=ck, chunk_frames=5)
    _assert_equal(want, got)
    manifests = sorted(p.relative_to(ck).as_posix()
                       for p in ck.rglob("manifest.json"))
    assert manifests == (["replicas_00000/manifest.json"]
                         if engine == "particle" else ["manifest.json"])


def test_anchored_grid_ignores_ckpt_dir(tmp_path):
    """The anchored slot engine runs uncheckpointed with ``ckpt_dir=``, as
    in the JAX package (``beta_sweep.py:206-215``): nothing is written and
    the result is the sweep's without it."""
    ps = _ps(site_capacity=3, N=60, periodic=False,
             anchor_positions=(0.3, 0.7), anchor_radius=0.05, k_on=20.0,
             k_off=2.0, k_exit=10.0)
    want = _sweep(tmp_path, "lattice_gas", ps)
    got = _sweep(tmp_path, "lattice_gas", ps, ckpt_dir=tmp_path / "ck")
    assert str(got["route"]) == "lgk_step anchored"
    _assert_equal(want, got)
    assert not (tmp_path / "ck").exists()


def test_sigma_sweep_checkpoints_each_sigma_in_its_subdirectory(tmp_path):
    """``sweep_over_sigmas(ckpt_dir=)``: one ``sigma_<σ:.4g>``
    subdirectory per σ (JAX ``sigma_sweep.py:70-74``), results equal to
    the σ sweep's without it."""
    kw = dict(n_runs_per_beta=2, ps_kwargs=_ps(init="fixed"),
              run_kwargs=RUN, seed=1, device=CPU, engine="fused")
    want = sweep_over_sigmas([0.02, 0], BETAS, outdir=str(tmp_path / "a"),
                             **kw)
    got = sweep_over_sigmas([0.02, 0], BETAS, outdir=str(tmp_path / "b"),
                            ckpt_dir=tmp_path / "ck", **kw)
    _assert_equal(want, got)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "sigma_0", "sigma_0.02"]
    assert (tmp_path / "ck" / "sigma_0.02" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# the double sweep's chunk ledger
# ---------------------------------------------------------------------------

def _double(tmp_path, **kw):
    return ds.double_sweep_fused(
        np.linspace(0, 3, 4), [40, 80], n_runs_per_beta=2,
        ps_kwargs=dict(L=100), run_kwargs=dict(T=1.0, obs_dt=0.2),
        outdir=str(tmp_path), plot_result=False, chunk_size=6,
        engine="pallas", device=CPU, **kw)


def test_double_sweep_ledger_equals_plain_and_resumes(tmp_path):
    """Two of three ledger chunks, then a resume that runs only the third:
    C0/C1/C2 and every per-N mean equal the sweep's without a ledger."""
    want = _double(tmp_path)
    ck = tmp_path / "ck"
    assert _double(tmp_path, ckpt_dir=ck, stop_after_chunks=2) is None
    assert sorted(p.name for p in ck.glob("chunk_*.npz")) == [
        "chunk_0000000.npz", "chunk_0000006.npz"]
    n0 = exclusion_multi_step.launches
    got = _double(tmp_path, ckpt_dir=ck)
    _assert_equal(want, got)
    assert (ck / "chunk_0000012.npz").exists()
    assert exclusion_multi_step.launches == n0          # plain version


def test_double_sweep_ledger_hash_guard(tmp_path):
    """A ledger of another grid (another seed) is refused with
    ValueError; ``resume=False`` starts it over."""
    ck = tmp_path / "ck"
    assert _double(tmp_path, ckpt_dir=ck, stop_after_chunks=1) is None
    with pytest.raises(ValueError, match="different double sweep"):
        _double(tmp_path, ckpt_dir=ck, seed=1)
    assert _double(tmp_path, ckpt_dir=ck, seed=1, resume=False) is not None


def test_double_sweep_unvouched_chunks_never_stitch(tmp_path):
    """Ledger files without a manifest are deleted, never read."""
    want = _double(tmp_path)
    ck = tmp_path / "ck"
    ck.mkdir()
    np.savez(ck / "chunk_0000000.npz", p_block=np.full(6, 0.5))
    _assert_equal(want, _double(tmp_path, ckpt_dir=ck))


def test_double_sweep_stop_without_a_ledger(tmp_path):
    assert _double(tmp_path, stop_after_chunks=1) is None


# ---------------------------------------------------------------------------
# the local-structure sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["particle", "lattice_gas"])
def test_structure_sweep_ckpt_dir_equals_plain(engine, tmp_path):
    """``sweep_betas_for_structures(ckpt_dir=)`` on the particle route
    (``run_sweep_grid``) and the slot engine (``_lattice_gas_outs``):
    the per-β observables equal the sweep's without it."""
    kw = dict(ps_kwargs=_ps(), run_kwargs=RUN, seed=2, keep_outs=False,
              engine=engine, device=CPU)
    want = sweep_betas_for_structures(BETAS, 2, **kw)
    got = sweep_betas_for_structures(BETAS, 2, ckpt_dir=tmp_path, **kw)
    _assert_equal(want, got)
    assert list(tmp_path.rglob("manifest.json"))


def test_structure_refusals_mirror_the_jax_package(tmp_path):
    """The fused route refuses ``ckpt_dir=`` with AssertionError in both
    entry points, as JAX's ``local_structure.py:138-146, 198-201``."""
    with pytest.raises(AssertionError, match="ckpt_dir"):
        sweep_betas_for_structures(BETAS, 2, ps_kwargs=_ps(),
                                   run_kwargs=RUN, engine="pallas",
                                   ckpt_dir=tmp_path, device=CPU)
    with pytest.raises(AssertionError, match="ckpt_dir"):
        _lattice_gas_outs(BETAS, 2, dict(DEFAULT_PS_KWARGS, **_ps()), None,
                          RUN, 0, kernel="auto", ckpt_dir=tmp_path,
                          device=CPU)


# ---------------------------------------------------------------------------
# the PDE drivers
# ---------------------------------------------------------------------------

PDE_SMALL = dict(L=64, dt=1e-3, n_tracers=24)


def test_pde_beta_sweep_ckpt_dir_equals_plain(tmp_path):
    kw = dict(n_runs=2, T=0.3, t_min=0.1, t_max=0.3, seed=4,
              plot_result=False, device=CPU, **PDE_SMALL)
    want = pde_beta_sweep(BETAS, **kw)
    got = pde_beta_sweep(BETAS, ckpt_dir=tmp_path, **kw)
    _assert_equal(want, got)
    assert (tmp_path / "manifest.json").exists()


def test_pde_ensemble_halts_resumes_and_refuses_pallas(tmp_path):
    """``run_pde_ensemble(ckpt_dir=)``: halted after one chunk, resumed,
    equal to the ensemble without it (snapshots dropped as the sweeps
    drop them); ``engine='auto'`` checkpoints and ``'pallas'`` refuses
    with AssertionError, as JAX's ``pde_sweeps.py:88-94``."""
    cfg = PDEConfig(L=64, T=0.2, dt=1e-3, bc="periodic",
                    active_model="bidirectional", gaussian_kernel=True,
                    kernel_sigma=0.05, snapshot_interval=20, fft_kmax=8)
    kw = dict(gamma=0.2, lam=0.6, n_runs=2, seed=6, n_tracers=24,
              device=CPU, fetch_snapshots=False)
    want, beta = run_pde_ensemble(cfg, BETAS, **kw)
    assert run_pde_ensemble(cfg, BETAS, ckpt_dir=tmp_path, engine="auto",
                            stop_after_chunks=1, **kw) is None
    got, beta2 = run_pde_ensemble(cfg, BETAS, ckpt_dir=tmp_path, **kw)
    np.testing.assert_array_equal(beta, beta2)
    fields = lambda r: dict(rho_p=r.rho_p, rho_m=r.rho_m,
                            snapshots=r.snapshots, snap_times=r.snap_times,
                            **vars(r.records))
    _assert_equal(fields(want), fields(got))
    assert want.snapshots.shape == (4, 0, 64)
    with pytest.raises(AssertionError, match="ckpt_dir"):
        run_pde_ensemble(cfg, BETAS, ckpt_dir=tmp_path, engine="pallas",
                         **kw)


def test_pde_sigma_sweep_and_single_run_ckpt_dir(tmp_path):
    """``pde_kernel_sigma_sweep(ckpt_dir=)`` keeps one ``sigma_<σ>``
    subdirectory per σ; ``pde_single_run(ckpt_dir=)`` solves through
    ``solve_checkpointed``; both equal their runs without it."""
    kw = dict(kernel_sigma_values=[0.005, 0.05], n_runs=2, T=0.1,
              plot_result=False, device=CPU, **PDE_SMALL)
    want = pde_kernel_sigma_sweep(**kw)
    got = pde_kernel_sigma_sweep(ckpt_dir=tmp_path / "s", **kw)
    _assert_equal(want, got)
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == [
        "sigma_0.005", "sigma_0.05"]
    kw = dict(L=64, T=0.1, dt=1e-3, outdir=str(tmp_path / "o"), device=CPU)
    want = pde_single_run(**kw)
    got = pde_single_run(ckpt_dir=tmp_path / "one", **kw)
    _assert_equal(want, got)
    assert (tmp_path / "one" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# the signatures: what takes ckpt_dir / estimator in the JAX package takes
# it in the port
# ---------------------------------------------------------------------------

def _entry_points(root: Path, names=("ckpt_dir", "estimator")):
    """{(module path, qualified name): its parameter names} of the public
    module-level functions and class methods under ``root`` that take one
    of ``names``."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        rel = path.relative_to(root).as_posix()
        for node in tree.body:
            defs = [(node.name, node)] if isinstance(node, ast.FunctionDef) \
                else [(f"{node.name}.{f.name}", f) for f in node.body
                      if isinstance(f, ast.FunctionDef)] \
                if isinstance(node, ast.ClassDef) else []
            for qual, fn in defs:
                args = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
                if not qual.split(".")[-1].startswith("_") and \
                        set(args) & set(names):
                    out[(rel, qual)] = args
    return out


def test_every_jax_ckpt_and_estimator_entry_point_has_its_port():
    """Each public JAX function or method taking ``ckpt_dir`` or
    ``estimator`` has a counterpart at the same path in the port taking
    the same of the two (and ``chunk_frames``/``chunk_blocks``, ``resume``,
    ``stop_after_chunks`` where the JAX one does); no
    ``not_ported(..., "checkpointing")`` is left, and the scope table has
    no checkpointing item."""
    from hydrolim_tpu_torch.core.scope import ROADMAP_ITEMS

    jax_eps = _entry_points(REPO / "hydrolim_tpu")
    port_eps = _entry_points(REPO / "hydrolim_tpu_torch")
    assert len(jax_eps) >= 20
    for key, args in jax_eps.items():
        assert key in port_eps, key
        for a in ("ckpt_dir", "estimator", "chunk_frames", "chunk_blocks",
                  "resume", "stop_after_chunks"):
            if a in args:
                assert a in port_eps[key], (key, a)
    assert "checkpointing" not in ROADMAP_ITEMS
    for path in (REPO / "hydrolim_tpu_torch").rglob("*.py"):
        assert '"checkpointing")' not in path.read_text(), path


@pytest.mark.parametrize("cli", ["particle_beta_sweep",
                                 "particle_double_sweep",
                                 "particle_local_structure",
                                 "particle_sigma_sweep", "pde_experiments"])
def test_each_cli_takes_ckpt_dir(cli):
    """The port's counterparts of the JAX CLIs that take ``--ckpt-dir``
    take it too, and hand it to ``main``."""
    import importlib
    import inspect

    mod = importlib.import_module(f"hydrolim_tpu_torch.experiments.{cli}")
    assert "ckpt_dir" in inspect.signature(mod.main).parameters
    src = Path(mod.__file__).read_text()
    assert '"--ckpt-dir"' in src and "ckpt_dir=a.ckpt_dir" in src
    jax_cli = REPO / "experiments" / f"run_{cli}.py"
    assert '"--ckpt-dir"' in jax_cli.read_text()
