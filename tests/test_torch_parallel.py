"""Replica-axis parallelism of the port (``hydrolim_tpu_torch/parallel/``),
on the CPU.

- The mesh helpers against the JAX package's ``parallel/mesh.py`` on the
  same inputs: ``_factor2`` and ``make_mesh``'s shape, ``pad_batch``
  (non-batch leaves untouched), ``pad_and_shard`` → ``gather_batch``,
  ``resolve_sweep_mesh``'s precedence; and what the port refuses: more
  ``n_devices`` than the host has (no virtual-device fallback).  The
  'part' and 'space' axes are held in ``tests/test_torch_spatial.py``.
- Every route of a range runner split over ``devices=["cpu"] * 8`` (B=6
  padded to 8, one row a block) against the port's one-device run, as
  ``tests/test_parallel.py`` holds the JAX package: bit for bit on every
  route: B1's plain version, the torch fast path, the τ-leap step with
  anchors and exits, ``lg``, ``lgk``, the anchored engine, B3's and B2's
  plain versions (B2's dense diffusion solve runs one matrix-vector
  product per row on the CPU, so its sum does not depend on the block's
  row count; ``ops/diffusion.diffusion_solve``).
- Every ``n_devices=`` entry point the same way, ``n_devices=8`` on a host
  whose ``select_devices`` is patched to eight CPU devices:
  ``sweep_over_betas`` on ``'lattice_gas'`` and ``'particle'``,
  ``double_sweep_fused``, the σ sweep, both local-structure routes, the
  PDE sweeps; ``run_sweep_grid`` on ``mesh=`` (also with a chunk size
  that is not a multiple of the mesh), a checkpointed run stopped on 8
  blocks and resumed on 1.
- Two gloo processes under ``initialize_multihost`` and
  ``global_sweep_mesh``: both return the single-process result, and the
  default mesh gives each process its own device; on a host with cards
  each process of a multi-process run gets its own card.
- The signature test (fault C6): every public JAX entry point outside
  ``parallel/`` that takes ``n_devices``, ``mesh`` or ``occ_sharding``
  has its port taking the same, and so does every public function of
  ``parallel/spatial.py``.
"""
import ast
import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, PDEConfig
from hydrolim_tpu_torch.core.config import PDEParams
from hydrolim_tpu_torch.parallel import mesh as pm
from hydrolim_tpu_torch.parallel.distributed import (
    initialize_multihost,
    is_primary,
)
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.lattice_gas_k import (
    run_lattice_gas_anchored,
    run_lattice_gas_k,
)
from hydrolim_tpu_torch.particles.run import run_particles
from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    ensemble_states,
)
from hydrolim_tpu_torch.sweeps.fast_exclusion import run_exclusion_sweep
from test_torch_checkpoint import assert_same

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
EIGHT = ["cpu"] * 8
RUN = dict(T=1.2, obs_dt=0.1, dt=0.01)            # 12 frames × 10 steps
BETAS = [0.4, 0.8, 1.2, 1.6, 2.0, 2.4]            # B = 6, padded to 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eight():
    return pm.sweep_mesh(devices=EIGHT)


@pytest.fixture
def eight_cpus(monkeypatch):
    """A host whose ``select_devices`` lists eight CPU devices, so that
    ``n_devices=8`` builds a mesh of eight blocks."""
    monkeypatch.setattr(pm, "select_devices",
                        lambda n_devices=None, device_type=None:
                        [torch.device("cpu")] * 8)


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 6, 7, 8, 12])
def test_factor2_and_make_mesh_shape_are_the_jax_packages(n):
    from hydrolim_tpu.parallel.mesh import _factor2 as jax_factor2

    assert pm._factor2(n) == jax_factor2(n)
    mesh = pm.make_mesh(devices=["cpu"] * n)
    assert mesh.devices.shape == jax_factor2(n)
    assert mesh.shape == dict(zip(("sweep", "part"), jax_factor2(n)))
    assert pm.sweep_axis_size(mesh) == jax_factor2(n)[0]


def test_pad_batch_touches_only_batch_leaves():
    """Against the JAX ``pad_batch`` on the same tree: the (6, ·) leaves
    grow to 8 rows by repeating the last; a (4,) leaf, a scalar and a
    leaf already at 8 rows pass through."""
    from hydrolim_tpu.parallel.mesh import pad_batch as jax_pad

    rng = np.random.default_rng(0)
    tree = dict(a=rng.random((6, 3)).astype(np.float32),
                b=rng.integers(0, 9, 6).astype(np.int32),
                anchors=np.arange(4, dtype=np.int32),
                s=np.float32(2.5),
                full=rng.random((8, 2)).astype(np.float32))
    want = jax_pad(tree, 8, B=6)
    got = pm.pad_batch({k: (torch.from_numpy(np.asarray(v))
                            if k != "anchors" else v)
                        for k, v in tree.items()}, 8, B=6)
    for k in tree:
        w = np.asarray(want[k])
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=k)
    assert got["anchors"] is tree["anchors"]
    # without B every short leading axis is a batch axis, as in JAX
    np.testing.assert_array_equal(
        pm.pad_batch(dict(x=np.arange(4)), 8)["x"],
        np.asarray(jax_pad(dict(x=np.arange(4)), 8)["x"]))


def test_pad_and_shard_then_gather_round_trips():
    mesh = pm.sweep_mesh(devices=["cpu"] * 4)
    p = broadcast_params(ParticleConfig(L=64, N=48, init="fixed"),
                         beta=BETAS, rate_diffusion=0.5, rate_active=2.0,
                         device=CPU)
    blocks, Bp = pm.pad_and_shard(mesh, p, 6)
    assert Bp == 8 and sorted(blocks) == [0, 1, 2, 3]
    assert [b.beta.shape[0] for b in blocks.values()] == [2, 2, 2, 2]
    assert float(blocks[3].beta[-1]) == np.float32(BETAS[-1])    # the pad
    back = pm.gather_batch(mesh, blocks, 6, CPU)
    assert_same(back, p)
    assert pm.pad_and_shard(None, p, 6) == (p, 6)


def test_resolve_sweep_mesh_precedence(eight_cpus):
    explicit = pm.sweep_mesh(devices=["cpu"] * 3)
    assert pm.resolve_sweep_mesh(explicit, 8) is explicit
    assert pm.resolve_sweep_mesh(None, None) is None
    assert pm.resolve_sweep_mesh(None, 1) is None
    two = pm.resolve_sweep_mesh(None, 2, device=CPU)
    assert pm.sweep_axis_size(two) == 2
    assert [str(d) for d in two.sweep_devices()] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="device type 'cuda'"):
        pm.resolve_sweep_mesh(explicit, None, device="cuda")


def test_n_devices_past_the_host_raises():
    """No virtual-device fallback: the message names both counts."""
    with pytest.raises(ValueError, match=r"n_devices=2 but this host has 1 "
                                         r"cpu device"):
        pm.resolve_sweep_mesh(None, 2, device=CPU)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        pm.sweep_mesh(9, devices=EIGHT)


# ---------------------------------------------------------------------------
# every route of a range runner, split over 8 one-row blocks
# ---------------------------------------------------------------------------

def _particles(**over):
    kw = dict(L=64, N=48, init="fixed", scale_rates=False, periodic=True,
              site_capacity=None, local_kernel_sigma=0.0)
    kw.update(over)
    cfg = ParticleConfig(**kw)
    rates = dict(rate_diffusion=0.5, rate_active=2.0)
    if cfg.anchor_positions is not None:
        rates.update(k_on=20.0, k_off=2.0, k_exit=10.0)
    p = broadcast_params(cfg, beta=BETAS, device=CPU, **rates)
    st = ensemble_states(cfg, 6, 3, device=CPU)
    return lambda mesh: run_particles(cfg, p, st, seed=9, mesh=mesh, **RUN)


def _slot_config(K, **over):
    kw = dict(L=64, N=40 * K, init="fixed", scale_rates=False,
              periodic=K == 1, site_capacity=K, local_kernel_sigma=0.02)
    kw.update(over)
    return ParticleConfig(**kw)


def _slots(runner, K):
    cfg = _slot_config(K)
    p = broadcast_params(cfg, beta=BETAS, rate_diffusion=0.5,
                         rate_active=2.0, device=CPU)
    return lambda mesh: runner(cfg, p, seed=4, device=CPU, n_tracers=40 * K,
                               mesh=mesh, **RUN)


def _fused(padded: bool = False):
    """B3's plain version; ``padded``: the batch padded to the mesh
    multiple by the caller with ``b_real=`` the real count, as the JAX
    package's drivers call it, and the real rows compared."""
    cfg = _slot_config(3)
    p = broadcast_params(cfg, beta=BETAS, rate_diffusion=0.5,
                         rate_active=2.0, device=CPU)

    def run(mesh):
        kw = dict(seed=4, device=CPU, n_tracers=120, **RUN)
        if mesh is None or not padded:
            return run_exclusion_sweep(cfg, p, mesh=mesh, **kw)
        out = run_exclusion_sweep(cfg, pm.pad_batch(p, 8, 6), mesh=mesh,
                                  b_real=6, **kw)
        assert out[1].shape[0] == 8
        return pm.take_rows(out, 6)

    return run


def _anchored():
    cfg = _slot_config(3, periodic=False, anchor_positions=(0.3, 0.7),
                       anchor_radius=0.05, exit_buffer=48)
    p = broadcast_params(cfg, beta=BETAS, rate_diffusion=0.5,
                         rate_active=2.0, k_on=20.0, k_off=2.0, k_exit=10.0,
                         device=CPU)
    return lambda mesh: run_lattice_gas_anchored(cfg, p, seed=4, device=CPU,
                                                 mesh=mesh, **RUN)


def _pde(mesh):
    cfg = PDEConfig(L=64, T=0.12, dt=1e-3, bc="periodic",
                    active_model="bidirectional", gaussian_kernel=True,
                    kernel_sigma=0.05, snapshot_interval=10, fft_kmax=4,
                    tracer_window_time=0.015, n_tracers=16)
    full = lambda v: torch.full((6,), v)
    params = PDEParams(gamma=full(0.2), lam=full(0.6),
                       beta=torch.tensor(BETAS))
    gen = torch.Generator()
    gen.manual_seed(5)
    rp, rm, tr = pde_initialize(cfg, gen, B=6, mode="homogeneous",
                                noise=0.3, n_tracers=16, device=CPU)
    res = pde_solve_fused(cfg, params, rp, rm, tr, gen, mesh=mesh)
    return res, gen.get_state()


ROUTES = {
    "b1": lambda: _particles(),
    "torch": lambda: _particles(periodic=False),
    "tau_leap": lambda: _particles(site_capacity=3, local_kernel_sigma=0.02),
    "tau_leap-anchors-exits": lambda: _particles(
        site_capacity=3, periodic=False, anchor_positions=(0.3, 0.7),
        anchor_radius=0.05, exit_buffer=48),
    "lg": lambda: _slots(run_lattice_gas, 1),
    "lgk": lambda: _slots(run_lattice_gas_k, 3),
    "anchored": _anchored,
    "fused": _fused,
    "fused-b_real": lambda: _fused(padded=True),
    "pde": lambda: _pde,
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_on_eight_blocks_is_the_one_device_run(route):
    run = ROUTES[route]()
    assert_same(run(None), run(_eight()))


# ---------------------------------------------------------------------------
# the n_devices= entry points
# ---------------------------------------------------------------------------

def _sweep_kwargs(**over):
    ps = dict(L=64, xlim=1, N=90, init="fixed", periodic=False,
              site_capacity=3, local_kernel_sigma=0.02, scale_rates=False,
              rate_diffusion=0.5, rate_active=2.0, minus_anchor=False)
    ps.update(over)
    return ps, dict(T=1.0, obs_dt=0.1, record_fft=True, record_var=True)


KEYS = ("means", "D_means", "m_means", "rho_means", "block_means")


@pytest.mark.parametrize("engine", ["lattice_gas", "particle", "pallas"])
def test_sweep_over_betas_n_devices_bit_equal(engine, tmp_path, eight_cpus):
    """B=6 on 8 blocks (``tests/test_parallel.py:96``); the npz names the
    blocks' devices."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    ps, rk = _sweep_kwargs()
    common = dict(n_runs_per_beta=2, ps_kwargs=ps, run_kwargs=rk, seed=3,
                  do_fit=False, plot_result=False, engine=engine,
                  device=CPU)
    betas = np.linspace(0.5, 2.5, 3)
    a = sweep_over_betas(betas, npz_path=str(tmp_path / "a.npz"), **common)
    b = sweep_over_betas(betas, npz_path=str(tmp_path / "b.npz"),
                         n_devices=8, **common)
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert list(np.load(tmp_path / "b.npz")["devices"]) == EIGHT
    assert list(a["devices"]) == ["cpu"]


@pytest.mark.parametrize("chunk_size", [256, 5])
def test_run_sweep_grid_mesh_bit_equal(chunk_size):
    """The particle engine's grid, in one chunk and in chunks of 5 (not a
    multiple of the mesh: each chunk pads, the stride stays)."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import run_sweep_grid

    ps, rk = _sweep_kwargs()
    betas = np.linspace(0.0, 3.0, 3)
    _, base, _ = run_sweep_grid(betas, 2, ps, None, rk, seed=11,
                                chunk_size=chunk_size, device=CPU)
    _, shard, _ = run_sweep_grid(betas, 2, ps, None, rk, seed=11,
                                 chunk_size=chunk_size,
                                 mesh=pm.sweep_mesh(devices=EIGHT),
                                 device=CPU)
    assert_same(base, shard)


@pytest.mark.parametrize("engine", ["pallas", "particle"])
def test_double_sweep_fused_n_devices_bit_equal(engine, tmp_path,
                                                eight_cpus):
    """(N × β × runs) in chunks of 5 on 8 blocks
    (``tests/test_parallel.py:150, 199``)."""
    from hydrolim_tpu_torch.sweeps.double_sweep import double_sweep_fused

    kw = dict(n_runs_per_beta=2,
              ps_kwargs=dict(L=64, local_kernel_sigma=0.0, site_capacity=2,
                             periodic=True, rate_diffusion=0.5,
                             rate_active=2.0, minus_anchor=False),
              run_kwargs=dict(T=1.0, obs_dt=0.25), plot_result=False,
              chunk_size=5, seed=4, engine=engine, device=CPU)
    betas = np.linspace(0.5, 2.5, 3)
    Ns = np.array([24.0, 48.0])
    a = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"), **kw)
    b = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "b"),
                           n_devices=8, **kw)
    for pa, pb in zip(a["per_N"], b["per_N"]):
        np.testing.assert_array_equal(pa["block_means"], pb["block_means"])


def test_sigma_sweep_n_devices_bit_equal(tmp_path, eight_cpus):
    from hydrolim_tpu_torch.sweeps.sigma_sweep import sweep_over_sigmas

    ps, rk = _sweep_kwargs()
    kw = dict(n_runs_per_beta=2, ps_kwargs=ps, run_kwargs=rk,
              engine="pallas", device=CPU)
    a = sweep_over_sigmas([0.02, 0.0], [0.5, 2.5],
                          outdir=str(tmp_path / "a"), **kw)
    b = sweep_over_sigmas([0.02, 0.0], [0.5, 2.5],
                          outdir=str(tmp_path / "b"), n_devices=8, **kw)
    for s in a:
        for k in ("v_mean", "D_mean"):
            np.testing.assert_array_equal(a[s][k], b[s][k])


@pytest.mark.parametrize("engine", ["particle", "lattice_gas", "pallas"])
def test_local_structure_n_devices_bit_equal(engine, eight_cpus):
    from hydrolim_tpu_torch.sweeps.local_structure import (
        sweep_betas_for_structures,
    )

    kw = dict(ps_kwargs=dict(L=64, N=120, periodic=True, site_capacity=3,
                             local_kernel_sigma=0.02),
              run_kwargs=dict(T=1.0, obs_dt=0.25), keep_outs=False,
              engine=engine, device=CPU, seed=2)
    a = sweep_betas_for_structures([0.5, 2.5], 3, **kw)
    b = sweep_betas_for_structures([0.5, 2.5], 3, n_devices=8, **kw)
    for beta in a:
        for k in ("var_mean", "low_k_power_mean"):
            np.testing.assert_array_equal(a[beta][k], b[beta][k])


def test_pde_sweeps_n_devices_bit_equal(tmp_path, eight_cpus):
    """``run_pde_ensemble`` (``tests/test_parallel.py:134``),
    ``pde_kernel_sigma_sweep`` and ``pde_beta_sweep``'s estimators (the
    window means of the stitched records) on 8 blocks; ``n_devices`` is a
    named option, not an override of the variant."""
    from hydrolim_tpu_torch.sweeps.pde_sweeps import (
        pde_beta_sweep,
        pde_kernel_sigma_sweep,
        run_pde_ensemble,
    )

    config = PDEConfig(L=64, T=0.02, dt=1e-3, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=0.05, snapshot_interval=10, n_tracers=8,
                       fft_kmax=4)
    kw = dict(gamma=0.2, lam=0.6, n_runs=3, seed=5, n_tracers=8, device=CPU)
    a, _ = run_pde_ensemble(config, [0.5, 2.0], **kw)
    b, _ = run_pde_ensemble(config, [0.5, 2.0], n_devices=8, **kw)
    assert_same(a, b)
    kw = dict(kernel_sigma_values=[0.05], n_runs=3, L=64, dt=1e-3, T=0.02,
              n_tracers=8, plot_result=False, device=CPU,
              outdir=str(tmp_path))
    a = pde_kernel_sigma_sweep(**kw)
    b = pde_kernel_sigma_sweep(n_devices=8, **kw)
    for k in ("m", "v", "D", "var"):
        assert_same(a[k], b[k])
    assert "n_devices" not in b and b["T"] == 0.02
    kw = dict(n_runs=3, T=0.08, t_min=0.055, t_max=0.08, L=64, dt=1e-3,
              n_tracers=8, plot_result=False, device=CPU,
              outdir=str(tmp_path))
    a = pde_beta_sweep([0.5, 2.0], **kw)
    b = pde_beta_sweep([0.5, 2.0], n_devices=8, **kw)
    for k in ("v_mean", "v_err", "D_mean", "D_err"):
        assert np.isfinite(a[k]).all(), k
        np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_stopped_on_eight_blocks_resumes_on_one(tmp_path):
    """The carry on disk is the one-device run's: chunks written on 8
    blocks, stopped, then resumed without a mesh; and the other way
    round.  Both equal the run in one piece."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import run_sweep_grid

    ps, rk = _sweep_kwargs()
    betas = np.linspace(0.0, 3.0, 3)
    grid = lambda **kw: run_sweep_grid(betas, 2, ps, None, rk, seed=11,
                                       device=CPU, chunk_frames=2, **kw)
    _, want, _ = grid()
    for first, then in ((_eight(), None), (None, _eight())):
        d = tmp_path / f"ck{first is None}"
        assert grid(ckpt_dir=d, stop_after_chunks=1, mesh=first) is None
        _, got, _ = grid(ckpt_dir=d, mesh=then)
        assert_same(want, got)


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

_WORKER = r"""
import hashlib, sys
rank, port, repo, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from hydrolim_tpu_torch.parallel.distributed import (
    global_sweep_mesh, initialize_multihost, is_primary)
from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas
initialize_multihost(f"localhost:{port}", 2, rank)
default = global_sweep_mesh()
print("DEFAULT", ",".join(str(d) for d in default.devices),
      ",".join(map(str, default.ranks)), flush=True)
mesh = global_sweep_mesh(devices=["cpu", "cpu"])
ps = dict(L=64, N=90, init="fixed", periodic=False, site_capacity=3,
          local_kernel_sigma=0.02, scale_rates=False, rate_diffusion=0.5,
          rate_active=2.0, minus_anchor=False)
kw = dict(ps_kwargs=ps, run_kwargs=dict(T=1.0, obs_dt=0.1), do_fit=False,
          plot_result=False, device="cpu", engine="particle", mesh=mesh)
s = sweep_over_betas([0.5, 1.5, 2.5], 2, npz_path=f"{out}/r{rank}.npz",
                     **kw)
# checkpointed: stopped after one chunk, then resumed
ck = dict(ckpt_dir=f"{out}/ck", chunk_frames=2,
          npz_path=f"{out}/c{rank}.npz")
assert sweep_over_betas([0.5, 1.5, 2.5], 2, stop_after_chunks=1, **ck,
                        **kw) is None
c = sweep_over_betas([0.5, 1.5, 2.5], 2, **ck, **kw)
assert all(np.array_equal(s[k], c[k], equal_nan=True) for k in (
    "means", "D_means", "m_means", "block_means"))
h = hashlib.sha1(b"".join(np.asarray(s[k]).tobytes() for k in (
    "means", "D_means", "m_means", "block_means"))).hexdigest()
print("DIGEST", h, "PRIMARY", is_primary(), "BLOCKS", len(s["devices"]),
      flush=True)
dist.destroy_process_group()
"""


def _digest(save) -> str:
    return hashlib.sha1(b"".join(np.asarray(save[k]).tobytes() for k in (
        "means", "D_means", "m_means", "block_means"))).hexdigest()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_return_the_single_process_result(tmp_path):
    """Each process runs its two blocks of a 4-block mesh; both print the
    digest of the single-process run, and only the primary writes the
    npz and the checkpoint (a run stopped after one chunk and resumed
    equals the run in one piece).  The workers import only
    ``hydrolim_tpu_torch``."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import sweep_over_betas

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), port, str(REPO),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines, defaults = [], []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        lines.append([ln for ln in so.splitlines()
                      if ln.startswith("DIGEST")][0].split())
        defaults.append([ln for ln in so.splitlines()
                         if ln.startswith("DEFAULT")][0].split()[1:])
    # the default mesh: each process's own device, one block each
    assert defaults == [["cpu,cpu", "0,1"]] * 2
    ps, _ = _sweep_kwargs()
    want = sweep_over_betas([0.5, 1.5, 2.5], 2, ps_kwargs=ps,
                            run_kwargs=dict(T=1.0, obs_dt=0.1),
                            npz_path=str(tmp_path / "one.npz"), do_fit=False,
                            plot_result=False, device=CPU, engine="particle")
    assert [ln[1] for ln in lines] == [_digest(want)] * 2
    assert [ln[3] for ln in lines] == ["True", "False"]
    assert [ln[5] for ln in lines] == ["4", "4"]
    assert (tmp_path / "r0.npz").exists()
    assert not (tmp_path / "r1.npz").exists()
    # the checkpoint, written once by the primary, stitched by both
    assert sorted(p.name for p in (tmp_path / "ck" / "replicas_00000")
                  .iterdir()) == [f"chunk_{c:05d}.npz" for c in range(5)] \
        + ["manifest.json"]


def test_initialize_multihost_is_a_no_op_without_an_address(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    initialize_multihost()
    assert not torch.distributed.is_initialized() and is_primary()


def test_one_process_per_card_on_a_two_card_host(monkeypatch):
    """On a host with two cards (faked), NCCL's ``initialize_multihost``
    makes each process's card current — ``LOCAL_RANK``, else the rank
    modulo the cards — and ``global_sweep_mesh``'s default gives a process
    of a multi-process run that card alone, a single process every card."""
    import hydrolim_tpu_torch.parallel.distributed as pd

    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: None)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for rank in range(4):                       # two hosts of two cards
        pd.initialize_multihost("localhost:1", 4, rank)
    assert current == [0, 1, 0, 1]
    monkeypatch.setenv("LOCAL_RANK", "1")
    pd.initialize_multihost("localhost:1", 4, 2)
    assert current[-1] == 1 and pd.local_rank() == 1
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="local rank 2 but this host has 2"):
        pd.initialize_multihost("localhost:1", 4, 2)
    monkeypatch.setattr(pd, "process_count", lambda: 2)
    assert pd.local_devices() == [torch.device("cuda", 1)]
    monkeypatch.setattr(pd, "process_count", lambda: 1)
    assert pd.local_devices() == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]


# ---------------------------------------------------------------------------
# C6: the JAX entry points taking n_devices / mesh have ports that take them
# ---------------------------------------------------------------------------

def _entry_points(root: Path, names) -> dict:
    """{(module path, function): args} of the public functions under
    ``root`` (``parallel/`` excluded) taking any of ``names``."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("parallel/"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and \
                    not node.name.startswith("_"):
                args = [a.arg for a in node.args.args + node.args.kwonlyargs]
                if set(args) & set(names):
                    out[(rel, node.name)] = args
    return out


def _public_functions(path: Path) -> dict:
    """{name: argument names} of a module's public functions."""
    return {node.name: [a.arg for a in node.args.args
                        + node.args.kwonlyargs]
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.FunctionDef)
            and not node.name.startswith("_")}


def test_every_jax_n_devices_and_mesh_entry_point_has_its_port():
    """Each public JAX function outside ``parallel/`` taking ``n_devices``,
    ``mesh`` or ``occ_sharding`` has a port at the same path taking the
    same; every public function of ``parallel/spatial.py`` has its port
    with the same argument names; the mesh helpers of ``parallel/mesh.py``
    are held above.  No item of the scope table is left, and no
    ``not_ported`` call."""
    from hydrolim_tpu_torch.core.scope import ROADMAP_ITEMS

    names = ("n_devices", "mesh", "occ_sharding")
    jax_eps = _entry_points(REPO / "hydrolim_tpu", names)
    port_eps = _entry_points(REPO / "hydrolim_tpu_torch", names)
    assert len(jax_eps) >= 15
    for key, args in jax_eps.items():
        assert key in port_eps, key
        for a in names:
            if a in args:
                assert a in port_eps[key], (key, a)
    jax_sp = _public_functions(REPO / "hydrolim_tpu/parallel/spatial.py")
    port_sp = _public_functions(REPO / "hydrolim_tpu_torch/parallel/"
                                "spatial.py")
    assert sorted(jax_sp) == ["grid_mesh", "grid_sharding", "space_mesh",
                              "space_sharding"]
    for name, args in jax_sp.items():
        assert port_sp.get(name) == args, name
    assert "parallelism" not in ROADMAP_ITEMS
    assert "lattice sharding" not in ROADMAP_ITEMS
    for path in (REPO / "hydrolim_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert '"parallelism")' not in text, path
        assert '"lattice sharding")' not in text, path
        if path.name != "scope.py":
            assert "not_ported(" not in text, path
