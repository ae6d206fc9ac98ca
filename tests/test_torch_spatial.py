"""Lattice-axis halo sharding of the port (``hydrolim_tpu_torch/parallel/
spatial.py`` and ``parallel/halo.py``), on the CPU.

The counterparts of ``tests/test_spatial_sharding.py`` and
``tests/test_distributed.py:76``, at their sizes, on
``devices=["cpu"] * 8`` (a device list may repeat a device):

- ``run_lattice_gas`` and ``run_lattice_gas_k`` with the lattice split
  8-way (``space_sharding``), and both on a (2, 4) ('sweep', 'space')
  ``grid_mesh``, equal the port's unsharded run bit for bit: every frame
  field (the variance and the spectrum too, recorded on the gathered
  field) and the final state;
- the halo counters: a step moves h columns per side of each boundary and
  the m sums, and no full field;
- a halo one column narrower than ``step_halo`` breaks the run;
- the checkpointed runners stopped on a mesh resume unsharded, and the
  other way round;
- the large-lattice driver's halves at ``--small`` on 2 and 4 segments:
  their asserts pass, the particle half is the unsharded half bit for
  bit, the PDE half within ``SHARDED_PDE_RTOL``;
- the 'part' axis: ``run_sweep_grid`` on ``make_mesh`` (a (4, 2) mesh)
  equals one device, and ``shard_particle_state`` places with the JAX
  spec rule and never changes a value;
- two gloo processes, each running 4 segments of an 8-segment 'space'
  mesh: 50 ``lg_step``s with the halo across the process boundary, equal
  digests on both and equal to the single-process run.

The JAX package's sharded runs at the same draws are in
``tests/test_torch_spatial_jax.py``.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.parallel import mesh as pm
from hydrolim_tpu_torch.parallel import spatial
from hydrolim_tpu_torch.parallel.halo import counters, segment_bounds
from hydrolim_tpu_torch.parallel.spatial import (
    grid_mesh,
    grid_sharding,
    space_mesh,
    space_sharding,
)
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params
from test_torch_checkpoint import assert_same

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
EIGHT = ["cpu"] * 8
KW = dict(T=1.0, obs_dt=0.25, dt=5e-3)              # 4 frames × 50 steps


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    kw = dict(L=256, N=128, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=1,
              active_model="plus_forward")
    kw.update(over)
    return ParticleConfig(**kw)


def _params(cfg, betas, n_runs=1, **rates):
    return broadcast_params(cfg, beta=betas, n_runs=n_runs, device=CPU,
                            **rates)


# ---------------------------------------------------------------------------
# meshes and shardings
# ---------------------------------------------------------------------------

def test_meshes_and_specs_are_the_jax_packages():
    """Axis names, shapes and each sharding's PartitionSpec as the JAX
    package's ``parallel/spatial.py`` builds them (8 virtual devices)."""
    import jax
    from hydrolim_tpu.parallel import spatial as js

    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    jm, m = js.space_mesh(8, devices=jax.devices("cpu")), space_mesh(
        devices=EIGHT)
    assert m.axis_names == jm.axis_names and m.devices.shape == (8,)
    for kw in (dict(), dict(slots=True), dict(batched=False)):
        assert space_sharding(m, **kw).spec == tuple(
            js.space_sharding(jm, **kw).spec)
    jg, g = js.grid_mesh(2, 4, devices=jax.devices("cpu")), grid_mesh(
        2, 4, devices=EIGHT)
    assert g.axis_names == jg.axis_names and g.devices.shape == (2, 4)
    for kw in (dict(), dict(slots=True)):
        assert grid_sharding(g, **kw).spec == tuple(
            js.grid_sharding(jg, **kw).spec)
    with pytest.raises(ValueError, match=r"grid_mesh\(2, 4\) needs 8 "
                                         r"devices, have 3"):
        grid_mesh(2, 4, devices=["cpu"] * 3)
    assert space_mesh(3, devices=EIGHT).devices.shape == (3,)


def test_no_device_is_faked_and_l_must_divide():
    with pytest.raises(ValueError, match=r"n_devices=2 but this host has 1"):
        space_mesh(2)
    with pytest.raises(ValueError, match="not a multiple"):
        segment_bounds(250, 8)
    with pytest.raises(ValueError, match="grid_sharding"):
        space_sharding(grid_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="grid_mesh"):
        grid_sharding(space_mesh(devices=["cpu"] * 4))


def test_the_sharding_must_fit_the_engine():
    cfg = _cfg(L=64, N=32)
    p = _params(cfg, [1.0], rate_diffusion=0.5, rate_active=2.0)
    mesh = space_mesh(devices=["cpu"] * 4)
    run = dict(T=0.2, obs_dt=0.1, dt=0.05, device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        run_lattice_gas(cfg, p, occ_sharding=space_sharding(
            mesh, slots=True), **run)
    with pytest.raises(ValueError, match="not both"):
        run_lattice_gas(cfg, p, occ_sharding=space_sharding(mesh),
                        mesh=pm.sweep_mesh(devices=["cpu"] * 2), **run)
    with pytest.raises(TypeError, match="space_sharding or grid_sharding"):
        run_lattice_gas(cfg, p, occ_sharding=object(), **run)


# ---------------------------------------------------------------------------
# sharded runs equal the unsharded run (test_spatial_sharding.py:45-116)
# ---------------------------------------------------------------------------

LG_CASES = {
    # the JAX test's configuration (:45)
    "periodic-global": (dict(), dict(rate_diffusion=1.0, rate_active=2.0)),
    # walls and a reflect band wider than global m's halo; σ-directed hops
    "walls-local": (dict(periodic=False, local_kernel_sigma=0.02,
                         active_model="bidirectional"),
                    dict(rate_diffusion=1.0, rate_active=2.0)),
}


@pytest.mark.parametrize("case", sorted(LG_CASES))
def test_lattice_gas_space_sharded_equals_unsharded(case):
    over, rates = LG_CASES[case]
    cfg = _cfg(**over)
    p = _params(cfg, [1.0, 2.0], **rates)
    kw = dict(KW, n_tracers=8, device=CPU, seed=3)
    want = run_lattice_gas(cfg, p, **kw)
    got = run_lattice_gas(cfg, p, occ_sharding=space_sharding(
        space_mesh(devices=EIGHT)), **kw)
    assert_same(want, got)
    assert (want[0].tracer_pos[:, -1] != want[0].tracer_pos[:, 0]).any()


LGK_CASES = {
    # the JAX test's configuration (:64): 375 steps
    "periodic-global": (dict(N=192, site_capacity=3),
                        dict(T=1.0, dt=2e-3)),
    # walls, a reflect band and crowding, 150 steps
    "walls-local-crowding": (dict(N=192, site_capacity=3, periodic=False,
                                  local_kernel_sigma=0.02,
                                  crowding_suppresses_rates=True,
                                  active_model="bidirectional"),
                             dict(T=0.5, dt=2e-3)),
}


@pytest.mark.parametrize("case", sorted(LGK_CASES))
def test_lattice_gas_k_space_sharded_equals_unsharded(case):
    over, grid = LGK_CASES[case]
    cfg = _cfg(**over)
    p = _params(cfg, [1.5], n_runs=2, rate_diffusion=0.5, rate_active=3.0)
    kw = dict(KW, **grid, n_tracers=24, device=CPU, seed=4)
    want = run_lattice_gas_k(cfg, p, **kw)
    got = run_lattice_gas_k(cfg, p, occ_sharding=space_sharding(
        space_mesh(devices=EIGHT), slots=True), **kw)
    assert_same(want, got)


def test_grid_mesh_sweep_x_space_equals_unsharded():
    """(2, 4) ('sweep', 'space'): both engines, the JAX test's (:82)
    configurations, B=4 over two rows; and B=3, padded."""
    g = grid_mesh(2, 4, devices=EIGHT)
    cfg = _cfg(active_model="bidirectional")
    kw = dict(KW, device=CPU, seed=2)
    for betas, n_runs in (([0.5, 2.0], 2), ([0.5, 1.0, 2.0], 1)):
        p = _params(cfg, betas, n_runs, rate_diffusion=0.3, rate_active=1.0)
        assert_same(run_lattice_gas(cfg, p, n_tracers=8, **kw),
                    run_lattice_gas(cfg, p, n_tracers=8, **kw,
                                    occ_sharding=grid_sharding(g)))
    cfg_k = _cfg(N=300, site_capacity=3, active_model="bidirectional")
    pk = _params(cfg_k, [0.5, 2.0], 2, rate_diffusion=0.3, rate_active=1.0)
    assert_same(run_lattice_gas_k(cfg_k, pk, **kw),
                run_lattice_gas_k(cfg_k, pk, **kw, occ_sharding=grid_sharding(
                    g, slots=True)))


# ---------------------------------------------------------------------------
# what a step moves (test_spatial_sharding.py:117)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3])
def test_a_step_moves_halo_columns_and_sums_not_the_field(K):
    """Per step and boundary: h columns each way of every replica's K
    slots (int32), h = 3 with global m; two all-reduces a step (the m
    sums and the tracers' flags); no full-field gather inside a step, one
    per frame; the field scattered once per range."""
    cfg = _cfg(site_capacity=K, N=128 * K)
    p = _params(cfg, [1.0, 2.0], rate_diffusion=1.0, rate_active=2.0)
    B, L, S, h = 2, 256, 8, 3
    run = run_lattice_gas if K == 1 else run_lattice_gas_k
    counters.reset()
    run(cfg, p, **KW, n_tracers=8, device=CPU, seed=1,
        occ_sharding=space_sharding(space_mesh(devices=EIGHT),
                                    slots=K > 1))
    c = counters.as_dict()
    steps = 3 * 50
    assert c["steps"] == steps
    assert c["halo_copies"] == steps * S * 2
    assert c["halo_bytes"] == steps * S * 2 * h * B * K * 4
    assert c["allreduces"] == 2 * steps
    assert c["step_gathers"] == 0
    assert c["frame_gathers"] == 3
    assert c["gather_bytes"] == 3 * B * K * L * 4
    assert c["scatter_bytes"] == B * K * L * 4
    # the halo is a sliver of the field a gather would move
    assert c["halo_bytes"] / steps < 0.2 * B * K * L * 4


@pytest.mark.parametrize("K", [1, 3])
def test_a_halo_one_column_too_narrow_breaks_the_run(K, monkeypatch):
    """``step_halo`` is the step's dependency radius: at h − 1 a boundary
    site reads a wrapped column of its window, and at high hop rates the
    run leaves the one-device trajectory."""
    cfg = _cfg(site_capacity=K, N=128 * K, active_model="bidirectional")
    p = _params(cfg, [1.0, 2.0] if K == 1 else [1.5], 1 if K == 1 else 2,
                rate_diffusion=40.0, rate_active=40.0)
    run = run_lattice_gas if K == 1 else run_lattice_gas_k
    kw = dict(T=0.5, obs_dt=0.25, dt=5e-3, device=CPU, seed=3,
              record_fft=False)
    sh = space_sharding(space_mesh(devices=EIGHT), slots=K > 1)
    _, want = run(cfg, p, **kw)
    _, same = run(cfg, p, **kw, occ_sharding=sh)
    h = spatial.step_halo
    monkeypatch.setattr(spatial, "step_halo",
                        lambda band, periodic: h(band, periodic) - 1)
    _, narrow = run(cfg, p, **kw, occ_sharding=sh)
    assert torch.equal(want, same)
    assert (want != narrow).sum() > 0


# ---------------------------------------------------------------------------
# the checkpointed runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3])
def test_checkpoint_stopped_on_a_mesh_resumes_unsharded(K, tmp_path):
    """The carry on disk is the one-device run's: chunks written with the
    lattice split 4-way, stopped, resumed unsharded; and the other way
    round.  Both equal the run in one piece."""
    from hydrolim_tpu_torch.utils.checkpoint import (
        run_lattice_gas_checkpointed,
        run_lattice_gas_k_checkpointed,
    )

    cfg = _cfg(L=64, N=32 * K, site_capacity=K, local_kernel_sigma=0.05)
    p = _params(cfg, [0.8, 2.0], rate_diffusion=1.0, rate_active=2.0)
    sh = space_sharding(space_mesh(devices=["cpu"] * 4), slots=K > 1)
    kw = dict(T=0.6, obs_dt=0.1, dt=0.02, device=CPU, seed=5, n_tracers=6)
    run = run_lattice_gas if K == 1 else run_lattice_gas_k
    ck = (run_lattice_gas_checkpointed if K == 1
          else run_lattice_gas_k_checkpointed)
    want = run(cfg, p, **kw)
    for first, then in ((sh, None), (None, sh)):
        d = tmp_path / f"ck{first is None}"
        assert ck(cfg, p, ckpt_dir=d, chunk_frames=2, stop_after_chunks=1,
                  occ_sharding=first, **kw) is None
        assert_same(want, ck(cfg, p, ckpt_dir=d, chunk_frames=2,
                             occ_sharding=then, **kw))


# ---------------------------------------------------------------------------
# the large-lattice driver at --small
# ---------------------------------------------------------------------------

def test_large_lattice_particle_half_on_two_segments():
    """Its asserts pass (inside ``particle_half``), and the final
    occupancy and |m|(t) are the unsharded half's."""
    from hydrolim_tpu_torch.experiments import large_lattice as ll

    want = ll.particle_half(4096, 0, CPU)
    got = ll.particle_half(4096, 0, CPU, space_mesh(devices=["cpu"] * 2))
    np.testing.assert_array_equal(got["occ"], want["occ"])
    np.testing.assert_array_equal(got["m_traj"], want["m_traj"])
    np.testing.assert_array_equal(got["total"], want["total"])


@pytest.mark.parametrize("S", [2, 4])
def test_large_lattice_pde_half_on_segments(S):
    """Its asserts pass (inside ``pde_half``); m(t), the mass and the
    final density are the unsharded half's within ``SHARDED_PDE_RTOL`` of
    their scale, and not bit for bit only through the reassociated mass
    sums."""
    from hydrolim_tpu_torch.experiments import large_lattice as ll

    want = ll.pde_half(4096, True, 0, CPU)
    counters.reset()
    got = ll.pde_half(4096, True, 0, CPU, space_mesh(devices=["cpu"] * S))
    assert ll.pde_max_rel(want, got) < ll.SHARDED_PDE_RTOL
    c = counters.as_dict()
    assert c["steps"] == 600 and c["step_gathers"] == 0
    assert c["halo_copies"] == 600 * S * 2 * 2        # ρ+ and ρ−


def test_large_lattice_meshes_follow_the_jax_driver(monkeypatch):
    """``--n-devices 4``: both halves on a 4-device 'space' mesh;
    ``--grid``: the particle half on a (2, 2) grid (JAX
    ``run_large_lattice.py:100-124``)."""
    from hydrolim_tpu_torch.experiments import large_lattice as ll

    monkeypatch.setattr(ll, "select_devices",
                        lambda n, kind: [torch.device(kind)] * n)
    pm_, sm = ll.meshes(4, False, CPU)
    assert pm_ is sm and sm.axis_names == ("space",) and sm.devices.size == 4
    pm_, sm = ll.meshes(4, True, CPU)
    assert pm_.axis_names == ("sweep", "space") and pm_.devices.shape == (
        2, 2)
    assert sm.devices.shape == (4,)
    assert ll.meshes(1, False, CPU) == (None, None)


# ---------------------------------------------------------------------------
# the 'part' axis
# ---------------------------------------------------------------------------

def test_run_sweep_grid_on_a_part_mesh_equals_one_device():
    """``make_mesh`` over 8 devices is (4 'sweep', 2 'part'): the batch
    splits over the rows, each row's block runs on its first device, and
    the result is the one-device run's."""
    from hydrolim_tpu_torch.sweeps.beta_sweep import run_sweep_grid

    ps = dict(L=64, xlim=1, N=90, init="fixed", periodic=False,
              site_capacity=3, local_kernel_sigma=0.02, scale_rates=False,
              rate_diffusion=0.5, rate_active=2.0, minus_anchor=False)
    rk = dict(T=1.0, obs_dt=0.1, record_fft=True, record_var=True)
    betas = np.linspace(0.5, 2.5, 3)
    mesh = pm.make_mesh(devices=EIGHT)
    assert mesh.shape == {"sweep": 4, "part": 2}
    assert mesh.record()[1] == {"block": 1, "device": "cpu",
                                "part": ["cpu", "cpu"]}
    want = run_sweep_grid(betas, 2, ps, None, rk, seed=11, device=CPU)
    got = run_sweep_grid(betas, 2, ps, None, rk, seed=11, device=CPU,
                         mesh=mesh)
    assert_same(want[1], got[1])


def test_shard_particle_state_placement():
    """The JAX spec rule (``tests/test_theory_pins.py:70-95``): (B, n_buf)
    buffers split over ('sweep', 'part'), per-replica leaves over 'sweep',
    an unbatched buffer over 'part'; placement never changes a value."""
    from hydrolim_tpu_torch.particles.init import init_particles

    cfg = ParticleConfig(L=32, N=64, n_pad=64, init="fixed",
                         scale_rates=False, local_kernel_sigma=0.0,
                         periodic=True, site_capacity=None,
                         active_model="bidirectional")
    gen = torch.Generator().manual_seed(0)
    state = init_particles(cfg, gen, B=4, device=CPU)
    mesh = pm.make_mesh(devices=EIGHT)
    placed = pm.shard_particle_state(mesh, state)
    assert tuple(placed.specs.pos) == ("sweep", "part")
    assert placed.blocks[(3, 1)].pos.shape == (1, state.pos.shape[1] // 2)
    assert_same(pm.gather_particle_state(placed, CPU), state)
    single = init_particles(cfg, gen, B=1, device=CPU)
    one = type(single)(*(x[0] for x in single))        # (n_buf,) leaves
    s1 = pm.shard_particle_state(mesh, one, batched=False)
    assert tuple(s1.specs.pos) == ("part",)
    assert_same(pm.gather_particle_state(s1, CPU), one)
    with pytest.raises(ValueError, match="2-D mesh"):
        pm.shard_particle_state(pm.sweep_mesh(devices=EIGHT), state)


# ---------------------------------------------------------------------------
# two processes over gloo (tests/test_distributed.py:76)
# ---------------------------------------------------------------------------

_WORKER = r"""
import sys
rank, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, repo)
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from hydrolim_tpu_torch.parallel.distributed import (
    global_sweep_mesh, initialize_multihost, is_primary)
from hydrolim_tpu_torch.parallel.halo import counters
from hydrolim_tpu_torch.parallel.spatial import space_sharding
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params
initialize_multihost(f"localhost:{port}", 2, rank)
mesh = global_sweep_mesh("space", devices=["cpu"] * 4)
cfg = ParticleConfig(L=256, N=128, init="fixed", scale_rates=False,
                     local_kernel_sigma=0.0, periodic=True, site_capacity=1,
                     active_model="plus_forward")
p = broadcast_params(cfg, beta=[1.0], rate_diffusion=1.0, rate_active=2.0,
                     device="cpu")
occ0 = torch.tensor(np.random.default_rng(0).choice(
    [-1, 0, 1], size=(1, 256)).astype(np.int32))
_, occ = run_lattice_gas(cfg, p, T=0.5, obs_dt=0.25, dt=5e-3, seed=7,
                         device="cpu", record_fft=False, _occ0=occ0,
                         occ_sharding=space_sharding(mesh))
d = occ[0].numpy().astype(np.int64)
print("DIGEST", int((d * np.arange(1, 257)).sum()), int(np.abs(d).sum()),
      "PRIMARY", is_primary(), "SEGMENTS", mesh.devices.size,
      "COPIES", counters.halo_copies, flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_split_the_lattice():
    """Each process runs 4 segments of an 8-segment 'space' mesh
    (``global_sweep_mesh("space")``); the halo crosses the process
    boundary.  Both print the digest of the single-process run."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), port, str(REPO)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        lines.append([ln for ln in so.splitlines()
                      if ln.startswith("DIGEST")][0].split())
    cfg = _cfg()
    p = _params(cfg, [1.0], rate_diffusion=1.0, rate_active=2.0)
    occ0 = torch.tensor(np.random.default_rng(0).choice(
        [-1, 0, 1], size=(1, 256)).astype(np.int32))
    _, occ = run_lattice_gas(cfg, p, T=0.5, obs_dt=0.25, dt=5e-3, seed=7,
                             device=CPU, record_fft=False, _occ0=occ0)
    d = occ[0].numpy().astype(np.int64)
    want = [str(int((d * np.arange(1, 257)).sum())), str(int(np.abs(d)
                                                             .sum()))]
    assert [ln[1:3] for ln in lines] == [want, want]
    assert [ln[4] for ln in lines] == ["True", "False"]
    assert [ln[6] for ln in lines] == ["8", "8"]
    # each process fetched both halos of its 4 segments, 50 steps
    assert [ln[8] for ln in lines] == ["400", "400"]
