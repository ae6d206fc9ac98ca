"""Chunked checkpoint/resume of the port's runs, on the CPU (plain versions
of kernels B1, B2 and B3, and the plain-torch engines).

A run cut into chunks, stopped (``stop_after_chunks``) and resumed from
disk must equal the run in one piece bit for bit (every field, dtype and
device) on every route: B1's (``run_particles``, periodic mean field), the
torch fast path (walls), the τ-leap step (with anchors and exits), the
slot engines (``lg``, ``lgk``), B3's (``run_exclusion_sweep``) and B2's
(``pde_solve_checkpointed``, chunk edges off the tracer window).  The
manifest guard refuses a foreign run (another seed, device or package,
an unreadable manifest), adopts the stored chunk layout and never
stitches unvouched chunks; a real SIGKILL of a child process leaves a
resumable prefix.  Held against the JAX package: ``config_hash``, the
τ-leap run at the JAX draws against JAX's ``run_particles_checkpointed``,
the K-slot run against JAX's ``run_lattice_gas_k_checkpointed``, and a
JAX-written directory refused.  Sizes of ``tests/test_checkpoint_run.py``:
L=64, N=48, T=1.2, obs_dt 0.1, chunks of 5/5/2.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch import IMEXPDE, ParticleSystem, interop
from hydrolim_tpu_torch.core.config import ParticleConfig, PDEConfig
from hydrolim_tpu_torch.core.config import PDEParams
from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu_torch.particles.run import (
    B1_ROUTE,
    TAU_LEAP_ROUTE,
    TORCH_ROUTE,
    run_particles,
)
from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.sweeps.ensemble import (
    broadcast_params,
    ensemble_states,
)
from hydrolim_tpu_torch.sweeps.fast_exclusion import run_exclusion_sweep
from hydrolim_tpu_torch.sweeps.persistence import (
    cached_run,
    config_hash,
    load_pytree,
    save_pytree,
)
from hydrolim_tpu_torch.utils import checkpoint as ck
from hydrolim_tpu_torch.utils.checkpoint import (
    cleanup_ckpt_dir,
    pde_solve_checkpointed,
    run_lattice_gas_checkpointed,
    run_lattice_gas_k_checkpointed,
    run_particles_checkpointed,
)

CPU = "cpu"
RUN = dict(T=1.2, obs_dt=0.1, dt=0.01)            # 12 frames × 10 steps
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(x, path=""):
    """(path, leaf) pairs of a result: tensors, arrays, None, scalars."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}.{k}")
    elif hasattr(x, "_asdict"):
        yield from _leaves(x._asdict(), path)
    elif dataclasses.is_dataclass(x):
        yield from _leaves({f.name: getattr(x, f.name)
                            for f in dataclasses.fields(x)}, path)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, x


def assert_same(a, b):
    """Equal bit for bit, leaf by leaf: dtype, shape, device, values (NaN
    equals NaN)."""
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor), path
            assert (x.dtype, x.shape, x.device) == (y.dtype, y.shape,
                                                    y.device), path
            x, y = x.numpy(), y.numpy()
        if x is None or isinstance(x, str):
            assert x == y, path
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        np.testing.assert_array_equal(x, y, err_msg=path)


# ---------------------------------------------------------------------------
# the routes: (run in one piece, checkpointed run) on the same inputs
# ---------------------------------------------------------------------------

def _particles(**over):
    kw = dict(L=64, N=48, init="fixed", scale_rates=False, periodic=True,
              site_capacity=None, local_kernel_sigma=0.0)
    kw.update(over)
    cfg = ParticleConfig(**kw)
    rates = dict(rate_diffusion=0.5, rate_active=2.0)
    if cfg.anchor_positions is not None:
        rates.update(k_on=20.0, k_off=2.0, k_exit=10.0)
    p = broadcast_params(cfg, beta=[0.8, 2.0], device=CPU, **rates)
    st = ensemble_states(cfg, 2, 3, device=CPU)
    one = lambda: run_particles(cfg, p, st, seed=9, **RUN)
    chunked = lambda d, **kw: run_particles_checkpointed(
        cfg, p, st, seed=9, ckpt_dir=d, **RUN, **kw)
    return one, chunked


def _slots(runner, ck_runner, K):
    cfg = ParticleConfig(L=64, N=40 * K, init="fixed", scale_rates=False,
                         periodic=K == 1, site_capacity=K,
                         local_kernel_sigma=0.02)
    p = broadcast_params(cfg, beta=[0.8, 2.0], rate_diffusion=0.5,
                         rate_active=2.0, device=CPU)
    kw = dict(seed=4, device=CPU, n_tracers=40 * K, **RUN)
    one = lambda: runner(cfg, p, **kw)
    chunked = lambda d, **c: ck_runner(cfg, p, ckpt_dir=d, **kw, **c)
    return one, chunked


def _fused():
    return _slots(run_exclusion_sweep,
                  lambda *a, **kw: run_exclusion_sweep(*a, **kw), 3)


# T=0.12 at dt=1e-3: 120 steps, blocks of 10 (13 blocks, the last one the
# final iteration); chunks of 5 blocks end at steps 50 and 100, neither a
# multiple of the 15-step tracer window
PDE = dict(L=64, T=0.12, dt=1e-3, bc="periodic", active_model="bidirectional",
           gaussian_kernel=True, kernel_sigma=0.05, snapshot_interval=10,
           fft_kmax=None, tracer_window_time=0.015, n_tracers=16)


def _pde_inputs():
    cfg = PDEConfig(**PDE)
    full = lambda v: torch.full((2,), v)
    params = PDEParams(gamma=full(0.2), lam=full(0.6),
                       beta=torch.tensor([0.5, 2.0]))
    gen = torch.Generator()
    gen.manual_seed(5)
    rho_p, rho_m, tr = pde_initialize(cfg, gen, B=2, mode="homogeneous",
                                      noise=0.3, n_tracers=16, device=CPU)
    return cfg, params, rho_p, rho_m, tr, gen


def _pde():
    def one():
        *x, gen = _pde_inputs()
        return pde_solve_fused(*x, gen), gen.get_state()

    def chunked(d, **kw):
        *x, gen = _pde_inputs()
        kw["chunk_blocks"] = kw.pop("chunk_frames", 8)
        res = pde_solve_checkpointed(*x, gen, ckpt_dir=d, **kw)
        return None if res is None else (res, gen.get_state())

    return one, chunked


ROUTES = {
    "b1": lambda: _particles(),
    "torch": lambda: _particles(periodic=False),
    "tau_leap": lambda: _particles(site_capacity=3, local_kernel_sigma=0.02),
    "tau_leap-anchors-exits": lambda: _particles(
        site_capacity=3, periodic=False, anchor_positions=(0.3, 0.7),
        anchor_radius=0.05, exit_buffer=48),
    "lg": lambda: _slots(run_lattice_gas, run_lattice_gas_checkpointed, 1),
    "lgk": lambda: _slots(run_lattice_gas_k, run_lattice_gas_k_checkpointed,
                          3),
    "fused": _fused,
    "pde": _pde,
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_chunked_equals_one_piece(route, tmp_path):
    """Chunks of 5 units (12 frames: 5/5/2; the PDE's 13 blocks: 5/5/3)
    stitch to the run in one piece, bit for bit, on every route."""
    one, chunked = ROUTES[route]()
    want = one()
    got = chunked(tmp_path / "ck", chunk_frames=5)
    assert_same(want, got)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "chunk_00000.npz", "chunk_00001.npz", "chunk_00002.npz",
        "manifest.json"]


@pytest.mark.parametrize("route", list(ROUTES))
def test_resume_after_stop(route, tmp_path):
    """Stopped after one chunk (the call returns None, one chunk file on
    disk), a fresh call resumes and the result equals the run in one
    piece; the initial draws happen in chunk 0 only."""
    one, chunked = ROUTES[route]()
    d = tmp_path / "ck"
    assert chunked(d, chunk_frames=5, stop_after_chunks=1) is None
    assert (d / "chunk_00000.npz").exists()
    assert not (d / "chunk_00001.npz").exists()
    assert_same(one(), chunked(d, chunk_frames=5))


def test_routes_are_the_ones_named():
    """The particle routes of the table take the route their name says."""
    for name, route in (("b1", B1_ROUTE), ("torch", TORCH_ROUTE),
                        ("tau_leap", TAU_LEAP_ROUTE)):
        assert ROUTES[name]()[0]().engine == route


# ---------------------------------------------------------------------------
# the manifest guard
# ---------------------------------------------------------------------------

def _mf_args():
    cfg = ParticleConfig(L=64, N=48, init="fixed", scale_rates=False,
                         periodic=True, site_capacity=None,
                         local_kernel_sigma=0.0)
    p = broadcast_params(cfg, beta=[1.2], rate_diffusion=0.5,
                         rate_active=2.0, device=CPU)
    return cfg, p, ensemble_states(cfg, 1, 3, device=CPU)


def _mf_one():
    return run_particles(*_mf_args(), T=1.2, obs_dt=0.1, dt=0.01, seed=9)


def _mf_run(d, *, seed=9, T=1.2, record_fft=True, chunk_frames=5, **kw):
    """B1's route, one replica, checkpointed in ``d``."""
    return run_particles_checkpointed(
        *_mf_args(), T=T, obs_dt=0.1, dt=0.01, seed=seed,
        record_fft=record_fft, ckpt_dir=d, chunk_frames=chunk_frames, **kw)


@pytest.mark.parametrize("change", [dict(seed=10), dict(T=1.1),
                                    dict(record_fft=False)],
                         ids=["seed", "T", "record_fft"])
def test_foreign_run_is_refused(change, tmp_path):
    """A directory of another run (seed, horizon, recording flags) raises
    ValueError on resume and keeps its chunks; ``resume=False``
    overwrites it."""
    assert _mf_run(tmp_path, stop_after_chunks=1) is None
    with pytest.raises(ValueError, match="different run"):
        _mf_run(tmp_path, **change)
    assert (tmp_path / "chunk_00000.npz").exists()
    assert _mf_run(tmp_path, resume=False, **change) is not None


def test_device_is_hashed(tmp_path, monkeypatch):
    """A directory written on the CPU is refused by a run on the card: the
    run hash covers the device type (and the package and the route), so
    the same call with the device taken as ``cuda`` does not match."""
    assert _mf_run(tmp_path, stop_after_chunks=1) is None
    written = json.loads((tmp_path / "manifest.json").read_text())
    ident = ck.run_identity(B1_ROUTE, CPU)
    assert ident == {"package": "hydrolim_tpu_torch", "route": B1_ROUTE,
                     "device": "cpu"}
    on_cpu = ck.run_identity
    monkeypatch.setattr(ck, "run_identity", lambda route, device: dict(
        on_cpu(route, device), device="cuda"))
    with pytest.raises(ValueError, match="different run"):
        _mf_run(tmp_path)
    assert json.loads((tmp_path / "manifest.json").read_text()) == written
    assert (tmp_path / "chunk_00000.npz").exists()


def test_unreadable_manifest_refuses_resume_but_overwrites(tmp_path):
    """A manifest that does not parse cannot vouch for the chunks beside
    it: resume raises, ``resume=False`` starts over."""
    one = _mf_one
    assert _mf_run(tmp_path, stop_after_chunks=1) is None
    (tmp_path / "manifest.json").write_text("{not json")
    with pytest.raises(ValueError, match="unreadable manifest"):
        _mf_run(tmp_path)
    assert_same(one(), _mf_run(tmp_path, resume=False))


def test_resume_adopts_stored_chunk_layout(tmp_path):
    """The chunk size is an I/O knob, not physics: a resume with another
    ``chunk_frames`` keeps the stored layout and its completed prefix."""
    one = _mf_one
    assert _mf_run(tmp_path, stop_after_chunks=1) is None
    got = _mf_run(tmp_path, chunk_frames=3)
    assert_same(one(), got)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["chunk_frames"] == 5 and manifest["n_chunks"] == 3
    assert not (tmp_path / "chunk_00003.npz").exists()


def test_unvouched_chunks_never_stitch(tmp_path):
    """Chunk files without a manifest (relics of another run) are deleted,
    never stitched: the run starts over and equals the run in one piece."""
    one = _mf_one
    other = tmp_path / "other"
    assert _mf_run(other, seed=10, stop_after_chunks=1) is None
    d = tmp_path / "ck"
    d.mkdir()
    os.replace(other / "chunk_00000.npz", d / "chunk_00000.npz")
    assert_same(one(), _mf_run(d))


def test_resume_restores_the_carry_on_disk(tmp_path):
    """Once every chunk exists, a call runs nothing: a different initial
    state (not hashed; the seed is) yields the stored trajectory."""
    cfg, p, st = _mf_args()
    want = _mf_run(tmp_path)
    other = dataclasses.replace(st, pos=(st.pos + 7) % cfg.L)
    got = run_particles_checkpointed(cfg, p, other, T=1.2, obs_dt=0.1,
                                     dt=0.01, seed=9, ckpt_dir=tmp_path,
                                     chunk_frames=5)
    assert_same(want, got)


def test_cleanup_ckpt_dir(tmp_path):
    d = tmp_path / "ck"
    _mf_run(d)
    (d / "chunk_00099.tmp.npz").write_bytes(b"relic")   # kill-time relic
    assert cleanup_ckpt_dir(d) == 5
    assert not d.exists()
    assert cleanup_ckpt_dir(d) == 0                     # idempotent
    with pytest.raises(FileNotFoundError):
        cleanup_ckpt_dir(d, missing_ok=False)


def test_carry_dtypes_survive_the_npz(tmp_path):
    """Every carried field comes back with its dtype and device: int32
    slots, sites and seeds, bool masks, float32 fields and the generator's
    uint8 state."""
    _, chunked = ROUTES["fused"]()
    chunked(tmp_path, chunk_frames=5)
    _, carry = ck._load_chunk(tmp_path / "chunk_00002.npz", CPU)
    assert carry["slots"].dtype == torch.int32
    assert carry["seeds"].dtype == torch.int32
    assert carry["tags"].dtype == torch.int32
    assert carry["valid"].dtype == torch.bool
    assert isinstance(carry["gen"], torch.Generator)
    _, chunked = ROUTES["tau_leap-anchors-exits"]()
    chunked(tmp_path / "tau", chunk_frames=5)
    _, carry = ck._load_chunk(tmp_path / "tau" / "chunk_00002.npz", CPU)
    assert carry["exit_times"].dtype == torch.float32
    assert carry["exit_count"].dtype == torch.int32
    assert carry["bound"].dtype == torch.bool
    assert carry["seeds"] is None


# ---------------------------------------------------------------------------
# the facades
# ---------------------------------------------------------------------------

def _system(**over):
    kw = dict(L=64, xlim=1.0, rate_diffusion=0.5, rate_active=2.0, beta=1.2,
              init="fixed", N=48, scale_rates=False, local_kernel_sigma=0.0,
              periodic=True, site_capacity=1, k_on=0, k_off=0, k_exit=0,
              rng=11, device=CPU)
    kw.update(over)
    return ParticleSystem(**kw)


@pytest.mark.parametrize("engine", ["particle", "lattice_gas"])
def test_particle_system_run_checkpointed_equals_run(engine, tmp_path):
    """``ParticleSystem.run_checkpointed`` returns ``run``'s out dict on a
    system made with the same rng, ``'particle'`` (the τ-leap step here)
    and ``'lattice_gas'`` (the slot engine)."""
    want = _system().run(T=1.2, obs_dt=0.1, engine=engine)
    ps = _system()
    got = ps.run_checkpointed(T=1.2, obs_dt=0.1, ckpt_dir=tmp_path,
                              chunk_frames=5, engine=engine)
    assert ps.last_run_info["engine"] == (
        TAU_LEAP_ROUTE if engine == "particle" else "lgk_step")
    assert_same(want, got)
    with pytest.raises(AssertionError):
        ps.run_checkpointed(T=1.2, obs_dt=0.1, ckpt_dir=tmp_path,
                            engine="pallas")


def test_imexpde_solve_checkpointed_equals_solve(tmp_path):
    """``IMEXPDE.solve_checkpointed`` gives ``solve``'s output and leaves
    the facade's generator where ``solve`` does."""
    def facade():
        s = IMEXPDE(L=64, T=0.12, dt=1e-3, gamma=0.2, kernel_sigma=0.05,
                    gaussian_kernel=True, snapshot_interval=10, seed=3,
                    device=CPU)
        s.initialize(mode="homogeneous", noise=0.3, n_tracers=16)
        return s

    a, b = facade(), facade()
    a.solve()
    b.solve_checkpointed(ckpt_dir=tmp_path, chunk_blocks=4)
    assert_same(a.get_output(), b.get_output())
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------------------
# a real SIGKILL
# ---------------------------------------------------------------------------

_KILL_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params, ensemble_states
from hydrolim_tpu_torch.utils.checkpoint import run_particles_checkpointed

cfg = ParticleConfig(L=64, N=48, init="fixed", scale_rates=False,
                     periodic=True, site_capacity=3, local_kernel_sigma=0.0)
p = broadcast_params(cfg, beta=[0.8, 2.0], rate_diffusion=0.5,
                     rate_active=2.0, device="cpu")
st = ensemble_states(cfg, 2, 3, device="cpu")
assert "jax" not in sys.modules and "hydrolim_tpu" not in sys.modules
print("READY", flush=True)
run_particles_checkpointed(cfg, p, st, T=6.0, obs_dt=0.1, dt=0.01, seed=9,
                           ckpt_dir=sys.argv[2], chunk_frames=3)
print("DONE", flush=True)
"""


@pytest.mark.parametrize("kill_after", [0.2, 1.5])
def test_sigkill_mid_run_resumes_bit_identical(tmp_path, kill_after):
    """A child process that imports only the port runs a 60-frame τ-leap
    run in 3-frame chunks and is killed by SIGKILL at an arbitrary moment
    (possibly inside a write): the resume here completes the run, equal to
    the run in one piece bit for bit (the tmp + ``os.replace`` writes)."""
    d = tmp_path / "ck"
    child = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, REPO,
                              str(d)], stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "READY"
        time.sleep(kill_after)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    cfg = ParticleConfig(L=64, N=48, init="fixed", scale_rates=False,
                         periodic=True, site_capacity=3,
                         local_kernel_sigma=0.0)
    p = broadcast_params(cfg, beta=[0.8, 2.0], rate_diffusion=0.5,
                         rate_active=2.0, device=CPU)
    st = ensemble_states(cfg, 2, 3, device=CPU)
    run = dict(T=6.0, obs_dt=0.1, dt=0.01, seed=9)
    got = run_particles_checkpointed(cfg, p, st, ckpt_dir=d,
                                     chunk_frames=3, **run)
    assert_same(run_particles(cfg, p, st, **run), got)


# ---------------------------------------------------------------------------
# the persistence module
# ---------------------------------------------------------------------------

def test_config_hash_equals_the_jax_packages():
    from hydrolim_tpu.sweeps.persistence import config_hash as j_hash

    for cfg in ({"a": 1, "b": [1.5, 2], "c": {"z": None, "y": "s"}},
                {"beta": np.linspace(0, 3, 4), "n": np.int64(3),
                 "x": np.float32(0.25), "fn": np.mean},
                {"config": {"L": "64", "has_flip_rate_fn": "False"},
                 "params": {"beta": [0.5, 2.0]}, "T": 1.2}):
        assert config_hash(cfg) == j_hash(cfg)


def test_pytree_round_trip_and_cached_run(tmp_path):
    tree = {"a": np.arange(3, dtype=np.int32),
            "b": {"c": torch.ones(2, 2), "d": {"e": np.float32(2.5)}}}
    save_pytree(tree, tmp_path / "t.npz")
    back = load_pytree(tmp_path / "t.npz")
    assert back["a"].dtype == np.int32 and back["b"]["c"].shape == (2, 2)
    assert float(back["b"]["d"]["e"]) == 2.5
    calls = []

    def fn():
        calls.append(1)
        return {"x": np.arange(4)}

    for _ in range(2):
        out = cached_run(fn, config={"k": 1}, cache_dir=tmp_path / "c")
        np.testing.assert_array_equal(out["x"], np.arange(4))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------

def test_tau_leap_chunks_equal_jax_checkpointed_run(tmp_path):
    """The port's chunked τ-leap run, driven at the draws of the JAX key
    chain (``_draws``), equals JAX's ``run_particles_checkpointed``
    stitched frames: integer state and exit log equal, floats (m, rates'
    records) to 1e-6, the spectrum to 1e-6 of its DC bin."""
    from test_torch_tau_leap import JaxDraws

    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.particles.init import init_particles as j_init
    from hydrolim_tpu.sweeps.ensemble import broadcast_params as j_params
    from hydrolim_tpu.utils.checkpoint import (
        run_particles_checkpointed as j_ckpt,
    )

    kw = dict(L=64, N=48, init="fixed", scale_rates=False, periodic=False,
              site_capacity=3, local_kernel_sigma=0.02,
              anchor_positions=(0.3, 0.7), anchor_radius=0.05,
              exit_buffer=48)
    jcfg, cfg = JConfig(**kw), ParticleConfig(**kw)
    rates = dict(rate_diffusion=0.5, rate_active=2.0, k_on=20.0, k_off=2.0,
                 k_exit=10.0)
    jp = j_params(jcfg, beta=[1.5], **rates)
    jp1 = jax.tree.map(lambda a: a[0], jp)
    st0 = j_init(jcfg, jax.random.PRNGKey(3))
    run = dict(T=1.2, obs_dt=0.1, dt=0.1 / 4)           # 44 steps
    want = jax.device_get(j_ckpt(jcfg, jp1, st0, ckpt_dir=tmp_path / "j",
                                 chunk_frames=5, **run))
    batched = jax.tree.map(lambda a: np.asarray(a)[None],
                           jax.device_get(st0))
    draws = JaxDraws(jnp_key(st0.key), jcfg.n_buf, 44)
    got = run_particles_checkpointed(
        cfg, interop.particle_params(jp, device=CPU),
        interop.particle_state(batched, device=CPU), ckpt_dir=tmp_path / "p",
        chunk_frames=5, _draws=draws, **run)
    for name in got.frames._fields:
        p = getattr(got.frames, name)[0].numpy()
        j = np.asarray(getattr(want.frames, name))
        if p.dtype.kind in "iub":
            np.testing.assert_array_equal(p, j, err_msg=name)
        else:
            scale = np.abs(j).max() if name in ("fft_amp",
                                                "rho_hat_ri") else 1.0
            np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=name)
    fs, js = got.final_state, want.final_state
    for name in ("pos", "sigma", "wind", "alive", "bound", "exit_count",
                 "exit_pos", "exit_init_bin"):
        np.testing.assert_array_equal(getattr(fs, name)[0].numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    np.testing.assert_allclose(fs.exit_times[0].numpy(),
                               np.asarray(js.exit_times), rtol=1e-6)
    assert int(fs.exit_count[0]) > 0


def jnp_key(key):
    """One replica's key as the (1, 2) batch ``JaxDraws`` takes."""
    return jax.numpy.asarray(key)[None]


def test_lgk_chunks_equal_jax_checkpointed_run(tmp_path):
    """The port's ``run_lattice_gas_k_checkpointed`` from the JAX run's
    slots at its draws (``_slots0``, ``_draws``) equals JAX's
    ``run_lattice_gas_k_checkpointed``: tracer positions and final slots
    equal, floats to 1e-6 (the spectrum to 1e-6 of its DC bin)."""
    from test_torch_slot_runs import JaxDraws, _assert_frames_equal

    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.particles.lattice_gas_k import lgk_init as j_init
    from hydrolim_tpu.sweeps.ensemble import broadcast_params as j_params
    from hydrolim_tpu.utils.checkpoint import (
        run_lattice_gas_k_checkpointed as j_ckpt,
    )

    kw = dict(L=64, N=96, init="fixed", scale_rates=False,
              local_kernel_sigma=0.02, periodic=True, site_capacity=3,
              active_model="plus_forward")
    jcfg, cfg = JConfig(**kw), ParticleConfig(**kw)
    jp = j_params(jcfg, beta=[0.8, 2.0], rate_diffusion=1.0,
                  rate_active=3.0)
    key = jax.random.PRNGKey(9)
    run = dict(T=1.2, obs_dt=0.1, dt=0.0084)             # 12 frames × 12
    jframes, jsl = j_ckpt(jcfg, jp, key, ckpt_dir=tmp_path / "j",
                          chunk_frames=5, n_tracers=96, **run)
    sl0 = jax.vmap(lambda k: j_init(jcfg, jax.random.fold_in(k, 0)))(
        jax.random.split(key, 2))
    pframes, psl = run_lattice_gas_k_checkpointed(
        cfg, interop.particle_params(jp, device=CPU), device=CPU,
        ckpt_dir=tmp_path / "p", chunk_frames=5, n_tracers=96,
        _slots0=torch.tensor(np.asarray(sl0)),
        _draws=JaxDraws(key, 2, 3, 64, 132), **run)
    _assert_frames_equal(pframes, jframes)
    np.testing.assert_array_equal(psl.numpy(), np.asarray(jsl))


def test_jax_written_directory_is_refused(tmp_path):
    """A directory written by the JAX package's ``run_particles_
    checkpointed`` (threefry streams) is refused by the port with
    ValueError, and nothing of it is stitched or deleted."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.particles.init import init_particles as j_init
    from hydrolim_tpu.sweeps.ensemble import broadcast_params as j_params
    from hydrolim_tpu.utils.checkpoint import (
        run_particles_checkpointed as j_ckpt,
    )

    kw = dict(L=64, N=48, init="fixed", scale_rates=False, periodic=True,
              site_capacity=None, local_kernel_sigma=0.0)
    jcfg, cfg = JConfig(**kw), ParticleConfig(**kw)
    jp = j_params(jcfg, beta=[1.2], rate_diffusion=0.5, rate_active=2.0)
    st0 = j_init(jcfg, jax.random.PRNGKey(3))
    j_ckpt(jcfg, jax.tree.map(lambda a: a[0], jp), st0,
           ckpt_dir=tmp_path, chunk_frames=5, **RUN)
    before = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    batched = jax.tree.map(lambda a: np.asarray(a)[None],
                           jax.device_get(st0))
    with pytest.raises(ValueError, match="different run"):
        run_particles_checkpointed(
            cfg, interop.particle_params(jp, device=CPU),
            interop.particle_state(batched, device=CPU), ckpt_dir=tmp_path,
            chunk_frames=5, **RUN)
    assert {p.name: p.read_bytes() for p in tmp_path.iterdir()} == before
