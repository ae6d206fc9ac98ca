"""Mid-run checkpoint / resume for long runs (preemption-safe).

The port of the JAX package's ``utils/checkpoint.py``.  A run's frame (or
snapshot-block) grid is cut into chunks; after each chunk its records and
the run's carry are written atomically.  The carry is everything the next
chunk reads: the state, the kernels' Philox seeds and the run's
``torch.Generator`` state (``get_state()``, a uint8 tensor).  A resumed
run restores the carry of the newest complete chunk and continues on the
same global grid, so the stitched result is bit-identical to the run in
one piece: every engine draws and counts by the global frame or step
index (the range runners ``particles.run.ParticleRun``,
``particles.lattice_gas.LgRun``, ``particles.lattice_gas_k.LgkRun``,
``sweeps.fast_exclusion.FusedRun``, ``pde.fast_solve.PDERun``).

Layout of ``ckpt_dir`` (the JAX package's)::

    manifest.json          {"run_hash", "n_frames", "chunk_frames", ...}
    chunk_00000.npz        frames__<field> records + carry__<field> carry
    chunk_00001.npz        ...

Chunk files are written atomically (``np.savez_compressed`` to a tmp file,
then ``os.replace``), so a kill at any point leaves a consistent prefix.
In a multi-process run (``parallel.distributed``) every process holds the
whole carry, the primary alone writes, and every process reads the
directory back (it must be one they share).
The manifest's ``run_hash`` covers the configuration, the parameters, the
grid, the recording flags, the seed or the initial state, and beyond the
JAX package's: the package, the route and the device type.  The JAX
package's threefry streams, the port's Philox streams on the card and the
plain versions' draws on the CPU are three different trajectories, so a
directory written by one is refused (``ValueError``) by the others, never
stitched.  The chunk size is not hashed: a resume adopts the stored one.

The chunk loop is pipelined: chunk c+1 is dispatched before chunk c is
written.  Chunk c's records and carry are copied to the host as soon as
its last launch is enqueued (into pinned memory, without blocking, with a
CUDA event recorded after the copies), and the generator's state is taken
at the same moment, before chunk c+1 draws; the write waits only on that
event.  ``WRITE_STATS`` counts the files, bytes and seconds of the writes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.parallel.distributed import is_primary, process_count
from hydrolim_tpu_torch.parallel.mesh import shard_run
from hydrolim_tpu_torch.parallel.spatial import sharded_run
from hydrolim_tpu_torch.particles.lattice_gas import LgRun
from hydrolim_tpu_torch.particles.lattice_gas_k import LgkRun
from hydrolim_tpu_torch.particles.run import (
    ParticleFrames,
    ParticleRun,
    ParticleRunResult,
    run_particles,
)
from hydrolim_tpu_torch.pde.fast_solve import PDERun
from hydrolim_tpu_torch.sweeps.persistence import config_hash

__all__ = ["run_particles_checkpointed", "pde_solve_checkpointed",
           "run_lattice_gas_k_checkpointed",
           "run_lattice_gas_checkpointed",
           "run_pde_ensemble_checkpointed",
           "run_particle_ensemble_checkpointed", "cleanup_ckpt_dir",
           "WRITE_STATS", "reset_write_stats"]

PACKAGE = "hydrolim_tpu_torch"

# What the chunk writes cost in this process: files, bytes on disk, and
# seconds spent waiting for a chunk's device work and its copy to the host
# (``fetch_s``), in ``np.savez_compressed`` (compression and the tmp write;
# wall and process CPU time) and in the rename.  ``reset_write_stats``
# zeroes them.
WRITE_STATS = dict(files=0, bytes=0, fetch_s=0.0, save_s=0.0,
                   save_cpu_s=0.0, rename_s=0.0)


def reset_write_stats() -> None:
    for k, v in WRITE_STATS.items():
        WRITE_STATS[k] = type(v)(0)


def run_identity(route: str, device) -> dict:
    """What the port adds to every run hash: the package, the route taken
    and the device type."""
    return {"package": PACKAGE, "route": route,
            "device": torch.device(device).type}


def _config_fields(config) -> dict:
    """A config dataclass as reprs, ``flip_rate_fn`` by its presence."""
    cfg = {f.name: repr(getattr(config, f.name))
           for f in dataclasses.fields(config) if f.name != "flip_rate_fn"}
    if hasattr(config, "flip_rate_fn"):
        cfg["has_flip_rate_fn"] = repr(config.flip_rate_fn is not None)
    return cfg


def _params_lists(params) -> dict:
    return {f.name: torch.as_tensor(getattr(params, f.name)).cpu().numpy()
            .tolist() for f in dataclasses.fields(params)}


def _digest(arr) -> Optional[str]:
    """Short SHA-256 of an array's bytes (numpy or torch), None for None."""
    if arr is None:
        return None
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _read_manifest(path: Path) -> Optional[dict]:
    """None when absent or unparseable (a crash of a non-atomic writer);
    callers decide whether unparseable-with-chunks is recoverable."""
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _write_manifest(path: Path, payload: dict) -> None:
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)


def _atomic_savez(path: Path, **arrays) -> None:
    tmp = path.with_suffix(".tmp.npz")
    t0, c0 = time.perf_counter(), time.process_time()
    np.savez_compressed(tmp, **arrays)
    t1, c1 = time.perf_counter(), time.process_time()
    size = tmp.stat().st_size
    os.replace(tmp, path)
    WRITE_STATS["files"] += 1
    WRITE_STATS["bytes"] += size
    WRITE_STATS["save_s"] += t1 - t0
    WRITE_STATS["save_cpu_s"] += c1 - c0
    WRITE_STATS["rename_s"] += time.perf_counter() - t1


def _chunk_path(ckpt_dir: Path, i: int) -> Path:
    return ckpt_dir / f"chunk_{i:05d}.npz"


def _resume_prefix(ckpt_dir: Path, run_hash: str, *, what: str,
                   resume: bool, chunk_size: int, n_units: int,
                   size_key: str, unit_key: str,
                   adopt_chunk_size: bool = True,
                   scan_prefix: bool = True, extra: Optional[dict] = None):
    """Shared manifest guard for every checkpoint driver.

    Validates an existing manifest (raising on an unreadable file or a
    foreign ``run_hash``), optionally adopts the stored chunk layout,
    deletes **unvouched** chunk files (without a verified manifest, any
    ``chunk_*.npz`` on disk is a relic of some other run and must never be
    stitched), writes the fresh manifest, and returns
    ``(chunk_size, n_chunks, done)`` where ``done`` is the longest
    consecutive complete-chunk prefix (0 when ``scan_prefix=False`` —
    callers with non-index chunk naming do their own per-chunk checks)."""
    manifest_path = ckpt_dir / "manifest.json"
    manifest = None
    if resume and manifest_path.exists():
        manifest = _read_manifest(manifest_path)
        if manifest is None:
            raise ValueError(
                f"unreadable manifest at {manifest_path} — cannot verify "
                f"the existing chunks belong to this {what}; pass "
                "resume=False to start over or use a fresh dir")
        if manifest.get("run_hash") != run_hash:
            raise ValueError(
                f"checkpoint at {ckpt_dir} belongs to a different {what} "
                f"(hash {manifest.get('run_hash')!r} != {run_hash!r}); "
                "pass resume=False to overwrite or use a fresh dir")
    if manifest is None:
        for p in ckpt_dir.glob("chunk_*.npz"):
            p.unlink()
    elif adopt_chunk_size:
        chunk_size = int(manifest.get(size_key, chunk_size))
    n_chunks = -(-n_units // chunk_size)
    done = 0
    if manifest is not None and scan_prefix:
        while done < n_chunks and _chunk_path(ckpt_dir, done).exists():
            done += 1
    _write_manifest(manifest_path,
                    {"run_hash": run_hash, size_key: chunk_size,
                     unit_key: n_units, "n_chunks": n_chunks,
                     **(extra or {})})
    return chunk_size, n_chunks, done


def _shared_prefix(ckpt_dir: Path, run_hash: str, **kw):
    """``_resume_prefix`` for every process of a run: the primary process
    alone checks the manifest, deletes relics and writes the manifest
    (``parallel.distributed.is_primary``), and its answer is broadcast to
    the others (the directory is one the processes share)."""
    if process_count() == 1:
        return _resume_prefix(ckpt_dir, run_hash, **kw)
    import torch.distributed as dist

    out = [_resume_prefix(ckpt_dir, run_hash, **kw) if is_primary()
           else None]
    dist.broadcast_object_list(out, src=0)
    return out[0]


def _barrier() -> None:
    """Every process of a multi-process run waits for the others (the
    primary's chunk files are on disk past it)."""
    if process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


# ---------------------------------------------------------------------------
# the chunk loop
# ---------------------------------------------------------------------------

class _HostCopy:
    """A chunk's records and carry on their way to the host: the copies are
    enqueued (non-blocking, into pinned memory) and an event recorded
    behind them when the object is made; ``arrays()`` waits for that
    event only.  A generator is saved as its state, taken at once."""

    def __init__(self, payload: dict, carry: dict):
        self.host, self.event = {}, None
        on_card = False
        for prefix, tree in (("frames__", payload), ("carry__", carry)):
            for name, v in tree.items():
                key = prefix + name
                if v is None:
                    self.host[f"none__{name}"] = torch.zeros(0)
                elif isinstance(v, torch.Generator):
                    self.host[f"gen__{name}"] = v.get_state()
                elif v.is_cuda:
                    h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    self.host[key] = h.copy_(v, non_blocking=True)
                    on_card = True
                else:
                    self.host[key] = v.detach().clone()
        if on_card:
            self.event = torch.cuda.Event()
            self.event.record()

    def arrays(self) -> dict:
        t0 = time.perf_counter()
        if self.event is not None:
            self.event.synchronize()
        out = {k: v.numpy() for k, v in self.host.items()}
        WRITE_STATS["fetch_s"] += time.perf_counter() - t0
        return out


def _load_chunk(path: Path, device):
    """(records as numpy arrays by field, carry by field with tensors on
    ``device``, generators rebuilt there and None where it was None)."""
    payload, carry = {}, {}
    with np.load(path) as z:
        for key in z.files:
            kind, name = key.split("__", 1)
            if kind == "frames":
                payload[name] = z[key]
            elif kind == "carry":
                carry[name] = torch.from_numpy(z[key]).to(device)
            elif kind == "gen":
                gen = torch.Generator(device=device)
                gen.set_state(torch.from_numpy(z[key]))
                carry[name] = gen
            else:
                carry[name] = None
    return payload, carry


def _pipelined_chunks(ckpt_dir: Path, carry, *, done: int, n_chunks: int,
                      chunk_size: int, n_units: int, run_chunk: Callable,
                      stop_after_chunks: Optional[int]):
    """Shared pipelined chunk loop: chunk c+1 is dispatched before chunk
    c's copy is written, so the card computes while the host compresses.
    Saves land strictly in order, so a kill at any point leaves the same
    consistent prefix as a serial loop.

    ``run_chunk(carry, lo, hi) -> (records, carry)`` runs units
    ``[lo, hi)``, each a dict of tensors (the carry may also hold None and
    generators).  Returns the final carry, or ``None`` when
    ``stop_after_chunks`` halted an incomplete run (the pending chunk is
    flushed first, preserving the prefix).  In a multi-process run only
    the primary process writes."""
    pending = None
    writes = is_primary()

    def _flush():
        nonlocal pending
        if pending is not None and writes:
            c_, copy = pending
            _atomic_savez(_chunk_path(ckpt_dir, c_), **copy.arrays())
            pending = None

    executed = 0
    for c in range(done, n_chunks):
        if stop_after_chunks is not None and executed >= stop_after_chunks:
            _flush()
            return None
        lo = c * chunk_size
        hi = min((c + 1) * chunk_size, n_units)
        records, carry = run_chunk(carry, lo, hi)
        copy = _HostCopy(records, carry) if writes else None
        _flush()
        pending = (c, copy)
        executed += 1
    _flush()
    return carry


def run_chunked(ckpt_dir, run_hash: str, *, what: str, n_units: int,
                chunk_size: int, size_key: str, unit_key: str,
                resume: bool, stop_after_chunks: Optional[int], device,
                start: Callable[[], dict], run_range: Callable,
                extra: Optional[dict] = None):
    """The checkpointed run of one range runner: ``start()`` makes the
    carry of unit 0 (it is called only when no chunk exists yet, so the
    initial draws happen once), ``run_range(carry, lo, hi)`` runs units
    [lo, hi).  Returns ``(records, carry)``: each record field stitched
    from every chunk on disk along axis 1 (the batch leads) as a tensor on
    ``device``, and the carry read back from the last chunk; or ``None``
    when ``stop_after_chunks`` halted an incomplete run."""
    if chunk_size < 1:
        raise ValueError(f"chunk size must be >= 1, got {chunk_size}")
    device = torch.device(device)
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    chunk_size, n_chunks, done = _shared_prefix(
        ckpt_dir, run_hash, what=what, resume=resume, chunk_size=chunk_size,
        n_units=n_units, size_key=size_key, unit_key=unit_key, extra=extra)
    carry = (_load_chunk(_chunk_path(ckpt_dir, done - 1), device)[1]
             if done > 0 else start())
    carry = _pipelined_chunks(ckpt_dir, carry, done=done, n_chunks=n_chunks,
                              chunk_size=chunk_size, n_units=n_units,
                              run_chunk=run_range,
                              stop_after_chunks=stop_after_chunks)
    _barrier()
    if carry is None:
        return None
    # stitch from disk, so the result is what a resumed process rebuilds
    parts = []
    for c in range(n_chunks):
        payload, carry = _load_chunk(_chunk_path(ckpt_dir, c), device)
        parts.append(payload)
    records = {k: torch.from_numpy(np.concatenate([p[k] for p in parts],
                                                  axis=1)).to(device)
               for k in parts[0]}
    return records, carry


def cleanup_ckpt_dir(ckpt_dir, *, missing_ok: bool = True) -> int:
    """Delete a checkpoint directory's chunk files, manifest, and any
    write-interrupted ``*.tmp.npz`` relics; returns the number of files
    removed.  Call after a checkpointed run has returned its stitched
    result and the caller has persisted what it needs.  The directory
    itself is removed when it ends up empty."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        if missing_ok:
            return 0
        raise FileNotFoundError(ckpt_dir)
    n = 0
    for pattern in ("chunk_*.npz", "chunk_*.tmp.npz", "manifest.json",
                    "manifest.json.tmp"):
        for p in ckpt_dir.glob(pattern):
            p.unlink()
            n += 1
    try:
        ckpt_dir.rmdir()          # only when nothing else lives there
    except OSError:
        pass
    return n


# ---------------------------------------------------------------------------
# particle engine (run_particles: B1, the torch fast path, the τ-leap step)
# ---------------------------------------------------------------------------

def _named(run_range: Callable) -> Callable:
    """A range runner that returns a NamedTuple of records, returning them
    as a dict by field."""

    def ranged(carry, lo, hi):
        records, carry = run_range(carry, lo, hi)
        return records._asdict(), carry

    return ranged


def _particles_chunked(what: str, tag: dict, config: ParticleConfig,
                       params: ParticleParams, state0, *, T, obs_dt, dt,
                       ckpt_dir, chunk_frames, record_pos, record_fft,
                       resume, stop_after_chunks, seed, engine, _draws,
                       mesh=None):
    run = ParticleRun(config, params, T=T, obs_dt=obs_dt, dt=dt,
                      record_pos=record_pos, record_fft=record_fft,
                      engine=engine, device=state0.pos.device, _draws=_draws)
    if run.n_frames == 0:
        return run_particles(config, params, state0, T=T, obs_dt=obs_dt,
                             dt=dt, record_pos=record_pos,
                             record_fft=record_fft, seed=seed, engine=engine,
                             mesh=mesh)
    run_hash = config_hash({
        **tag, "config": _config_fields(config),
        "params": _params_lists(params), "T": T, "obs_dt": obs_dt, "dt": dt,
        "record_pos": record_pos, "record_fft": record_fft, "seed": seed,
        "injected_draws": _draws is not None,
        **run_identity(run.route, run.device)})
    out = run_chunked(
        ckpt_dir, run_hash, what=what, n_units=run.n_frames,
        chunk_size=chunk_frames, size_key="chunk_frames",
        unit_key="n_frames", resume=resume,
        stop_after_chunks=stop_after_chunks, device=run.device,
        start=lambda: run.start(run.prepare(state0), seed),
        run_range=_named(shard_run(mesh, run, params).run_range),
        extra={"obs_dt": obs_dt, "T": T})
    if out is None:
        return None
    records, carry = out
    return ParticleRunResult(ParticleFrames(**records), run.state(carry),
                             run.route)


def run_particles_checkpointed(
        config: ParticleConfig, params: ParticleParams, state0, *, T: float,
        obs_dt: float, dt: float, ckpt_dir, chunk_frames: int = 64,
        record_pos: bool = True, record_fft: bool = True,
        resume: bool = True, stop_after_chunks: Optional[int] = None,
        seed: int = 0, engine: str = "auto", _draws=None, mesh=None
) -> Optional[ParticleRunResult]:
    """Checkpointed equivalent of :func:`run_particles` (same arguments,
    ``seed`` and ``engine`` included, and the same return on every route:
    B1, the torch fast path, the τ-leap step).

    Runs the frame grid in chunks of ``chunk_frames`` frames, writing an
    atomic checkpoint (the chunk's frames and the carry: state, B1's
    seeds, the generator's state) after each.  With ``resume=True``
    (default) an existing compatible checkpoint prefix is reused — only
    the missing chunks execute, and the manifest's stored chunk layout
    wins over ``chunk_frames``; ``resume=False`` discards any existing
    chunks and starts over.  The hash covers the seed, not ``state0``: a
    resume restores the carry on disk.

    ``stop_after_chunks=k`` executes at most ``k`` *new* chunks this call
    and returns ``None`` if the run is still incomplete (the test hook for
    simulated preemption; a real preemption is just a kill).

    Returns the stitched :class:`ParticleRunResult` (frames and final
    state on ``state0``'s device) once all chunks exist, bit-identical to
    :func:`run_particles` on the same inputs.  ``mesh=`` as in
    :func:`run_particles`: the carry on disk is the one-device run's, so a
    run stopped on one mesh resumes on another."""
    return _particles_chunked(
        "run", {}, config, params, state0, T=T, obs_dt=obs_dt, dt=dt,
        ckpt_dir=ckpt_dir, chunk_frames=chunk_frames, record_pos=record_pos,
        record_fft=record_fft, resume=resume,
        stop_after_chunks=stop_after_chunks, seed=seed, engine=engine,
        _draws=_draws, mesh=mesh)


def run_particle_ensemble_checkpointed(
        config: ParticleConfig, params_b: ParticleParams, states0, *,
        T: float, obs_dt: float, dt: float, ckpt_dir,
        chunk_frames: int = 64, record_pos: bool = True,
        record_fft: bool = True, resume: bool = True,
        stop_after_chunks: Optional[int] = None, seed: int = 0,
        engine: str = "auto", mesh=None) -> Optional[ParticleRunResult]:
    """Checkpointed equivalent of
    :func:`hydrolim_tpu_torch.sweeps.ensemble.run_particle_ensemble` on
    prebuilt batched initial states ``states0`` (its run's generator
    seeded with ``seed``): the (β × runs) batch advances through the frame
    grid in ``chunk_frames``-frame chunks, every replica's carry
    checkpointed after each, with the guarantees of
    :func:`run_particles_checkpointed` (``mesh=`` included).  The initial
    states are hashed by digest of each field."""
    tag = {"states0": {f.name: _digest(getattr(states0, f.name))
                       for f in dataclasses.fields(states0)}}
    return _particles_chunked(
        "particle ensemble", tag, config, params_b, states0, T=T,
        obs_dt=obs_dt, dt=dt, ckpt_dir=ckpt_dir, chunk_frames=chunk_frames,
        record_pos=record_pos, record_fft=record_fft, resume=resume,
        stop_after_chunks=stop_after_chunks, seed=seed, engine=engine,
        _draws=None, mesh=mesh)


# ---------------------------------------------------------------------------
# the slot engines (plain torch)
# ---------------------------------------------------------------------------

def _slot_chunked(run, tag: str, config, params_b, *, T, obs_dt, dt,
                  ckpt_dir, chunk_frames, seed, rho0_plus, rho0_minus,
                  record_fft, n_tracers, resume, stop_after_chunks, _init0,
                  _draws, mesh=None, occ_sharding=None):
    """Shared checkpoint driver of the slot engines (the JAX package's
    ``_run_lg_family_checkpointed``): ``run`` is the engine's range runner
    (``LgRun`` or ``LgkRun``); ``_init0`` the test-only initial field.
    Neither ``mesh`` nor ``occ_sharding`` is hashed: the carry on disk is
    the one-device run's."""
    if run.n_frames < 1:
        raise ValueError("T <= 0: nothing to checkpoint")
    run_hash = config_hash({
        f"{tag}_config": _config_fields(config),
        "params": _params_lists(params_b), "T": T, "obs_dt": obs_dt,
        "dt": dt, "record_fft": record_fft, "n_tracers": n_tracers,
        "rho0_plus": _digest(rho0_plus), "rho0_minus": _digest(rho0_minus),
        "seed": seed, "init0": _digest(_init0),
        "injected_draws": _draws is not None,
        **run_identity(run.route, run.device)})
    out = run_chunked(
        ckpt_dir, run_hash, what="lattice-gas run", n_units=run.n_frames,
        chunk_size=chunk_frames, size_key="chunk_frames",
        unit_key="n_frames", resume=resume,
        stop_after_chunks=stop_after_chunks, device=run.device,
        start=lambda: run.start(seed, rho0_plus, rho0_minus, _init0),
        run_range=_named(sharded_run(run, params_b, mesh=mesh,
                                     occ_sharding=occ_sharding).run_range))
    if out is None:
        return None
    records, carry = out
    return run.frames_type(**records), run.final(carry)


def run_lattice_gas_k_checkpointed(
        config, params_b, *, T: float, obs_dt: float, dt: float, ckpt_dir,
        chunk_frames: int = 64, seed: int = 0, device="cuda",
        rho0_plus=None, rho0_minus=None, record_fft: bool = True,
        n_tracers: int = 0, resume: bool = True,
        stop_after_chunks: Optional[int] = None, occ_sharding=None,
        mesh=None, _slots0=None, _draws=None):
    """Checkpointed equivalent of
    :func:`hydrolim_tpu_torch.particles.lattice_gas_k.run_lattice_gas_k`
    (same arguments and return: batched ``(frames, final_slots)`` on
    ``device``), or ``None`` when ``stop_after_chunks`` halted it.

    The batched frame grid runs in ``chunk_frames``-frame chunks with an
    atomic checkpoint of each chunk's frames plus the carry (slot field,
    tracer sites/slots/windings, the phantom-tag mask, the generator's
    state); the stitched result is bit-identical to the unsplit run.
    ``mesh=`` and ``occ_sharding=`` as in ``run_lattice_gas_k``; the carry
    on disk is the one-device run's, so a run stopped on a mesh or a
    lattice split resumes on another, or on none, bit for bit."""
    run = LgkRun(config, params_b, T=T, obs_dt=obs_dt, dt=dt,
                 record_fft=record_fft, n_tracers=n_tracers, device=device,
                 _draws=_draws)
    return _slot_chunked(
        run, "lgk", config, params_b, T=T, obs_dt=obs_dt, dt=dt,
        ckpt_dir=ckpt_dir, chunk_frames=chunk_frames, seed=seed,
        rho0_plus=rho0_plus, rho0_minus=rho0_minus, record_fft=record_fft,
        n_tracers=n_tracers, resume=resume,
        stop_after_chunks=stop_after_chunks, _init0=_slots0, _draws=_draws,
        mesh=mesh, occ_sharding=occ_sharding)


def run_lattice_gas_checkpointed(
        config, params_b, *, T: float, obs_dt: float, dt: float, ckpt_dir,
        chunk_frames: int = 64, seed: int = 0, device="cuda",
        rho0_plus=None, rho0_minus=None, record_fft: bool = True,
        n_tracers: int = 0, resume: bool = True,
        stop_after_chunks: Optional[int] = None, occ_sharding=None,
        mesh=None, _occ0=None, _draws=None):
    """Checkpointed equivalent of the K=1 engine
    :func:`hydrolim_tpu_torch.particles.lattice_gas.run_lattice_gas` —
    same contract and bit-identity guarantee as the K-slot variant."""
    run = LgRun(config, params_b, T=T, obs_dt=obs_dt, dt=dt,
                record_fft=record_fft, n_tracers=n_tracers, device=device,
                _draws=_draws)
    return _slot_chunked(
        run, "lg1", config, params_b, T=T, obs_dt=obs_dt, dt=dt,
        ckpt_dir=ckpt_dir, chunk_frames=chunk_frames, seed=seed,
        rho0_plus=rho0_plus, rho0_minus=rho0_minus, record_fft=record_fft,
        n_tracers=n_tracers, resume=resume,
        stop_after_chunks=stop_after_chunks, _init0=_occ0, _draws=_draws,
        mesh=mesh, occ_sharding=occ_sharding)


# ---------------------------------------------------------------------------
# PDE engine (kernel B2 in chunks of snapshot blocks)
# ---------------------------------------------------------------------------

def _pde_chunked(what: str, tag: str, config, params_b, rho_p0, rho_m0,
                 tracers0, generator: torch.Generator, *, ckpt_dir,
                 chunk_blocks: int, resume: bool, keep_snapshots: bool,
                 stop_after_chunks: Optional[int], mesh=None):
    run = PDERun(config, params_b, device=rho_p0.device,
                 keep_snapshots=keep_snapshots)
    run_hash = config_hash({
        f"{tag}_config": _config_fields(config),
        "params": _params_lists(params_b), "rho_p0": _digest(rho_p0),
        "rho_m0": _digest(rho_m0),
        "tracers0": {f.name: _digest(getattr(tracers0, f.name))
                     for f in dataclasses.fields(tracers0)},
        "generator0": _digest(generator.get_state()),
        "keep_snapshots": keep_snapshots,
        **run_identity(run.route, run.device)})
    out = run_chunked(
        ckpt_dir, run_hash, what=what, n_units=run.n_blocks,
        chunk_size=chunk_blocks, size_key="chunk_blocks",
        unit_key="n_blocks", resume=resume,
        stop_after_chunks=stop_after_chunks, device=run.device,
        start=lambda: run.start(rho_p0, rho_m0, tracers0, generator),
        run_range=shard_run(mesh, run, params_b).run_range)
    if out is None:
        return None
    records, carry = out
    # the caller's generator ends where the run in one piece leaves it
    generator.set_state(carry["gen"].get_state())
    return run.finish(records, carry)


def pde_solve_checkpointed(config, params, rho_p0, rho_m0, tracers0,
                           generator: torch.Generator, *, ckpt_dir,
                           chunk_blocks: int = 8, resume: bool = True,
                           stop_after_chunks: Optional[int] = None,
                           keep_snapshots: bool = True):
    """Checkpointed equivalent of
    :func:`hydrolim_tpu_torch.pde.fast_solve.pde_solve_fused` (kernel B2
    on the card, its plain version on the CPU; the port's one PDE law).

    The snapshot-block grid (``ceil((nsteps + 1) / snapshot_interval)``
    blocks, the last one holding the final record-only iteration) runs in
    chunks of ``chunk_blocks`` blocks, writing each chunk's per-step
    records and snapshots plus the carry (fields, tracers and their
    displacement ring, B2's seeds, the generator's state) atomically.
    Block n0 launches with ``step0 = n0·interval`` and the ring slot and
    D_eff window are functions of the global step, so the stitched result
    is bit-identical to an uninterrupted solve, also across a chunk edge
    that is not a multiple of the tracer window.  ``generator`` ends in
    the state the solve in one piece leaves it in.  Returns a
    ``PDESolveResult``, or ``None`` when ``stop_after_chunks`` halted an
    incomplete run."""
    return _pde_chunked("PDE solve", "pde", config, params, rho_p0, rho_m0,
                        tracers0, generator, ckpt_dir=ckpt_dir,
                        chunk_blocks=chunk_blocks, resume=resume,
                        keep_snapshots=keep_snapshots,
                        stop_after_chunks=stop_after_chunks)


def run_pde_ensemble_checkpointed(config, params_b, rho_p0, rho_m0,
                                  tracers0, generator: torch.Generator, *,
                                  ckpt_dir, chunk_blocks: int = 8,
                                  resume: bool = True,
                                  keep_snapshots: bool = True,
                                  stop_after_chunks: Optional[int] = None,
                                  mesh=None):
    """Checkpointed equivalent of the batched solve inside
    :func:`hydrolim_tpu_torch.sweeps.pde_sweeps.run_pde_ensemble`: the
    whole (β × runs) batch advances together, as in
    :func:`pde_solve_checkpointed`.  ``keep_snapshots=False`` stores
    zero-width snapshot stacks in the chunk files (the sweep drivers
    discard them); the flag is part of the run hash, so chunks of mixed
    snapshot width never stitch.  ``mesh=`` splits the batch over a sweep
    mesh (``pde_solve_fused``); the carry on disk is the one-device
    run's."""
    return _pde_chunked("PDE ensemble", "pde_ensemble", config, params_b,
                        rho_p0, rho_m0, tracers0, generator,
                        ckpt_dir=ckpt_dir, chunk_blocks=chunk_blocks,
                        resume=resume, keep_snapshots=keep_snapshots,
                        stop_after_chunks=stop_after_chunks, mesh=mesh)
