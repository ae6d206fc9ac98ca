"""Exclusion sweep runner on kernel B3/B4 (the fused slot kernel).

Advances the (β-grid × replicas) batch one obs_dt frame per
``exclusion_multi_step`` call and computes the frame observables on the
device between calls, as ``sweeps/fast_meanfield.py`` does.  CUDA tensors
go through the kernel, CPU tensors through its plain version.

Tracer identity rides the slot payloads (sign = spin, magnitude = id), so
the per-particle displacement series behind D_eff come out exactly, with
no extra kernel state.

Supported configuration class (the reference flagship,
PARTICLE_solver_BIOLOGY_EXCLUSION.py:55-94): site exclusion with capacity
K ≤ 8, periodic or non-periodic, plus_forward or bidirectional hops,
global or Gaussian local m, default CW flip rate, no anchors, no crowding
suppression.  ``ckpt_dir=`` runs it in chunks of frames, resumable
(``FusedRun``); ``mesh=`` splits the batch over a sweep mesh.  The JAX
runner's ``r_batch=`` (its replica-row batch R of kernel B4) has no
counterpart: B3 runs one cluster per replica, so no draw shape depends on
R or on the mesh.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.fields.magnetization import build_mfield_op
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    MAX_K,
    build_smoothing_band,
    exclusion_multi_step,
)
from hydrolim_tpu_torch.particles.lattice_gas import (
    TRACER_INVALID,
    LatticeGasFrames,
    _lg_record_counts,
    frame_grid,
    stack_frames,
    top_keys,
    tracer_bits,
)
from hydrolim_tpu_torch.particles.lattice_gas_k import (
    lgk_init,
    run_lattice_gas_k,
)
from hydrolim_tpu_torch.parallel.mesh import pad_batch, shard_run, tree_map
from hydrolim_tpu_torch.sweeps.persistence import config_hash
from hydrolim_tpu_torch.utils.checkpoint import (
    _config_fields,
    _digest,
    _params_lists,
    run_chunked,
    run_identity,
    run_lattice_gas_k_checkpointed,
)


def is_fused_exclusion_path(config: ParticleConfig) -> bool:
    """True iff the fused kernel supports this configuration (the JAX
    package's ``is_pallas_exclusion_path``)."""
    return (config.exclusion
            and config.K <= MAX_K
            and config.anchor_positions is None
            and not config.crowding_suppresses_rates
            and config.flip_rate_fn is None)


def init_payload_slots(config: ParticleConfig, generator: torch.Generator,
                       rho0_plus=None, rho0_minus=None, *, B: int = 1,
                       device="cuda") -> torch.Tensor:
    """(B, K, L) int32 initial slots through ``lgk_init``, each particle's
    payload its sign (spin) times its flat slot index + 1 (its id)."""
    K, L = config.K, config.L
    ids = torch.arange(1, K * L + 1, dtype=torch.int32, device=device)
    return lgk_init(config, generator, rho0_plus, rho0_minus, B=B,
                    device=device) * ids.reshape(K, L)


def _record_fn(config: ParticleConfig, record_fft: bool, device="cuda"):
    mfield_op = build_mfield_op(config.L, config.dx,
                                config.local_kernel_sigma, config.periodic,
                                device)
    K, L = config.K, config.L

    def rec(slots: torch.Tensor, tags: torch.Tensor, valid: torch.Tensor):
        """(B, K, L) payload slots → batched frame observables and the raw
        tracer sites (B, n_t; −1 for invalid tags)."""
        counts_p = (slots > 0).sum(-2).to(torch.float32)
        counts_m = (slots < 0).sum(-2).to(torch.float32)
        frame = _lg_record_counts(config, mfield_op, counts_p, counts_m,
                                  record_fft)
        B = slots.shape[0]
        if tags.shape[-1] == 0:
            return frame, slots.new_zeros((B, 0))
        # id → site: scatter each payload's site into a table indexed by
        # |payload| (index 0 collects the empty slots and is never read:
        # tags are ≥ 1)
        ids = slots.abs().reshape(B, -1).long()
        site = torch.arange(L, dtype=torch.int32, device=slots.device)
        site = site.expand(B, K, L).reshape(B, -1)
        site_of = slots.new_zeros((B, K * L + 1)).scatter_(1, ids, site)
        raw = site_of.gather(1, tags.long())
        return frame, torch.where(valid, raw, -1)

    return rec


def _init_tags(slots0: torch.Tensor, generator: torch.Generator,
               n_tracers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-replica tracer ids: ``n_tracers`` distinct occupied payloads,
    chosen by random 31-bit keys in descending order (``top_keys``, the
    slot engines' tag law).  Returns ``(tags (B, n_t) int32, valid
    (B, n_t) bool)``: surplus tags (fewer occupied slots than requested)
    are invalid."""
    B = slots0.shape[0]
    flat = slots0.abs().reshape(B, -1)
    keys = torch.where(flat != 0, tracer_bits(flat.shape, generator,
                                              flat.device), 0)
    vals, idx = top_keys(keys, n_tracers)
    return flat.gather(1, idx).to(torch.int32), vals > 0


def unwrap_tracer_sites(raw: torch.Tensor, L: int,
                        periodic: bool) -> torch.Tensor:
    """(M, B, n_t) raw sites (−1 invalid, else in [0, L)) → unwrapped
    positions (int32, ``TRACER_INVALID`` where invalid), on ``raw``'s
    device.  Periodic wraps are resolved by minimal image per frame, valid
    while the per-frame |displacement| < L/2."""
    if raw.shape[-1] == 0:
        return raw.to(torch.int32)
    valid = raw >= 0
    raw = raw.long()
    if periodic and raw.shape[0] >= 2:
        dr = torch.remainder(raw[1:] - raw[:-1] + L // 2, L) - L // 2
        unwrapped = torch.cat([raw[:1], raw[:1] + dr.cumsum(0)], 0)
    else:
        unwrapped = raw
    return torch.where(valid, unwrapped,
                       int(TRACER_INVALID)).to(torch.int32)


class FusedRun:
    """The fixed parts of one fused-kernel run: the frame grid, the kernel
    scalars, the smoothing band and the recorder.  ``start`` draws the
    carry of frame 0 (payload slots, tracer tags and their mask, the
    kernel's Philox seeds, the generator); ``run_range`` advances frames
    [lo, hi) (frame f launches with ``step0 = (f − 1)·n_sub``) and returns
    their records and raw tracer sites (B, hi − lo, n_t) with the carry
    after them, so ranges stitch bit for bit given the carry."""

    route = "exclusion_multi_step"

    def __init__(self, config: ParticleConfig, params_b: ParticleParams, *,
                 T: float, obs_dt: float, dt: float, record_fft: bool,
                 n_tracers: int, device, b0: int = 0):
        self._kw = dict(T=T, obs_dt=obs_dt, dt=dt, record_fft=record_fft,
                        n_tracers=n_tracers)
        self.b0 = b0
        assert is_fused_exclusion_path(config), (
            "run_exclusion_sweep requires the fused-kernel configuration "
            f"class (K<={MAX_K} exclusion, no anchors/crowding, default "
            "flip rate)")
        self.config, self.params_b = config, params_b
        self.device = torch.device(device)
        self.n_frames, self.n_sub, self.dt_eff = frame_grid(T, obs_dt, dt)
        self.n_tracers = n_tracers
        L = config.L
        if config.periodic and n_tracers > 0:
            # per-frame minimal-image unwrapping is ambiguous once a frame's
            # expected event count (drift and both diffusion directions)
            # reaches L/2: fail loudly instead of folding displacements
            ev = float(torch.max(params_b.rate_active)
                       + 2.0 * torch.max(params_b.rate_diffusion))
            if ev * obs_dt >= L / 2:
                raise ValueError(
                    f"obs_dt={obs_dt} gives ~{ev * obs_dt:.0f} expected "
                    f"events per frame >= L/2={L // 2}: per-frame "
                    "minimal-image unwrapping of tracer winding would be "
                    "ambiguous — use a smaller obs_dt")
        self.scal = torch.stack([params_b.beta, params_b.rate_diffusion,
                                 params_b.rate_active], dim=1).to(
            device=self.device, dtype=torch.float32).contiguous()
        self.band = build_smoothing_band(config, self.device)
        self.rec = _record_fn(config, record_fft, self.device)

    def for_rows(self, params_b: ParticleParams, device, b0: int
                 ) -> "FusedRun":
        """The same run over rows [b0, b0 + len(params_b)) of the batch
        on ``device``: B3 keys their streams on their global index
        (``parallel.mesh.ShardedRun``)."""
        return FusedRun(self.config, params_b, **self._kw, device=device,
                        b0=b0)

    def start(self, seed: int, rho0_plus=None, rho0_minus=None) -> dict:
        config, dev = self.config, self.device
        B = self.params_b.beta.shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        slots = init_payload_slots(config, gen, rho0_plus, rho0_minus, B=B,
                                   device=dev)
        if self.n_tracers > 0:
            tags, valid = _init_tags(slots, gen, min(self.n_tracers,
                                                     config.K * config.L))
        else:
            tags = torch.zeros((B, 0), dtype=torch.int32, device=dev)
            valid = torch.zeros((B, 0), dtype=torch.bool, device=dev)
        seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen,
                              device=dev, dtype=torch.int32)
        return dict(slots=slots, tags=tags, valid=valid, seeds=seeds,
                    gen=gen)

    def run_range(self, carry: dict, lo: int, hi: int):
        config, n_sub = self.config, self.n_sub
        slots, tags, valid = carry["slots"], carry["tags"], carry["valid"]
        bidi = config.active_model == "bidirectional"
        records, raws = [], []

        def record(sl):
            frame, raw = self.rec(sl, tags, valid)
            records.append(frame)
            raws.append(raw)

        if lo == 0:
            record(slots)
        for f in range(max(lo, 1), hi):
            slots = exclusion_multi_step(
                self.scal, carry["seeds"], slots, self.band, k_steps=n_sub,
                dt=self.dt_eff, periodic=config.periodic,
                bidirectional=bidi, step0=(f - 1) * n_sub, b0=self.b0,
                generator=carry["gen"])
            record(slots)
        out = stack_frames(records, torch.stack(raws, dim=1))._asdict()
        out["raw"] = out.pop("tracer_pos")
        return out, dict(carry, slots=slots)

    def finish(self, records: dict, carry: dict):
        """(frames with the tracers unwrapped over the whole grid, the
        final slot spins) from the stitched records and the last carry."""
        tracer_pos = unwrap_tracer_sites(records["raw"].movedim(1, 0),
                                         self.config.L,
                                         self.config.periodic).movedim(0, 1)
        fields = {k: v for k, v in records.items() if k != "raw"}
        return (LatticeGasFrames(**fields, tracer_pos=tracer_pos),
                torch.sign(carry["slots"]).to(torch.int32))


def run_exclusion_sweep(config: ParticleConfig, params_b: ParticleParams, *,
                        T: float, obs_dt: float, dt: float, seed: int = 0,
                        device="cuda", rho0_plus=None, rho0_minus=None,
                        record_fft: bool = True, n_tracers: int = 0,
                        engine: str = "auto", mesh=None,
                        b_real: Optional[int] = None,
                        ckpt_dir=None, chunk_frames: int = 64,
                        resume: bool = True,
                        stop_after_chunks: Optional[int] = None
                        ) -> Optional[Tuple[LatticeGasFrames, torch.Tensor]]:
    """Fused-kernel exclusion sweep over the batch of ``params_b``.

    Returns batched ``LatticeGasFrames`` of tensors on ``device`` (leaves
    (B, M, …), ``tracer_pos`` unwrapped with ``TRACER_INVALID``) and the
    final (B, K, L) int32 slot spins.  All draws come from one
    ``torch.Generator`` seeded with ``seed`` on ``device``: the initial
    field, the tracer tags, the kernel's Philox seeds and, on the CPU, the
    plain version's bits.  The run is one ``FusedRun.run_range`` over
    every frame.

    ``ckpt_dir=`` makes the run preemption-safe (the JAX package's
    ``_run_fused_checkpointed``): the frames run in ``chunk_frames``-frame
    chunks, each chunk's records and raw tracer sites written atomically
    with the carry (payload slots, tags, seeds, the generator's state);
    frame f's Philox counter is ``(f − 1)·n_sub``, so the stitched result
    is bit-identical to the run in one piece, the tracers unwrapped over
    the whole grid after stitching.  Returns ``None`` when
    ``stop_after_chunks`` halted an incomplete run.

    ``engine`` takes the JAX package's names: ``'auto'``, ``'pallas'`` and
    ``'pallas_rb'`` run kernel B3 (B4's layout is B3's kernel here);
    ``'xla'`` runs the plain-torch K-slot engine, ``run_lattice_gas_k``
    (``run_lattice_gas_k_checkpointed`` under ``ckpt_dir=``), whose final
    slots are returned as spins (``exclusion_route`` names the route).

    ``mesh=`` (a 1-D sweep mesh, ``parallel.mesh.sweep_mesh``) splits the
    replica batch over the mesh's devices (``parallel.mesh.ShardedRun``):
    each block launches B3 on its rows with their global index ``b0``, so
    the result is the one-device run's.  Any B runs on any mesh (the
    runner pads to the mesh multiple); ``b_real=``, the JAX package's
    true replica count of a batch it padded, is taken as there: the
    initial state is drawn for the first ``b_real`` rows, and the pad rows
    of the result repeat the last real replica."""
    route = exclusion_route(engine)
    B_call = int(params_b.beta.shape[0])
    b_real = B_call if b_real is None else int(b_real)
    if not 0 < b_real <= B_call:
        raise ValueError(f"b_real={b_real} outside 1..{B_call}")
    params_real = tree_map(lambda x: x[:b_real] if isinstance(
        x, torch.Tensor) and x.ndim else x, params_b)
    if route == SLOT_ROUTE:
        kw = dict(T=T, obs_dt=obs_dt, dt=dt, seed=seed, device=device,
                  rho0_plus=rho0_plus, rho0_minus=rho0_minus,
                  record_fft=record_fft, n_tracers=n_tracers, mesh=mesh)
        if ckpt_dir is None:
            out = run_lattice_gas_k(config, params_real, **kw)
        else:
            out = run_lattice_gas_k_checkpointed(
                config, params_real, ckpt_dir=ckpt_dir,
                chunk_frames=chunk_frames, resume=resume,
                stop_after_chunks=stop_after_chunks, **kw)
        if out is None:
            return None
        frames, slots = out
        return pad_batch((frames, torch.sign(slots).to(torch.int32)),
                         B_call, b_real)
    run = FusedRun(config, params_real, T=T, obs_dt=obs_dt, dt=dt,
                   record_fft=record_fft, n_tracers=n_tracers, device=device)
    start = lambda: run.start(seed, rho0_plus, rho0_minus)
    ranged = shard_run(mesh, run, params_real)
    if ckpt_dir is None:
        records, carry = ranged.run_range(start(), 0, run.n_frames)
        return pad_batch(run.finish(records, carry), B_call, b_real)
    run_hash = config_hash({
        "fused_config": _config_fields(config),
        "params": _params_lists(params_b), "T": T, "obs_dt": obs_dt,
        "dt": dt, "seed": seed, "record_fft": record_fft,
        "n_tracers": n_tracers, "rho0_plus": _digest(rho0_plus),
        "rho0_minus": _digest(rho0_minus),
        **run_identity(run.route, run.device)})
    out = run_chunked(ckpt_dir, run_hash, what="fused exclusion run",
                      n_units=run.n_frames, chunk_size=chunk_frames,
                      size_key="chunk_frames", unit_key="n_frames",
                      resume=resume, stop_after_chunks=stop_after_chunks,
                      device=run.device, start=start,
                      run_range=ranged.run_range)
    return (None if out is None
            else pad_batch(run.finish(*out), B_call, b_real))


# the JAX package's engine names of the fused sweep
EXCLUSION_ENGINES = ("auto", "pallas", "pallas_rb", "xla")
SLOT_ROUTE = "lgk_step"


def exclusion_route(engine: str) -> str:
    """The route ``run_exclusion_sweep`` takes for a JAX engine name:
    ``'xla'`` the plain-torch K-slot engine, every other name kernel B3."""
    if engine not in EXCLUSION_ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return SLOT_ROUTE if engine == "xla" else FusedRun.route
