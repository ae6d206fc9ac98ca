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
suppression.  The JAX runner's ``mesh=``, ``ckpt_dir=`` and ``r_batch=``
options are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

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
from hydrolim_tpu_torch.particles.lattice_gas_k import lgk_init


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


def run_exclusion_sweep(config: ParticleConfig, params_b: ParticleParams, *,
                        T: float, obs_dt: float, dt: float, seed: int = 0,
                        device="cuda", rho0_plus=None, rho0_minus=None,
                        record_fft: bool = True, n_tracers: int = 0
                        ) -> Tuple[LatticeGasFrames, torch.Tensor]:
    """Fused-kernel exclusion sweep over the batch of ``params_b``.

    Returns batched ``LatticeGasFrames`` of tensors on ``device`` (leaves
    (B, M, …), ``tracer_pos`` unwrapped with ``TRACER_INVALID``) and the
    final (B, K, L) int32 slot spins.  All draws come from one ``torch.Generator``
    seeded with ``seed`` on ``device``: the initial field, the tracer tags,
    the kernel's Philox seeds and, on the CPU, the plain version's bits.
    """
    assert is_fused_exclusion_path(config), (
        "run_exclusion_sweep requires the fused-kernel configuration class "
        f"(K<={MAX_K} exclusion, no anchors/crowding, default flip rate)")
    device = torch.device(device)
    B = params_b.beta.shape[0]
    K, L = config.K, config.L
    M, n_sub, dt_eff = frame_grid(T, obs_dt, dt)

    if config.periodic and n_tracers > 0:
        # per-frame minimal-image unwrapping is ambiguous once a frame's
        # expected event count (drift and both diffusion directions)
        # reaches L/2: fail loudly instead of folding displacements
        ev = float(torch.max(params_b.rate_active)
                   + 2.0 * torch.max(params_b.rate_diffusion))
        if ev * obs_dt >= L / 2:
            raise ValueError(
                f"obs_dt={obs_dt} gives ~{ev * obs_dt:.0f} expected events "
                f"per frame >= L/2={L // 2}: per-frame minimal-image "
                "unwrapping of tracer winding would be ambiguous — use a "
                "smaller obs_dt")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    slots = init_payload_slots(config, gen, rho0_plus, rho0_minus, B=B,
                               device=device)
    if n_tracers > 0:
        tags, valid = _init_tags(slots, gen, min(n_tracers, K * L))
    else:
        tags = torch.zeros((B, 0), dtype=torch.int32, device=device)
        valid = torch.zeros((B, 0), dtype=torch.bool, device=device)

    scal = torch.stack([params_b.beta, params_b.rate_diffusion,
                        params_b.rate_active], dim=1).to(
        device=device, dtype=torch.float32).contiguous()
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=device,
                          dtype=torch.int32)
    band = build_smoothing_band(config, device)
    bidi = config.active_model == "bidirectional"
    rec = _record_fn(config, record_fft, device)

    records, raws = [], []

    def record(sl):
        frame, raw = rec(sl, tags, valid)
        records.append(frame)
        raws.append(raw)

    record(slots)
    for f in range(1, M):
        slots = exclusion_multi_step(
            scal, seeds, slots, band, k_steps=n_sub, dt=dt_eff,
            periodic=config.periodic, bidirectional=bidi,
            step0=(f - 1) * n_sub, generator=gen)
        record(slots)

    tracer_pos = unwrap_tracer_sites(torch.stack(raws), L,    # (M, B, n_t)
                                     config.periodic).movedim(0, 1)
    return stack_frames(records, tracer_pos), torch.sign(slots).to(
        torch.int32)
