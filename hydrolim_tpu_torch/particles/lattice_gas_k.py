"""Site-centric lattice-gas engine for any capacity K ≥ 1: the slot field.

The port of the JAX package's ``particles/lattice_gas_k.py``.  The state is
(B, K, L) int32 slots per batch, slot axis first: 0 = empty, ±1 = an
unbound particle (sign = spin), ±2 = a bound one.  ``slots_from_particles``
packs particles into slots by rank within their site, and ``lgk_init``
draws the initial field through the particle initializers.

``lgk_step`` runs the reference's channels (PARTICLE_solver_CLASS.py:
259-351): CW flips, diffusion and active hops gated by site freeness
occ(x±1) < K and by walls, optional crowding suppression (1 − occ/K), and
with anchors bind, unbind, immobilisation and absorbing exit.  Each site
admits its free capacity's worth of the ≤ 2K incoming candidates by K
rounds of a cross-slot min over unique random priorities; a stable
compaction keeps the nonzero slots front-packed, so a tracer's new slot is
the count of nonzero entries before it in [stayers | right-in | left-in].

``run_lattice_gas_k`` and ``run_lattice_gas_anchored`` are the runs (the
anchored one with a fixed-size absorbing-exit log).  Plain eager torch: a
step is some hundred small launches on the card (PERF.md); kernel B3/B4 is
the fused route for the configurations it covers.

Where the port departs from the JAX arithmetic, by necessity:

- No unsigned 32-bit arithmetic: CUDA torch lacks most ``uint32`` ops, so
  priorities ``(bits & 0xFFFE0000) | slot_id`` and the empty sentinel
  0xFFFFFFFF are held in int64 (same order, same values).
- m is ``ops.exclusion_kernel.band_m``, kernel B3's law and summation
  order, so that this step equals B3 at the same bits; one ulp of m can
  move an event across its threshold.
- Draws come from a ``torch.Generator``; ``_inject`` / ``_draws`` take the
  JAX run's draws in the tests.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.fields.magnetization import build_mfield_op
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    SmoothingBand,
    band_m,
    build_smoothing_band,
)
from hydrolim_tpu_torch.particles.init import init_particles
from hydrolim_tpu_torch.particles.lattice_gas import (
    LatticeGasFrames,
    _lg_record_counts,
    follow_tracers,
    frame_grid,
    rate_col,
    stack_frames,
    top_keys,
    tracer_bits,
    tracer_record,
)

EMPTY_PRIO = 0xFFFFFFFF          # no candidate: after every priority
_PRIO_HI = 0xFFFE0000            # 15 random high bits above the slot id


def _roll(x, shift):
    return torch.roll(x, shift, -1)


@functools.lru_cache(maxsize=8)
def _slot_ids(K: int, L: int, device: torch.device) -> torch.Tensor:
    return torch.arange(K * L, dtype=torch.int64, device=device).reshape(K, L)


def slot_priorities(bits: torch.Tensor) -> torch.Tensor:
    """Unique priorities from (…, K, L) int64 random bits: the high 15
    bits random, the low 17 the flat slot id."""
    K, L = bits.shape[-2:]
    return (bits & _PRIO_HI) | _slot_ids(K, L, bits.device)


def lgk_step(config: ParticleConfig, params: ParticleParams,
             band: Optional[SmoothingBand], slots: torch.Tensor, dt: float,
             *, generator: Optional[torch.Generator] = None,
             is_anchor: Optional[torch.Tensor] = None, _inject=None):
    """One synchronous Δt step on the (…, K, L) slot field (JAX
    ``lattice_gas_k.py:57``).  Params are (B,) or scalar tensors; ``band``
    the local-m smoothing (``build_smoothing_band``), None for global m.

    With ``is_anchor`` (bool (L,)) the full channel set runs: bind (σ=−1,
    unbound, on an anchor, occ < K counting the particle itself: the
    reference's quirk that makes binding impossible at K=1), unbind,
    anchored immobilisation and absorbing exit.

    Draws: a uniform and 32 random bits per slot from ``generator``;
    ``_inject=(u, prio)``, (…, K, L) float32 uniforms and int64 unique
    priorities, replaces both.  The thresholds follow the JAX engine's
    arithmetic (t2 = t1 + (r_dif + r_act)·Δt; kernel B3 adds r_dif·Δt and
    r_act·Δt — the two round alike at most rates, not at all).

    Returns ``(slots_new, (acc_right_src, acc_left_src, flipped, new_k),
    exiting)``: movement and flip flags in the source layout, each slot's
    destination slot index (tracer tracking) and the per-slot exit mask."""
    K, L = config.K, config.L
    assert slots.shape[-2:] == (K, L)
    f32 = torch.float32
    dev = slots.device
    dt32 = torch.tensor(dt, dtype=f32, device=dev)

    occupied = slots != 0
    bound = slots.abs() == 2
    is_plus = slots > 0
    is_minus = slots < 0
    s_f = torch.sign(slots).to(f32)
    counts_p = is_plus.sum(-2).to(f32)
    counts_m = is_minus.sum(-2).to(f32)
    occ_tot = counts_p + counts_m                       # (…, L)

    m_field = band_m(counts_p - counts_m, occ_tot, band)[..., None, :]
    flip_fn = config.flip_rate_fn or (lambda s, m, b: torch.exp(-b * s * m))
    c = torch.where(occupied, flip_fn(s_f, m_field, rate_col(params.beta, 2)),
                    0.0)

    # site-level freeness of the ±1 targets (reference :299-305)
    right_free = _roll(occ_tot, -1) < K
    left_free = _roll(occ_tot, 1) < K
    if not config.periodic:
        idx = torch.arange(L, device=dev)
        right_free = right_free & (idx < L - 1)
        left_free = left_free & (idx > 0)
    right_free = right_free[..., None, :]
    left_free = left_free[..., None, :]

    r_dif = rate_col(params.rate_diffusion, 2)
    r_act = rate_col(params.rate_active, 2)
    rate_left = r_dif * (occupied & left_free)
    rate_right = r_dif * (occupied & right_free)
    act_right = is_plus & right_free
    # plus_forward: only σ=+1 hops actively, to the right (:317-319)
    act_left = (is_minus & left_free if config.active_model ==
                "bidirectional" else torch.zeros_like(is_plus))
    if config.crowding_suppresses_rates:
        rfrac = (1.0 - _roll(occ_tot, -1) / K).clamp(0.0, 1.0)[..., None, :]
        lfrac = (1.0 - _roll(occ_tot, 1) / K).clamp(0.0, 1.0)[..., None, :]
        rate_left = rate_left * lfrac
        rate_right = rate_right * rfrac
        rate_right = rate_right + r_act * act_right * rfrac
        rate_left = rate_left + r_act * act_left * lfrac
    else:
        rate_right = rate_right + r_act * act_right
        rate_left = rate_left + r_act * act_left

    # anchor channels (:262-267, :307-312, :342-348)
    rate_bind = rate_unbind = rate_exit = 0.0
    if is_anchor is not None:
        anc = is_anchor.to(dev)
        if config.suppress_flip_when_bound:
            c = torch.where(bound, 0.0, c)
        anchored = is_minus & anc & bound
        if config.immobilize_when_anchored:
            rate_left = torch.where(anchored, 0.0, rate_left)
            rate_right = torch.where(anchored, 0.0, rate_right)
            rate_exit = rate_col(params.k_exit, 2) * anchored
        bind_ok = (~bound) & is_minus & anc & (occ_tot < K)[..., None, :]
        rate_bind = rate_col(params.k_on, 2) * bind_ok
        rate_unbind = rate_col(params.k_off, 2) * bound

    # per-slot event draw: [left, right, flip, bind, unbind, exit], nothing
    t1 = rate_left * dt32
    t2 = t1 + rate_right * dt32
    t3 = t2 + c * dt32
    t4 = t3 + rate_bind * dt32
    t5 = t4 + rate_unbind * dt32
    t6 = t5 + rate_exit * dt32
    assert K * L < (1 << 17), "slot priority pack supports K*L < 131072"
    if _inject is None:
        u = torch.rand(slots.shape, generator=generator, device=dev,
                       dtype=f32)
        prio = slot_priorities(torch.randint(
            0, 2 ** 32, slots.shape, generator=generator, device=dev,
            dtype=torch.int64))
    else:
        u, prio = _inject
    ev_left = u < t1
    ev_right = (u >= t1) & (u < t2)
    ev_flip = (u >= t2) & (u < t3)
    ev_bind = (u >= t3) & (u < t4)
    ev_unbind = (u >= t4) & (u < t5)
    ev_exit = (u >= t5) & (u < t6)

    right_prio = torch.where(ev_right, prio, EMPTY_PRIO)
    left_prio = torch.where(ev_left, prio, EMPTY_PRIO)

    # candidates into site j: right-movers of j−1, left-movers of j+1;
    # admission = the free capacity's smallest priorities, K rounds of a
    # cross-slot min (unique priorities: the same as sort-and-threshold)
    cand = torch.cat([_roll(right_prio, 1), _roll(left_prio, -1)], -2)
    free = (K - occ_tot)[..., None, :]
    accept = torch.zeros_like(cand, dtype=torch.bool)
    for r in range(K):
        cur_min = cand.min(-2, keepdim=True).values
        win = (cand == cur_min) & (cand != EMPTY_PRIO) & (free > r)
        accept = accept | win
        cand = torch.where(win, EMPTY_PRIO, cand)
    acc_right_in = accept[..., :K, :]                    # arrived from j−1
    acc_left_in = accept[..., K:, :]                     # arrived from j+1

    # map back to source layout
    acc_right_src = _roll(acc_right_in, -1)
    acc_left_src = _roll(acc_left_in, 1)

    leaver = acc_right_src | acc_left_src
    exiting = ev_exit & ~leaver
    stay = torch.where(leaver | exiting, 0, slots)
    flipped = ev_flip & ~leaver
    stay = torch.where(flipped, -stay, stay)            # flip preserves bound
    stay = torch.where(ev_bind & ~leaver, 2 * stay, stay)     # ±1 → ±2
    stay = torch.where(ev_unbind & ~leaver, torch.sign(stay), stay)  # ±2→±1

    right_in = torch.where(acc_right_in, _roll(slots, 1), 0)
    left_in = torch.where(acc_left_in, _roll(slots, -1), 0)
    combined = torch.cat([stay, right_in, left_in], -2)       # (…, 3K, L)

    # stable compaction: nonzero slots first in order; the spare row 3K
    # takes the zeros (and anything past K, as the JAX select drops it)
    nz = combined != 0
    nzb = nz.cumsum(-2) - nz.to(torch.int64)           # exclusive count
    dest = torch.where(nz, nzb, 3 * K)
    packed = combined.new_zeros(combined.shape[:-2] + (3 * K + 1, L))
    packed.scatter_(-2, dest, combined)
    slots_new = packed[..., :K, :]

    # tracer map: destination slot = #nonzeros before the combined
    # position (stayers at q=k, right-in at q=K+k, left-in at q=2K+k);
    # a mover's count lives at its destination site, rolled back here
    new_k = torch.where(
        acc_right_src, _roll(nzb[..., K:2 * K, :], -1),
        torch.where(acc_left_src, _roll(nzb[..., 2 * K:, :], 1),
                    nzb[..., :K, :])).to(torch.int32)
    return slots_new, (acc_right_src, acc_left_src, flipped, new_k), exiting


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def slots_from_particles(config: ParticleConfig, pos: torch.Tensor,
                         sigma: torch.Tensor,
                         alive: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(..., n) particle arrays → (..., K, L) int32 slot field: the r-th
    particle of a site (in buffer order) fills slot r."""
    K, L = config.K, config.L
    lead, n = pos.shape[:-1], pos.shape[-1]
    pos = pos.reshape(-1, n).long()
    sigma = sigma.reshape(-1, n).to(torch.int32)
    if alive is None:
        alive = torch.ones_like(pos, dtype=torch.bool)
    alive = alive.reshape(-1, n)
    pos = torch.where(alive, pos, L)                     # dead → column L
    pos_s, order = torch.sort(pos, dim=-1, stable=True)
    sig_s = torch.where(alive.gather(-1, order), sigma.gather(-1, order), 0)
    counts = torch.zeros((pos.shape[0], L + 1), dtype=torch.long,
                         device=pos.device)
    counts.scatter_add_(1, pos_s, torch.ones_like(pos_s))
    seg_start = counts.cumsum(-1) - counts
    rank = torch.arange(n, device=pos.device) - seg_start.gather(-1, pos_s)
    flat = torch.zeros((pos.shape[0], K * (L + 1)), dtype=torch.int32,
                       device=pos.device)
    flat.scatter_(1, rank.clamp(0, K - 1) * (L + 1) + pos_s, sig_s)
    return flat.reshape(*lead, K, L + 1)[..., :L].contiguous()


def lgk_init(config: ParticleConfig, generator: torch.Generator,
             rho0_plus=None, rho0_minus=None, *, B: int = 1,
             device="cuda") -> torch.Tensor:
    """(B, K, L) initial slot spins through the particle initializers (the
    same law in both init modes; Poisson profiles (L,) or (B, L))."""
    st = init_particles(config, generator, rho0_plus, rho0_minus, B=B,
                        device=device)
    return slots_from_particles(config, st.pos, st.sigma, st.alive)


def _init_tracers_k(slots0: torch.Tensor, bits: torch.Tensor,
                    n_tracers: int):
    """``n_tracers`` distinct occupied (slot, site) entries per replica by
    descending random key over the flat slot-major index (JAX
    ``lattice_gas_k.py:272``): ``(sites, slots, valid)``, each (B, n);
    tags past the occupied count are phantoms (invalid)."""
    B, K, L = slots0.shape
    keys = torch.where(slots0.reshape(B, -1) != 0, bits, 0)
    vals, idx = top_keys(keys, n_tracers)
    return ((idx % L).to(torch.int32), (idx // L).to(torch.int32),
            vals > 0)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def _initial_slots(config, gen, rho0_plus, rho0_minus, B, device, _slots0):
    if _slots0 is not None:
        return _slots0.to(device)
    return lgk_init(config, gen, rho0_plus, rho0_minus, B=B, device=device)


def _slot_recorder(config: ParticleConfig, record_fft: bool, device):
    mfield_op = build_mfield_op(config.L, config.dx,
                                config.local_kernel_sigma, config.periodic,
                                device)

    def rec(slots):
        # bound ±2 particles count with their spin
        return _lg_record_counts(
            config, mfield_op, (slots > 0).sum(-2).to(torch.float32),
            (slots < 0).sum(-2).to(torch.float32), record_fft)

    return rec


def run_lattice_gas_k(config: ParticleConfig, params_b: ParticleParams, *,
                      T: float, obs_dt: float, dt: float, seed: int = 0,
                      device="cuda", rho0_plus=None, rho0_minus=None,
                      record_fft: bool = True, n_tracers: int = 0,
                      _slots0: Optional[torch.Tensor] = None, _draws=None
                      ) -> Tuple[LatticeGasFrames, torch.Tensor]:
    """The K-slot engine over the batch of ``params_b`` (JAX
    ``lattice_gas_k.py:421``): batched frames (leaves (B, M, …) on
    ``device``; tagged tracers' unwrapped positions with
    ``TRACER_INVALID`` for phantoms) and the final (B, K, L) slots.
    ``rho0_plus/minus`` are (L,) or per-replica (B, L) Poisson profiles
    (the (N, β) double sweep).  All draws come from one generator seeded
    with ``seed``: the initial field, the tracer keys, then each step's.

    Test-only: ``_slots0`` replaces the initial field and ``_draws`` the
    draws (``tracer_bits(shape)`` and ``step(i)`` → ``_inject`` of global
    step i)."""
    assert config.exclusion, "lattice-gas engines require site_capacity"
    assert config.anchor_positions is None, (
        "anchors run on run_lattice_gas_anchored")
    device = torch.device(device)
    B = params_b.beta.shape[0]
    K, L = config.K, config.L
    M, n_sub, dt_eff = frame_grid(T, obs_dt, dt)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    slots = _initial_slots(config, gen, rho0_plus, rho0_minus, B, device,
                           _slots0)
    n_t = min(n_tracers, K * L)
    bits = (tracer_bits((B, K * L), gen, device) if _draws is None
            else _draws.tracer_bits((B, K * L)))
    site, slot, valid = _init_tracers_k(slots, bits, n_t)
    wind = torch.zeros_like(site)
    band = build_smoothing_band(config, device)
    rec = _slot_recorder(config, record_fft, device)

    frames = [rec(slots)]
    tracks = [tracer_record(site, wind, valid, L)]
    for f in range(1, M):
        for s in range(n_sub):
            inject = (None if _draws is None
                      else _draws.step((f - 1) * n_sub + s))
            slots, (mr, ml, _, new_k), _ = lgk_step(
                config, params_b, band, slots, dt_eff, generator=gen,
                _inject=inject)
            if n_t:
                flat = (slot * L + site).long()
                take = lambda a: a.reshape(B, -1).gather(1, flat)
                slot = take(new_k)
                site, wind = follow_tracers(site, wind, take(mr), take(ml),
                                            L, config.periodic)
        frames.append(rec(slots))
        tracks.append(tracer_record(site, wind, valid, L))
    return stack_frames(frames, torch.stack(tracks, dim=1)), slots


def run_lattice_gas_anchored(config: ParticleConfig,
                             params_b: ParticleParams, *, T: float,
                             obs_dt: float, dt: float, seed: int = 0,
                             device="cuda", rho0_plus=None, rho0_minus=None,
                             record_fft: bool = True,
                             _slots0: Optional[torch.Tensor] = None,
                             _draws=None):
    """Anchored run, bind / unbind / immobilise / exit live (JAX
    ``lattice_gas_k.py:463-539``).  Returns ``(frames, slots,
    (exit_count, exit_times, exit_pos))``, batch-leading tensors on
    ``device``; the logs are fixed-size ``config.n_exit_buf`` buffers
    (NaN / 0 past the count).

    An exit is logged at the time of the start of its step, accumulated as
    float32 t + Δt as the JAX scan does, at the site of its slot; a step's
    exits enter in slot-major order (flat index k·L + x), and exits past
    the buffer are dropped.  ``_slots0`` and ``_draws`` as in
    ``run_lattice_gas_k`` (``_draws.tracer_bits`` is not called)."""
    assert config.exclusion and config.anchor_positions is not None
    device = torch.device(device)
    B = params_b.beta.shape[0]
    K, L = config.K, config.L
    E = config.n_exit_buf
    M, n_sub, dt_eff = frame_grid(T, obs_dt, dt)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    slots = _initial_slots(config, gen, rho0_plus, rho0_minus, B, device,
                           _slots0)
    band = build_smoothing_band(config, device)
    rec = _slot_recorder(config, record_fft, device)
    is_anchor = torch.as_tensor(config.anchor_mask(), device=device)
    sites_flat = (torch.arange(K * L, dtype=torch.int32, device=device)
                  % L).expand(B, K * L)

    ec = torch.zeros((B,), dtype=torch.int32, device=device)
    # one spare column E takes every entry that is not written (dropped)
    et = torch.full((B, E + 1), float("nan"), dtype=torch.float32,
                    device=device)
    ep = torch.zeros((B, E + 1), dtype=torch.int32, device=device)
    t = np.float32(0.0)
    dt32 = np.float32(dt_eff)
    frames = [rec(slots)]
    for f in range(1, M):
        for s in range(n_sub):
            inject = (None if _draws is None
                      else _draws.step((f - 1) * n_sub + s))
            slots, _, exiting = lgk_step(
                config, params_b, band, slots, dt_eff, generator=gen,
                is_anchor=is_anchor, _inject=inject)
            exf = exiting.reshape(B, -1).to(torch.int32)
            slot_idx = ec[:, None] + exf.cumsum(1, dtype=torch.int32) - 1
            write = (exf > 0) & (slot_idx < E)
            col = torch.where(write, slot_idx, E).long()
            et.scatter_(1, col, torch.where(
                write, torch.tensor(t, device=device), float("nan")))
            ep.scatter_(1, col, torch.where(write, sites_flat, 0))
            ec = ec + exf.sum(1, dtype=torch.int32)
            t = np.float32(t + dt32)
        frames.append(rec(slots))
    no_tracers = torch.zeros((B, len(frames), 0), dtype=torch.int32,
                             device=device)
    return (stack_frames(frames, no_tracers), slots,
            (ec, et[:, :E].contiguous(), ep[:, :E].contiguous()))
