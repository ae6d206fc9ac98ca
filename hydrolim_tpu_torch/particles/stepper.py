"""The particle engine's steps, batched over (B, n_buf) replicas.

- ``step``: the general synchronous τ-leap step, the port of the JAX
  package's ``particles/stepper.py`` (``:70-393``), in plain eager torch.
  Every particle draws one uniform against the cumulative rates of its
  seven channels [left, right, forward, flip, bind, unbind, exit]
  (PARTICLE_solver_CLASS.py:259-351, ``assemble_rates``); simultaneous
  hops that would overfill a site of capacity K are admitted by random
  priority (``_resolve_conflicts``: K rounds of a per-site minimum for
  K ≤ 8, a sort by (target, priority) above); exits leave the buffer
  and enter a fixed-size log.
- ``_step_meanfield_global``: the mean-field fast path (no exclusion,
  global m, no anchors, the default flip rate), the torch route of
  ``run_particles`` outside kernel B1's scope and the loop body of B1's
  plain version.

Where the port departs from the JAX arithmetic, by necessity:

- No unsigned 32-bit arithmetic on CUDA: priorities are held in int64,
  ``(bits & 0xFFFE0000) | index`` on the segment-min path and
  ``target << 32 | bits`` on the sort path (same order, same values).
- The channel thresholds are summed one channel after another in float32,
  the JAX cumsum's order (``torch.cumsum`` accumulates in double on the
  CPU and in a scan order on the card).
- Draws come from a ``torch.Generator``; the test-only ``_inject=(u,
  bits)`` replaces them.  ``step`` issues no host synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.core.device import to_device
from hydrolim_tpu_torch.fields.magnetization import (
    MFieldOp,
    build_mfield_op,
    local_m_field,
)
from hydrolim_tpu_torch.ops.segment import occupancy

# event codes
EV_NONE, EV_LEFT, EV_RIGHT, EV_FWD, EV_FLIP, EV_BIND, EV_UNBIND, EV_EXIT = \
    range(8)
EMPTY_PRIO = 0xFFFFFFFF          # no proposal: after every priority
_PRIO_HI = 0xFFFE0000            # 15 random high bits above the index


@dataclasses.dataclass
class ParticleState:
    """Particle state, (B, n_buf) per field.  ``pos`` is the wrapped site
    (int32); ``pos + wind·L`` is the unwrapped trajectory.  ``alive`` bool
    marks the live entries of a padded buffer (None: all live); ``bound``
    bool the anchored ones (None: none).

    The τ-leap step also carries ``init_bin`` (int32 birth sites) and the
    exit log: ``exit_count`` (B,) int32, and (B, E) ``exit_times``
    (float32, NaN where empty), ``exit_pos`` and ``exit_init_bin`` (int32),
    E = ``config.n_exit_buf``.  They are None on the mean-field routes,
    which have no exit channel (``with_exit_log`` fills them in)."""

    pos: torch.Tensor
    sigma: torch.Tensor
    wind: torch.Tensor
    alive: Optional[torch.Tensor] = None
    bound: Optional[torch.Tensor] = None
    init_bin: Optional[torch.Tensor] = None
    exit_count: Optional[torch.Tensor] = None
    exit_times: Optional[torch.Tensor] = None
    exit_pos: Optional[torch.Tensor] = None
    exit_init_bin: Optional[torch.Tensor] = None


def with_exit_log(config: ParticleConfig, state: ParticleState
                  ) -> ParticleState:
    """``state`` with what the τ-leap step carries filled in where it is
    None: every entry alive, none bound, ``init_bin = pos`` and an empty
    exit log (JAX ``particles/init.py:49-54``)."""
    pos = state.pos
    B, dev, E = pos.shape[0], pos.device, config.n_exit_buf
    fill = {}
    if state.alive is None:
        fill["alive"] = torch.ones_like(pos, dtype=torch.bool)
    if state.bound is None:
        fill["bound"] = torch.zeros_like(pos, dtype=torch.bool)
    if state.init_bin is None:
        fill["init_bin"] = pos
    if state.exit_count is None:
        fill.update(
            exit_count=torch.zeros((B,), dtype=torch.int32, device=dev),
            exit_times=torch.full((B, E), float("nan"), dtype=torch.float32,
                                  device=dev),
            exit_pos=torch.zeros((B, E), dtype=torch.int32, device=dev),
            exit_init_bin=torch.zeros((B, E), dtype=torch.int32,
                                      device=dev))
    return dataclasses.replace(state, **fill) if fill else state


class StaticArrays(NamedTuple):
    """Per-configuration constants of the step, on the device."""

    is_anchor_site: torch.Tensor   # bool (L,)
    mfield_op: MFieldOp


def build_static_arrays(config: ParticleConfig,
                        device="cuda") -> StaticArrays:
    return StaticArrays(
        is_anchor_site=to_device(config.anchor_mask(), device),
        mfield_op=build_mfield_op(config.L, config.dx,
                                  config.local_kernel_sigma, config.periodic,
                                  device))


def compute_m_field(config: ParticleConfig, statics: StaticArrays,
                    counts_p: torch.Tensor, counts_m: torch.Tensor
                    ) -> torch.Tensor:
    return local_m_field(counts_p, counts_m, statics.mfield_op,
                         sigma=config.local_kernel_sigma,
                         sigma_grid=config.sigma_grid,
                         periodic=config.periodic)


def _col(v) -> torch.Tensor:
    """A (B,) or scalar parameter as a column over the particle axis."""
    return v.reshape(v.shape + (1,))


def _default_flip_rate(sigma, m, beta):
    return torch.exp(-beta * sigma * m)


def assemble_rates(config: ParticleConfig, params: ParticleParams,
                   state: ParticleState, m_field: torch.Tensor,
                   occ_total: Optional[torch.Tensor],
                   is_anchor_site: torch.Tensor):
    """Per-particle rates of the seven channels (JAX ``stepper.py:70``).

    Returns ``(rates, targets)``: ``rates`` (B, n, 7) float32 ordered
    [left, right, forward, flip, bind, unbind, exit], dead particles
    zeroed; ``targets = (left_raw, right_raw, fwd_raw, left_t, right_t,
    fwd_t)``, the raw (pre-wrap) and wrapped or clipped target sites.
    ``m_field`` and ``occ_total`` are (B, L) float32; params (B,) or
    scalar tensors; a custom ``config.flip_rate_fn`` gets σ (B, n), m at
    each particle (B, n) and β as a (B, 1) column."""
    L = config.L
    pos, sigma, bound, alive = state.pos, state.sigma, state.bound, state.alive
    pos_l = pos.long()
    is_plus = sigma > 0
    rd, ra = _col(params.rate_diffusion), _col(params.rate_active)

    flip_fn = config.flip_rate_fn or _default_flip_rate
    cvec = flip_fn(sigma.to(torch.float32), m_field.gather(-1, pos_l),
                   _col(params.beta))
    cvec = torch.broadcast_to(torch.as_tensor(cvec, dtype=torch.float32,
                                              device=pos.device), pos.shape)
    if config.suppress_flip_when_bound:
        cvec = torch.where(bound, 0.0, cvec)

    if config.active_model == "bidirectional":
        fwd_raw = pos + sigma            # σ-directed hop for both spins
    else:  # 'plus_forward': σ=−1 takes a zero step (:276-277)
        fwd_raw = pos + is_plus.to(torch.int32)
    left_raw = pos - 1
    right_raw = pos + 1
    if config.periodic:
        fwd_t, left_t, right_t = fwd_raw % L, left_raw % L, right_raw % L
    else:
        fwd_t = fwd_raw.clamp(0, L - 1)
        left_t = left_raw.clamp(0, L - 1)
        right_t = right_raw.clamp(0, L - 1)
    same_fwd, same_left, same_right = fwd_t == pos, left_t == pos, \
        right_t == pos

    if config.exclusion:
        K = float(config.K)
        occ_f, occ_l, occ_r = (occ_total.gather(-1, t.long())
                               for t in (fwd_t, left_t, right_t))
        fwd_free = (occ_f < K) & ~same_fwd
        left_free = (occ_l < K) & ~same_left
        right_free = (occ_r < K) & ~same_right
    else:
        fwd_free, left_free, right_free = ~same_fwd, ~same_left, ~same_right

    if config.active_model == "bidirectional":
        r_act = torch.where(fwd_free, ra, 0.0)
    else:
        # only σ=+1 particles ever take active hops (:317-319)
        r_act = torch.where(is_plus & fwd_free, ra, 0.0)
    r_left = rd * left_free
    r_right = rd * right_free

    r_exit = torch.zeros_like(cvec)
    on_anchor = is_anchor_site[pos_l]
    if config.immobilize_when_anchored:
        anchored = (~is_plus) & on_anchor & bound
        r_act = torch.where(anchored, 0.0, r_act)
        r_left = torch.where(anchored, 0.0, r_left)
        r_right = torch.where(anchored, 0.0, r_right)
        r_exit = torch.where(anchored, _col(params.k_exit), 0.0)

    if config.crowding_suppresses_rates and config.exclusion:
        ffrac = (1.0 - occ_f / K).clamp(0.0, 1.0)
        lfrac = (1.0 - occ_l / K).clamp(0.0, 1.0)
        rfrac = (1.0 - occ_r / K).clamp(0.0, 1.0)
        r_act = r_act * ffrac
        r_left = rd * left_free * lfrac
        r_right = rd * right_free * rfrac
        if config.immobilize_when_anchored:
            r_left = torch.where(anchored, 0.0, r_left)
            r_right = torch.where(anchored, 0.0, r_right)

    # binding / unbinding (:342-348).  The reference's quirk is kept: the
    # capacity gate tests occ_total[pos] < K with the particle itself
    # counted, so at K=1 binding is structurally impossible.
    bind_ok = (~bound) & (~is_plus) & on_anchor
    if config.exclusion:
        bind_ok = bind_ok & (occ_total.gather(-1, pos_l) < float(config.K))
    r_bind = torch.where(bind_ok, _col(params.k_on), 0.0)
    r_unbind = torch.where(bound, _col(params.k_off), 0.0)

    rates = torch.stack(torch.broadcast_tensors(
        r_left, r_right, r_act, cvec, r_bind, r_unbind, r_exit), dim=-1)
    rates = torch.where(alive[..., None], rates, 0.0)
    return rates, (left_raw, right_raw, fwd_raw, left_t, right_t, fwd_t)


def _resolve_conflicts(config: ParticleConfig, bits: torch.Tensor,
                       mover: torch.Tensor, target: torch.Tensor,
                       occ_total: torch.Tensor) -> torch.Tensor:
    """Random-priority admission of simultaneous hops under capacity K
    (JAX ``stepper.py:163``): a hop is accepted iff its rank by priority
    among this step's proposals into its target is below the target's free
    capacity at the start of the step.  ``bits`` (B, n) int64 hold 32
    random bits each.  K ≤ 8 runs K rounds of a per-site minimum; above,
    a stable sort by the composite key ``target << 32 | bits`` (non-movers
    at the sentinel L, after every site)."""
    if config.K <= 8:
        return _resolve_conflicts_segmin(config, bits, mover, target,
                                         occ_total)
    L = config.L
    B, n = mover.shape
    tgt = torch.where(mover, target.long(), L)
    key = (tgt << 32) | bits
    _, order = torch.sort(key, dim=-1, stable=True)
    tgt_s = tgt.gather(-1, order)
    counts = torch.zeros((B, L + 1), dtype=torch.int64, device=tgt.device)
    counts.scatter_add_(1, tgt, torch.ones_like(tgt))
    seg_start = counts.cumsum(-1) - counts
    rank = (torch.arange(n, device=tgt.device)
            - seg_start.gather(-1, tgt_s))
    safe_t = tgt_s.clamp(max=L - 1)
    free = (config.K - occ_total.gather(-1, safe_t)).to(torch.int64)
    accept_s = (rank < free) & (tgt_s < L)
    return torch.zeros_like(mover).scatter_(1, order, accept_s)


def _resolve_conflicts_segmin(config: ParticleConfig, bits: torch.Tensor,
                              mover: torch.Tensor, target: torch.Tensor,
                              occ_total: torch.Tensor) -> torch.Tensor:
    """K rounds of per-site minimum admission (JAX ``stepper.py:201``):
    each proposal carries the unique priority ``(bits & 0xFFFE0000) |
    index`` (int64); round r admits the smallest remaining priority at
    every site whose free capacity exceeds r."""
    L = config.L
    B, n = mover.shape
    assert n < (1 << 17), "segmin pass supports n_buf < 131072"
    idx = torch.arange(n, dtype=torch.int64, device=bits.device)
    pack = (bits & _PRIO_HI) | idx
    tgt = target.long()
    free = (config.K - occ_total.gather(-1, tgt)).to(torch.int32)
    accepted = torch.zeros_like(mover)
    for r in range(config.K):
        active = mover & ~accepted & (free > r)
        cand = torch.where(active, pack, EMPTY_PRIO)
        site_min = torch.full((B, L), EMPTY_PRIO, dtype=torch.int64,
                              device=bits.device)
        site_min.scatter_reduce_(1, tgt, cand, "amin")
        accepted = accepted | (active & (cand == site_min.gather(-1, tgt)))
    return accepted


def tau_leap_draws(shape, generator: Optional[torch.Generator], device):
    """One step's draws: a float32 uniform and 32 random bits (int64) per
    particle."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    bits = torch.randint(0, 2 ** 32, shape, generator=generator,
                         dtype=torch.int64, device=device)
    return u, bits


def channel_thresholds(rates: torch.Tensor, dt: float) -> torch.Tensor:
    """(…, 7) cumulative channel probabilities: the rates summed one
    channel after another in float32, then × Δt (JAX ``jnp.cumsum(rates)
    * dt``)."""
    cum = rates.clone()
    for j in range(1, cum.shape[-1]):
        cum[..., j].add_(cum[..., j - 1])
    return cum * dt


def pick_events(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Event code per particle: ``1 + #{j < 6: u ≥ cum_j}`` where
    u < cum_6, else ``EV_NONE``."""
    hit = (u[..., None] >= cum[..., :-1]).sum(-1, dtype=torch.int32) + 1
    return torch.where(u < cum[..., -1], hit, EV_NONE)


def draw_events(config: ParticleConfig, params: ParticleParams,
                statics: StaticArrays, state: ParticleState, dt: float,
                u: torch.Tensor):
    """The first half of ``step``: fields → rates → one event per particle
    from the uniforms ``u``.  Returns ``(event, cum, occ_total, targets)``:
    the (B, n) int32 event codes, the (B, n, 7) float32 thresholds, the
    (B, L) occupancy (None without exclusion) and ``assemble_rates``'
    targets."""
    L = config.L
    B = state.pos.shape[0]
    occ_total = None
    if config.exclusion or config.local_kernel_sigma > 0:
        occ, counts_p, counts_m = occupancy(state.pos, state.sigma,
                                            state.alive, L)
        m_field = compute_m_field(config, statics, counts_p, counts_m)
        if config.exclusion:
            occ_total = occ
    else:
        s_sum = torch.where(state.alive, state.sigma, 0).sum(
            -1, keepdim=True, dtype=torch.int32)
        n_alive = state.alive.sum(-1, keepdim=True,
                                  dtype=torch.int32).clamp(min=1)
        m_field = (s_sum.to(torch.float32)
                   / n_alive.to(torch.float32)).expand(B, L)
    rates, targets = assemble_rates(config, params, state, m_field,
                                    occ_total, statics.is_anchor_site)
    cum = channel_thresholds(rates, dt)
    return pick_events(u, cum), cum, occ_total, targets


def step(config: ParticleConfig, params: ParticleParams,
         statics: StaticArrays, state: ParticleState, dt: float, t: float,
         *, generator: Optional[torch.Generator] = None, _inject=None
         ) -> ParticleState:
    """One synchronous Δt step of a (B, n_buf) state (JAX
    ``stepper.py:314``): fields → rates → one event per particle
    (``draw_events``) → conflict resolution → simultaneous apply.
    ``state`` carries the exit log (``with_exit_log``); an exit is logged
    at ``t``, the step's start time (float32).

    Draws come from ``generator`` (``tau_leap_draws``);
    ``_inject=(u, bits)``, (B, n) float32 uniforms and (B, n) int64 holding
    uint32 bits, replaces them.  The mean-field configuration goes to
    ``_step_meanfield_global`` (only ``u`` is drawn)."""
    B, n = state.pos.shape
    if _is_meanfield_fast_path(config):
        return _step_meanfield_global(
            config, params, state, dt, generator=generator,
            u_override=None if _inject is None else _inject[0])
    L = config.L
    u, bits = (tau_leap_draws((B, n), generator, state.pos.device)
               if _inject is None else _inject)
    event, _, occ_total, targets = draw_events(config, params, statics,
                                               state, dt, u)
    left_raw, right_raw, fwd_raw, left_t, right_t, fwd_t = targets

    is_left, is_right = event == EV_LEFT, event == EV_RIGHT
    mover = is_left | is_right | (event == EV_FWD)
    target = torch.where(is_left, left_t, torch.where(is_right, right_t,
                                                      fwd_t))
    if config.exclusion:
        moved = mover & _resolve_conflicts(config, bits, mover, target,
                                           occ_total)
    else:
        moved = mover

    pos = torch.where(moved, target, state.pos)
    wind = state.wind
    if config.periodic:
        target_raw = torch.where(is_left, left_raw,
                                 torch.where(is_right, right_raw, fwd_raw))
        wind = wind + torch.where(
            moved, torch.div(target_raw, L, rounding_mode="floor"), 0)
    sigma = torch.where(event == EV_FLIP, -state.sigma, state.sigma)
    bound = (state.bound | (event == EV_BIND)) & (event != EV_UNBIND)

    # exits: absorb and append to the fixed-size log (:424-436); entries
    # past its end go to a spare column and are dropped
    exiting = (event == EV_EXIT) & state.alive
    ex = exiting.to(torch.int32)
    E = config.n_exit_buf
    slot = state.exit_count[:, None] + ex.cumsum(-1, dtype=torch.int32) - 1
    write = exiting & (slot >= 0) & (slot < E)
    col = torch.where(write, slot, E).long()

    def log(old, value, empty):
        buf = torch.cat([old, old[:, :1]], dim=1)
        return buf.scatter_(1, col, torch.where(write, value, empty))[:, :E]

    return ParticleState(
        pos=pos, sigma=sigma, wind=wind, alive=state.alive & ~exiting,
        bound=bound, init_bin=state.init_bin,
        exit_count=state.exit_count + ex.sum(-1, dtype=torch.int32),
        exit_times=log(state.exit_times, t, float("nan")),
        exit_pos=log(state.exit_pos, state.pos, 0),
        exit_init_bin=log(state.exit_init_bin, state.init_bin, 0))


def _is_meanfield_fast_path(config: ParticleConfig) -> bool:
    """No exclusion, global magnetization, no anchors, default CW flip
    rate: the step reduces to elementwise work plus one sum."""
    return (not config.exclusion
            and config.local_kernel_sigma <= 0
            and config.anchor_positions is None
            and config.flip_rate_fn is None)


def _step_meanfield_global(config: ParticleConfig, params: ParticleParams,
                           state: ParticleState, dt: float,
                           u_override: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> ParticleState:
    """One step for a (B, n) batch: m = Σ_alive σ / max(n_alive, 1) per
    replica, one uniform per particle against the cumulative thresholds
    [left p_dif, right p_dif, active p_act, flip exp(∓βm)·dt].  On a
    lattice with walls a hop that would leave it has rate 0 (its threshold
    step collapses); dead particles neither move nor flip.

    ``u_override``: (B, n) float32 uniforms replacing the draw from
    ``generator``.  Params are (B,) tensors (or scalars)."""
    L = config.L
    pos, sigma, alive = state.pos, state.sigma, state.alive
    B, n = pos.shape
    f32 = torch.float32
    col = lambda v: torch.as_tensor(v, dtype=f32,
                                    device=pos.device).reshape(-1, 1)
    dt32 = torch.tensor(dt, dtype=f32, device=pos.device)

    # exact integer Σσ, then one f32 division by the true particle count
    if alive is None:
        s_sum = sigma.sum(-1, keepdim=True, dtype=torch.int64)
        n_alive = torch.tensor(float(n), dtype=f32, device=pos.device)
    else:
        s_sum = torch.where(alive, sigma, 0).sum(-1, keepdim=True,
                                                 dtype=torch.int64)
        n_alive = alive.sum(-1, keepdim=True).clamp(min=1).to(f32)
    m = s_sum.to(f32) / n_alive
    beta = col(params.beta)
    p_dif = col(params.rate_diffusion) * dt32
    p_act = col(params.rate_active) * dt32
    e_p = torch.exp(-beta * m) * dt32       # flip prob of a + particle
    e_m = torch.exp(beta * m) * dt32        # flip prob of a − particle

    is_plus = sigma > 0
    if u_override is None:
        u = torch.rand((B, n), generator=generator, dtype=f32,
                       device=pos.device)
    else:
        u = u_override

    zero = torch.zeros((), dtype=f32, device=pos.device)
    bidirectional = config.active_model == "bidirectional"
    if config.periodic:
        t1 = p_dif
        t2 = t1 + p_dif
        p_fwd = (p_act if bidirectional
                 else torch.where(is_plus, p_act, zero))
    else:
        left_ok, right_ok = pos > 0, pos < L - 1
        fwd_ok = (torch.where(is_plus, right_ok, left_ok) if bidirectional
                  else right_ok)
        t1 = torch.where(left_ok, p_dif, zero)
        t2 = t1 + torch.where(right_ok, p_dif, zero)
        p_fwd = torch.where(fwd_ok if bidirectional else is_plus & fwd_ok,
                            p_act, zero)
    # bidirectional: σ hops actively along σ; plus_forward: only σ=+1
    # particles hop, rightward
    t3 = t2 + p_fwd
    fwd_dir = sigma if bidirectional else torch.ones_like(sigma)
    t4 = t3 + torch.where(is_plus, e_p, e_m)

    mv_left = u < t1
    mv_right = (u >= t1) & (u < t2)
    mv_fwd = (u >= t2) & (u < t3)
    flip = (u >= t3) & (u < t4)

    delta = (mv_right.to(torch.int32) - mv_left.to(torch.int32)
             + torch.where(mv_fwd, fwd_dir, torch.zeros_like(fwd_dir)))
    if alive is not None:
        flip = flip & alive
        delta = torch.where(alive, delta, 0)
    raw = pos + delta
    if config.periodic:
        pos_new = torch.where(raw < 0, raw + L,
                              torch.where(raw >= L, raw - L, raw))
        wind = (state.wind + (raw >= L).to(torch.int32)
                - (raw < 0).to(torch.int32))
    else:
        pos_new, wind = raw, state.wind     # blocked hops are rate 0
    sigma_new = torch.where(flip, -sigma, sigma)
    return dataclasses.replace(state, pos=pos_new, sigma=sigma_new,
                               wind=wind)
