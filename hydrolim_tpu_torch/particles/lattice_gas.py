"""Site-centric lattice-gas engine for K = 1, and the frame records of the
slot engines.

The port of the JAX package's ``particles/lattice_gas.py``.  At unit site
capacity the state is per site, ``occ ∈ {0, +1, −1}^L`` per replica, batched
(B, L) on the device.  ``lg_step`` runs every event channel of the
reference generator (CW flips, symmetric diffusion hops, σ-directed active
hops, exclusion) as rolls and elementwise selects: each occupied site
proposes at most one move, so an empty site has at most two candidates,
and a fair random bit per site breaks the tie.  Tagged tracers follow
their particles through the per-site movement flags, with a winding count
on a torus.

The frame records (``_lg_record_counts``: densities, local and global m,
the lattice variance and the amplitude spectrum) are shared with the
K-slot engines (``particles/lattice_gas_k.py``) and the fused route.

Differences from the JAX package, each by necessity:

- Randomness comes from one ``torch.Generator`` per run (the JAX package
  splits keys), so runs match the JAX runs only at injected draws: the
  test-only ``_inject`` of ``lg_step`` and ``_draws`` of
  ``run_lattice_gas``.
- m comes from ``ops.exclusion_kernel.band_m``, kernel B3's law and
  summation order (the JAX engine smooths with ``local_m_field``; both are
  the same Gaussian to float32 roundoff, and one ulp of m can move an
  event across its threshold).
- Tracer tags are chosen by a stable descending sort of their keys
  (``top_keys``): ``jax.lax.top_k`` returns ties in index order, and
  ``torch.topk`` promises no order for ties on CUDA.

The window form.  ``lg_step`` (and ``lattice_gas_k.lgk_step``) also step a
window of the lattice: ``x0`` is the global site of its first column and
``m`` the step's global m, all-reduced from the segments' sums.  This is
how a lattice split over a 'space' mesh axis steps
(``parallel.spatial.LatticeRun``): each segment runs the unchanged step
law on its columns and ``step_halo`` recomputed halo columns on each
side, whose ends the in-window rolls pollute, and keeps its own columns.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.fields.magnetization import (
    MFieldOp,
    build_mfield_op,
    local_m_field,
)
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    SmoothingBand,
    band_m,
    build_smoothing_band,
)
from hydrolim_tpu_torch.particles.run import substeps_for
from hydrolim_tpu_torch.parallel import draws

# Invalid-tracer sentinel for ``LatticeGasFrames.tracer_pos``.  Unwrapped
# positions are signed (a net-leftward walker crosses 0), so validity cannot
# ride the sign bit: INT32_MIN is outside every reachable position.
TRACER_INVALID = np.int32(np.iinfo(np.int32).min)


def tracer_valid_mask(tracer_pos):
    """Boolean mask of real (non-phantom) tracer entries: a tensor on the
    tensor's device for a torch tensor, else a numpy array."""
    if isinstance(tracer_pos, torch.Tensor):
        return tracer_pos != int(TRACER_INVALID)
    return np.asarray(tracer_pos) != TRACER_INVALID


class LatticeGasFrames(NamedTuple):
    rho_p: object       # (..., L)
    rho_m: object       # (..., L)
    total: object       # (..., L)
    m_local: object     # (..., L)
    m_global: object    # (...,)
    var: object         # (...,)
    fft_amp: object     # (..., L) or (..., 0)
    tracer_pos: object  # (..., n_t) unwrapped sites (TRACER_INVALID = phantom)


def _lg_record_counts(config: ParticleConfig, mfield_op: MFieldOp,
                      counts_p: torch.Tensor, counts_m: torch.Tensor,
                      record_fft: bool) -> LatticeGasFrames:
    """Frame observables from float32 per-site counts (leading dims batch).
    The variance and the spectrum are taken in float64 and rounded once."""
    n_alive = (counts_p.sum(-1) + counts_m.sum(-1)).clamp(min=1.0)
    denom = n_alive[..., None] * torch.tensor(config.dx, dtype=torch.float32,
                                              device=counts_p.device)
    rho_p = counts_p / denom
    rho_m = counts_m / denom
    total = rho_p + rho_m
    m_local = local_m_field(counts_p, counts_m, mfield_op,
                            sigma=config.local_kernel_sigma,
                            sigma_grid=config.sigma_grid,
                            periodic=config.periodic)
    m_global = (counts_p.sum(-1) - counts_m.sum(-1)) / n_alive
    var = total.to(torch.float64).var(-1, unbiased=False).to(torch.float32)
    if record_fft:
        L = config.L
        amp_h = torch.fft.rfft(total.to(torch.float64)).abs().to(
            torch.float32)
        # mirror to the full L-point amplitude spectrum like the recorder
        amp = torch.cat([amp_h, amp_h[..., 1:(L + 1) // 2].flip(-1)], dim=-1)
    else:
        amp = total.new_zeros(total.shape[:-1] + (0,))
    return LatticeGasFrames(
        rho_p=rho_p, rho_m=rho_m, total=total, m_local=m_local,
        m_global=m_global, var=var, fft_amp=amp,
        tracer_pos=torch.zeros(total.shape[:-1] + (0,), dtype=torch.int32,
                               device=total.device))


# ---------------------------------------------------------------------------
# shared pieces of the slot engines
# ---------------------------------------------------------------------------

def rate_col(v: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """A (B,) or scalar parameter tensor shaped to broadcast over ``dims``
    trailing lattice axes."""
    return v.reshape(v.shape + (1,) * dims)


def top_keys(keys: torch.Tensor, n: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``n`` largest keys of each row, in
    descending key order with ties in index order, as ``jax.lax.top_k``
    returns them (``torch.topk`` promises no order for ties on CUDA)."""
    vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def tracer_bits(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Random 31-bit tag keys, int64 (the JAX package's bits >> 1)."""
    return torch.randint(0, 2 ** 31, shape, generator=generator,
                         device=device, dtype=torch.int64)


def follow_tracers(site: torch.Tensor, wind: torch.Tensor,
                   moved_r: torch.Tensor, moved_l: torch.Tensor, L: int,
                   periodic: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the tracers' sites (B, n_t) from their movement flags:
    wrapped with a winding count on a torus, unbounded between walls."""
    raw = site + moved_r.to(torch.int32) - moved_l.to(torch.int32)
    if not periodic:
        return raw, wind
    under, over = raw < 0, raw >= L
    site = torch.where(under, raw + L, torch.where(over, raw - L, raw))
    return site, wind + over.to(torch.int32) - under.to(torch.int32)


def tracer_record(site: torch.Tensor, wind: torch.Tensor,
                  valid: torch.Tensor, L: int) -> torch.Tensor:
    """Unwrapped tracer positions, ``TRACER_INVALID`` for phantom tags."""
    return torch.where(valid, site + wind * L, int(TRACER_INVALID))


def stack_frames(frames: list, tracer_pos: torch.Tensor
                 ) -> LatticeGasFrames:
    """Per-frame records (leaves (B, ...)) and the (B, M, n_t) tracer
    positions → batched frames (B, M, ...)."""
    return LatticeGasFrames(
        *(torch.stack([getattr(f, name) for f in frames], dim=1)
          for name in LatticeGasFrames._fields[:-1]),
        tracer_pos=tracer_pos)


def frame_grid(T: float, obs_dt: float, dt: float) -> Tuple[int, int, float]:
    """(frames M, sub-steps per frame, effective Δt) of a run."""
    n_sub = substeps_for(obs_dt, dt)
    return len(np.arange(0.0, T, obs_dt)), n_sub, obs_dt / n_sub


# ---------------------------------------------------------------------------
# the window form
# ---------------------------------------------------------------------------

def step_halo(band: Optional[SmoothingBand], periodic: bool) -> int:
    """Halo columns a window needs on each side so that a step of
    ``lg_step`` or ``lgk_step`` leaves its own columns as the full-width
    step does: the dependency radius of the step.  A site's new state
    reads the acceptance of moves into it and out to its neighbours; an
    acceptance reads the events of the sites on either side; an event
    reads the freeness of its targets — the occupancy three sites out.
    m enters only the flip of its own site, and reads the band's inputs
    ``reach`` sites out (none with global m, which is all-reduced)."""
    if band is None:
        return 3
    return max(3, band.reach_wrap if periodic else band.reach)


def window_sites(x0: int, n: int, L: int, device) -> torch.Tensor:
    """Global sites of a window of ``n`` columns from site ``x0``."""
    return (x0 + torch.arange(n, device=device)) % L


def window_band(band: Optional[SmoothingBand], x0: int, n: int, L: int,
                device) -> Optional[SmoothingBand]:
    """The smoothing band of a window: the rows of its sites, each input
    site mapped to its window column.  Inputs outside the window read
    column 0; only the rows within ``reach`` of the window's ends read
    them, and the step drops those columns."""
    if band is None:
        return None
    sites = window_sites(x0, n, L, band.idx.device)
    idx = (band.idx[sites].long() - x0) % L
    idx = torch.where(idx < n, idx, 0).to(torch.int32)
    return dataclasses.replace(band, idx=idx.to(device),
                               w=band.w[sites].to(device))


def global_m(sums: torch.Tensor) -> torch.Tensor:
    """Global m, (B, 1) float32, from the all-reduced (B, 2) integer sums
    (Σσ, Σ|σ|): the full-width ``band_m``'s ratio bit for bit, since its
    float32 sums of integer counts are exact."""
    f32 = torch.float32
    return sums[:, :1].to(f32) / sums[:, 1:].to(f32).clamp(min=1.0)


# ---------------------------------------------------------------------------
# the K = 1 step
# ---------------------------------------------------------------------------

def _roll(x, shift):
    return torch.roll(x, shift, -1)


def lg_step(config: ParticleConfig, params: ParticleParams,
            band: Optional[SmoothingBand], occ: torch.Tensor, dt: float, *,
            generator: Optional[torch.Generator] = None, _inject=None,
            x0: Optional[int] = None, m: Optional[torch.Tensor] = None):
    """One synchronous Δt step on the (B, L) int32 occupancy field (JAX
    ``lattice_gas.py:40``).  Params are (B,) or scalar tensors; ``band``
    is the local-m smoothing (``build_smoothing_band``), None for global
    m.

    Draws: a uniform per site from ``generator``, and a fair tie bit per
    site; ``_inject=(u, tie)``, (B, L) float32 and bool, replaces both
    (the CPU tests feed the JAX run's draws).  The thresholds follow the
    JAX engine's arithmetic: t2 = t1 + (r_dif + r_act)·Δt, where kernel B3
    adds r_dif·Δt and r_act·Δt (the two round alike at most rates, not at
    all).

    Window form: with ``x0``, ``occ`` is a window of the lattice whose
    column 0 is the global site ``x0`` (``band`` then the window's,
    ``window_band``), and ``m`` (B, 1) replaces global m's ratio.

    Returns ``(occ_new, (moved_right, moved_left, flipped))``, the flags in
    the source layout (site → site ± 1) for tracer tracking."""
    assert config.site_capacity == 1
    L = config.L
    f32 = torch.float32
    dev = occ.device
    dt32 = torch.tensor(dt, dtype=f32, device=dev)
    is_occ = occ != 0
    is_plus = occ == 1
    is_minus = occ == -1
    sigma = occ.to(f32)

    m_field = band_m(sigma, is_occ.to(f32), band) if m is None else m
    flip_fn = config.flip_rate_fn or (lambda s, m, b: torch.exp(-b * s * m))
    c = torch.where(is_occ, flip_fn(sigma, m_field, rate_col(params.beta)),
                    0.0)

    right_empty = _roll(occ, -1) == 0          # occ[i+1] == 0
    left_empty = _roll(occ, 1) == 0            # occ[i-1] == 0
    if not config.periodic:
        idx = (torch.arange(L, device=dev) if x0 is None else
               window_sites(x0, occ.shape[-1], L, dev))
        right_empty = right_empty & (idx < L - 1)
        left_empty = left_empty & (idx > 0)

    # active hops: plus_forward → only σ=+1, always to the right;
    # bidirectional → σ-directed
    act_right = is_plus & right_empty
    act_left = (is_minus & left_empty if config.active_model ==
                "bidirectional" else torch.zeros_like(is_plus))
    r_dif, r_act = rate_col(params.rate_diffusion), rate_col(
        params.rate_active)
    r_right = r_dif * (is_occ & right_empty) + r_act * act_right
    r_left = r_dif * (is_occ & left_empty) + r_act * act_left

    # event draw per site: [left, right, flip] then nothing
    t1 = r_left * dt32
    t2 = t1 + r_right * dt32
    t3 = t2 + c * dt32
    if _inject is None:
        u = draws.rand(occ.shape, generator, dev, f32)
        tie = draws.rand(occ.shape, generator, dev, f32) < 0.5
    else:
        u, tie = _inject
    ev_left = u < t1
    ev_right = (u >= t1) & (u < t2)
    ev_flip = (u >= t2) & (u < t3)

    # candidates into each site j: R_in from j−1 (its right-move), L_in
    # from j+1 (its left-move); the fair tie bit settles double proposals
    R_in = _roll(ev_right, 1)
    L_in = _roll(ev_left, -1)
    if not config.periodic:
        R_in = R_in & (idx > 0)
        L_in = L_in & (idx < L - 1)
    empty = occ == 0
    acc_R = empty & R_in & (~L_in | tie)
    acc_L = empty & L_in & (~R_in | ~tie)

    gain = (torch.where(acc_R, _roll(occ, 1), 0)
            + torch.where(acc_L, _roll(occ, -1), 0))
    moved_right = _roll(acc_R, -1)              # source i moved to i+1
    moved_left = _roll(acc_L, 1)                # source i moved to i−1
    lost = moved_right | moved_left
    kept = torch.where(lost, 0, occ)
    flipped = ev_flip & ~lost
    kept = torch.where(flipped, -kept, kept)
    return (kept + gain).to(occ.dtype), (moved_right, moved_left, flipped)


# ---------------------------------------------------------------------------
# init, tracers and the run
# ---------------------------------------------------------------------------

def lg_init(config: ParticleConfig, generator: torch.Generator,
            rho0_plus=None, rho0_minus=None, *, B: int = 1,
            device="cuda") -> torch.Tensor:
    """(B, L) int32 occupancy (JAX ``lattice_gas.py:308``): 'fixed' = N
    uniform distinct sites with fair spins; 'poisson' = each site occupied
    with probability 1 − exp(−(λ₊+λ₋)), spin + with probability
    λ₊/(λ₊+λ₋) (the profiles (L,) or (B, L))."""
    L = config.L
    if config.init == "fixed":
        keys = torch.rand((B, L), generator=generator, device=device)
        sites = keys.argsort(dim=-1)[:, :config.N]
        spin = torch.randint(0, 2, (B, config.N), generator=generator,
                             device=device, dtype=torch.int32) * 2 - 1
        return torch.zeros((B, L), dtype=torch.int32,
                           device=device).scatter_(1, sites, spin)
    as_rate = lambda r: torch.as_tensor(
        np.asarray(r, np.float32), device=device).expand(B, L)
    lam_p, lam_m = as_rate(rho0_plus), as_rate(rho0_minus)
    tot = lam_p + lam_m
    occupied = torch.rand((B, L), generator=generator,
                          device=device) < 1.0 - torch.exp(-tot)
    plus = torch.rand((B, L), generator=generator,
                      device=device) < lam_p / tot.clamp(min=1e-12)
    return torch.where(occupied, torch.where(plus, 1, -1), 0).to(torch.int32)


def _init_tracers(occ0: torch.Tensor, bits: torch.Tensor, n_tracers: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_tracers`` occupied sites per replica by descending random key
    (JAX ``lattice_gas.py:184``): ``(sites (B, n) int32, valid (B, n))``;
    tags past the occupied count are phantoms (invalid)."""
    keys = torch.where(occ0 != 0, bits, 0)
    vals, idx = top_keys(keys, n_tracers)
    return idx.to(torch.int32), vals > 0


def run_frames(run, carry: dict, lo: int, hi: int, *, advance=None,
               split=None, join=None):
    """Frames [lo, hi) of a slot run (``LgRun``, ``LgkRun``) from its carry:
    frame 0 records the carry's field, each later frame advances
    ``run.n_sub`` steps and records.  ``advance(state, tracers, gen,
    inject)`` takes one step (default ``run.advance``, the full-width
    step); ``split`` and ``join`` turn the field into the state it steps
    and back (default: the field itself; ``parallel.spatial.LatticeRun``
    splits it into segments).  Returns ``(frames, carry)``."""
    advance = advance or run.advance
    L, n_sub = run.config.L, run.n_sub
    field, valid, gen = carry[run.field], carry["valid"], carry["gen"]
    tr = {k: carry[k] for k in run.tracer_keys}
    frames, tracks = [], []

    def record():
        frames.append(run.rec(field))
        tracks.append(tracer_record(tr["site"], tr["wind"], valid, L))

    if lo == 0:
        record()
    state = None
    for f in range(max(lo, 1), hi):
        if state is None:
            state = field if split is None else split(field)
        for s in range(n_sub):
            inject = (None if run._draws is None
                      else run._draws.step((f - 1) * n_sub + s))
            state, tr = advance(state, tr, gen, inject)
        field = state if join is None else join(state)
        record()
    return (stack_frames(frames, torch.stack(tracks, dim=1)),
            {**carry, run.field: field, **tr})


class SlotRun:
    """What ``LgRun`` and ``LgkRun`` share: the frame loop
    (``run_frames``) and one full-width step with its tracers
    (``advance``).  An engine gives ``field`` (its carry's state key),
    ``tracer_keys``, ``step`` (the engine's step, window form included),
    ``tracer_index``, ``follow`` and ``seg_sums``."""

    def run_range(self, carry: dict, lo: int, hi: int):
        return run_frames(self, carry, lo, hi)

    def for_rows(self, params_b: ParticleParams, device, b0: int):
        """The same run over a block of the batch on ``device``
        (``parallel.mesh.ShardedRun``); its draws are the generator's, so
        ``b0`` only picks the block's rows of injected draws."""
        kw = dict(self._kw)
        if self._draws is not None:
            kw["_draws"] = draws.RowDraws(self._draws, b0,
                                          params_b.beta.shape[0])
        return type(self)(self.config, params_b, **kw, device=device)

    def tracer_values(self, flags, tr: dict, col: torch.Tensor, n: int):
        """Each flag of a step (leading (B, ...), last axis n columns) at
        the tracers' entries, column ``col``."""
        idx = self.tracer_index(tr, col, n)
        B = idx.shape[0]
        return [f.reshape(B, -1).gather(1, idx) for f in flags]

    def advance(self, field, tr: dict, gen, inject):
        field, flags = self.step(field, self.params_b, self.band, gen,
                                 inject)
        if self.n_t:
            tr = self.follow(tr, self.tracer_values(
                flags, tr, tr["site"].long(), self.config.L))
        return field, tr

    @classmethod
    def final(cls, carry: dict) -> torch.Tensor:
        return carry[cls.field]


class LgRun(SlotRun):
    """The fixed parts of one K = 1 run (JAX ``lattice_gas.py:331``): the
    frame grid, the smoothing band and the recorder.  ``start`` draws the
    carry of frame 0 (occupancy, tracer sites and windings, the phantom-tag
    mask, the generator); ``run_range`` records frames [lo, hi) and returns
    the carry after them.  Every draw is the generator's next, in global
    step order, so ranges stitch bit for bit given the carry
    (``utils.checkpoint.run_lattice_gas_checkpointed``).

    Test-only: ``_draws`` replaces the draws (``tracer_bits(shape)`` and
    ``step(i)`` → ``_inject`` of global step i)."""

    route = "lg_step"
    frames_type = LatticeGasFrames
    field = "occ"
    tracer_keys = ("site", "wind")

    def __init__(self, config: ParticleConfig, params_b: ParticleParams, *,
                 T: float, obs_dt: float, dt: float, record_fft: bool,
                 n_tracers: int, device, _draws=None):
        assert config.site_capacity == 1
        self._kw = dict(T=T, obs_dt=obs_dt, dt=dt, record_fft=record_fft,
                        n_tracers=n_tracers, _draws=_draws)
        self.config, self.params_b = config, params_b
        self.device = torch.device(device)
        self.n_frames, self.n_sub, self.dt_eff = frame_grid(T, obs_dt, dt)
        self.n_t = min(n_tracers, config.L)
        self.band = build_smoothing_band(config, self.device)
        mfield_op = build_mfield_op(config.L, config.dx,
                                    config.local_kernel_sigma,
                                    config.periodic, self.device)
        self.rec = lambda o: _lg_record_counts(
            config, mfield_op, (o == 1).to(torch.float32),
            (o == -1).to(torch.float32), record_fft)
        self._draws = _draws

    def start(self, seed: int, rho0_plus=None, rho0_minus=None,
              _occ0: Optional[torch.Tensor] = None) -> dict:
        B, L = self.params_b.beta.shape[0], self.config.L
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        occ = (lg_init(self.config, gen, rho0_plus, rho0_minus, B=B,
                       device=self.device)
               if _occ0 is None else _occ0.to(self.device))
        bits = (tracer_bits((B, L), gen, self.device) if self._draws is None
                else self._draws.tracer_bits((B, L)))
        site, valid = _init_tracers(occ, bits, self.n_t)
        return dict(occ=occ, site=site, wind=torch.zeros_like(site),
                    valid=valid, gen=gen)

    def step(self, occ, params, band, gen, inject, x0=None, m=None):
        occ, (mr, ml, _) = lg_step(self.config, params, band, occ,
                                   self.dt_eff, generator=gen,
                                   _inject=inject, x0=x0, m=m)
        return occ, (mr, ml)

    @staticmethod
    def tracer_index(tr: dict, col: torch.Tensor, n: int) -> torch.Tensor:
        return col

    def follow(self, tr: dict, vals) -> dict:
        site, wind = follow_tracers(tr["site"], tr["wind"], *vals,
                                    self.config.L, self.config.periodic)
        return dict(site=site, wind=wind)

    @staticmethod
    def seg_sums(occ: torch.Tensor) -> torch.Tensor:
        """(B, 2) int64 (Σσ, Σ|σ|) of a segment's columns."""
        return torch.stack([occ.sum(-1, dtype=torch.int64),
                            (occ != 0).sum(-1)], -1)


def run_lattice_gas(config: ParticleConfig, params_b: ParticleParams, *,
                    T: float, obs_dt: float, dt: float, seed: int = 0,
                    device="cuda", rho0_plus=None, rho0_minus=None,
                    record_fft: bool = True, n_tracers: int = 0,
                    occ_sharding=None, mesh=None,
                    _occ0: Optional[torch.Tensor] = None, _draws=None
                    ) -> Tuple[LatticeGasFrames, torch.Tensor]:
    """The K = 1 engine over the batch of ``params_b`` (JAX
    ``lattice_gas.py:331``): batched frames (leaves (B, M, …) on
    ``device``; with ``n_tracers`` > 0 the tagged particles' unwrapped
    positions, ``TRACER_INVALID`` for phantoms) and the final (B, L)
    occupancy.  All draws come from one generator seeded with ``seed``:
    the initial field, the tracer keys, then each step's.  The run is one
    ``LgRun.run_range`` over every frame.  ``mesh=`` splits the batch
    over a sweep mesh (``parallel.mesh.ShardedRun``); ``occ_sharding=``
    splits the lattice axis over a 'space' mesh, or the batch and the
    lattice over a ('sweep', 'space') grid (``parallel.spatial``).  Both
    return the one-device run bit for bit.

    Test-only: ``_occ0`` replaces the initial field and ``_draws`` the
    draws (``tracer_bits(shape)`` and ``step(i)`` → ``_inject`` of global
    step i)."""
    from hydrolim_tpu_torch.parallel.spatial import sharded_run

    run = LgRun(config, params_b, T=T, obs_dt=obs_dt, dt=dt,
                record_fft=record_fft, n_tracers=n_tracers, device=device,
                _draws=_draws)
    carry = run.start(seed, rho0_plus, rho0_minus, _occ0)
    frames, carry = sharded_run(run, params_b, mesh=mesh,
                                occ_sharding=occ_sharding).run_range(
        carry, 0, run.n_frames)
    return frames, run.final(carry)
