"""The port's exclusion slice against the JAX package, on the CPU.

- Kernel B3/B4: ``exclusion_multi_step_plain`` against the JAX kernels
  ``exclusion_multi_step`` (B3) and ``exclusion_multi_step_rb`` (B4) run
  with ``interpret=True`` on the same injected random bits, each at its own
  bit layout (converted by ``interop``): the integer slot payloads must be
  EQUAL after every call.
- The smoothing band against the JAX kernel's smoothing matrix.
- Frame records, tracer sites and the batched estimators on identical
  inputs, to float32 roundoff.
- The initial slot field and the exp-gradient profiles.

Inputs are numpy arrays from fixed seeds, fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import poisson

from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    band_weights,
    bits_to_uniform,
    build_smoothing_band,
    exclusion_multi_step,
    smooth_with_band,
    step_thresholds,
)

CPU = "cpu"


def _config(L, K, sigma, periodic, model="plus_forward", N=None):
    return dict(L=L, N=N or (L * K) // 2, init="fixed", scale_rates=False,
                local_kernel_sigma=sigma, periodic=periodic, site_capacity=K,
                active_model=model)


def _slots0(B, K, L, N, rng):
    """(B, K, L) front-packed slots of N particles per replica, random
    spins, payloads ±(flat slot index + 1) as the sweep assigns them."""
    out = np.zeros((B, K, L), np.int32)
    for b in range(B):
        sites = rng.choice(L * K, N, replace=False) // K
        for x in sites:
            k = int((out[b, :, x] != 0).sum())
            out[b, k, x] = rng.choice([-1, 1])
    ids = np.arange(1, K * L + 1, dtype=np.int32).reshape(K, L)
    return out * ids


def _conv_for_jax(kw, narrow=False):
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.ops.pallas_exclusion import (
        build_conv_matrix,
        build_narrow_smooth,
        narrow_smooth_radius,
    )

    jcfg = JConfig(**kw)
    if kw["local_kernel_sigma"] <= 0:
        return np.zeros((0, 0), np.float32), 0
    if narrow:
        sr = narrow_smooth_radius(jcfg)
        assert sr > 0
        return build_narrow_smooth(jcfg, sr), sr
    return build_conv_matrix(jcfg), 0


def _port_args(kw, scal, B):
    cfg = ParticleConfig(**kw)
    band = (build_smoothing_band(cfg, device=CPU)
            if cfg.local_kernel_sigma > 0 else None)
    return (torch.tensor(scal), torch.zeros(B, dtype=torch.int32)), band


def _first_divergence(got, want, slots_before, scal, band, kw, dt, u_bits):
    """A readable failure: the first differing slot, its event uniform and
    the margin |u − threshold| to the port's nearest threshold."""
    b, k, x = (int(i) for i in np.argwhere(got != want)[0])
    sl = torch.tensor(slots_before)
    thresholds = step_thresholds(sl, torch.tensor(scal), band, dt,
                                 kw["periodic"],
                                 kw["active_model"] == "bidirectional")[:3]
    u = float(bits_to_uniform(torch.tensor(int(u_bits[b, k, x]))))
    margin = min(abs(u - float(t[b, k, x])) for t in thresholds)
    return (f"slot k={k} site x={x} of replica {b} differs: port "
            f"{got[b, k, x]} vs JAX {want[b, k, x]}; u={u:.9g}, thresholds "
            f"{[float(t[b, k, x]) for t in thresholds]}, margin {margin:.3g}")


# ---------------------------------------------------------------------------
# kernel B3 (ops/pallas_exclusion.py)
# ---------------------------------------------------------------------------

B3_CASES = {
    "global-periodic-plus_forward": _config(64, 3, 0.0, True),
    "global-periodic-bidirectional": _config(64, 3, 0.0, True,
                                             "bidirectional"),
    "local-periodic": _config(64, 3, 0.02, True),
    "local-nonperiodic-walls": _config(48, 2, 0.015, False, N=40),
    "K1": _config(64, 1, 0.0, True, "bidirectional", N=40),
}


def _run_b3_pair(kw, B, k_steps, n_calls, dt, seed, narrow=False):
    """n_calls chained calls of JAX B3 and of the port's plain version at
    the same injected bits; asserts slot equality after each call and
    returns the JAX slots of every call (padded) and the port's (B, K, L)."""
    from hydrolim_tpu.ops.pallas_exclusion import exclusion_multi_step as j_b3

    L, K = kw["L"], kw["site_capacity"]
    rng = np.random.default_rng(seed)
    slots = _slots0(B, K, L, kw["N"], rng)
    scal = np.stack([np.linspace(0.4, 2.5, B), np.full(B, 1.0),
                     np.full(B, 3.0)], 1).astype(np.float32)
    conv, sr = _conv_for_jax(kw, narrow)
    (t_scal, t_seeds), band = _port_args(kw, scal, B)
    jsl = jnp.asarray(interop.pack_slots(slots))
    psl = torch.tensor(slots)
    Kp, Lp = jsl.shape[1:]
    history = []
    for c in range(n_calls):
        bits = rng.integers(0, 2 ** 32, (B, k_steps, 2, 1, Kp, Lp),
                            dtype=np.uint32)
        before = psl.numpy().copy()
        jsl = j_b3(jnp.asarray(scal), jnp.zeros((B,), jnp.int32), jsl,
                   jnp.asarray(conv), L=L, K=K, k_steps=k_steps, dt=dt,
                   periodic=kw["periodic"],
                   bidirectional=kw["active_model"] == "bidirectional",
                   use_local_m=kw["local_kernel_sigma"] > 0, r_batch=1,
                   smooth_radius=sr, interpret=True, noise=jnp.asarray(bits))
        noise = interop.exclusion_noise(bits, K, L, device=CPU)
        psl = exclusion_multi_step(
            t_scal, t_seeds, psl, band, k_steps=k_steps, dt=dt,
            periodic=kw["periodic"],
            bidirectional=kw["active_model"] == "bidirectional",
            noise=noise)
        got = psl.numpy()
        want = interop.unpack_slots(np.asarray(jsl), K, L, device=CPU).numpy()
        if not np.array_equal(got, want):
            raise AssertionError(
                f"call {c}: " + _first_divergence(
                    got, want, before, scal, band, kw, dt,
                    noise[:, 0, 0].numpy().view(np.uint32))
                if k_steps == 1 else f"call {c}: slot fields differ at "
                f"{np.argwhere(got != want)[:5].tolist()}")
        history.append(np.asarray(jsl))
    return history, psl, slots


@pytest.mark.parametrize("case", list(B3_CASES))
def test_b3_plain_equals_jax_kernel(case):
    """Two chained 12-step calls at dt = 0.02 (event probabilities of a few
    per cent per slot-step, so admission conflicts occur): slot payloads
    EQUAL, mass and payload ids conserved, occupancy ≤ K."""
    kw = B3_CASES[case]
    K = kw["site_capacity"]
    _, final, start = _run_b3_pair(kw, B=2, k_steps=12, n_calls=2, dt=0.02,
                                   seed=7)
    final = final.numpy()
    assert not np.array_equal(final, start)                  # it moved
    for b in range(2):
        assert sorted(np.abs(final[b][final[b] != 0])) == \
            sorted(np.abs(start[b][start[b] != 0]))          # ids conserved
    assert ((final != 0).sum(1) <= K).all()
    assert exclusion_multi_step.launches == 0


def test_b3_narrow_smoothing_equals_jax_kernel():
    """The flagship smoothing route: JAX B3 with the packed narrow operand
    (rolled taps + exact corner matmul) against the port's band, L=768,
    K=3, σ=0.005, non-periodic, 6 single-step calls.  A mismatch names the
    slot and its margin |u − threshold|."""
    kw = _config(768, 3, 0.005, False, N=800)
    _run_b3_pair(kw, B=1, k_steps=1, n_calls=6, dt=2e-3, seed=11,
                 narrow=True)


# ---------------------------------------------------------------------------
# kernel B4 (ops/pallas_exclusion_rb.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["global-periodic-bidirectional",
                                  "local-periodic"])
def test_b4_plain_equals_jax_kernel(case):
    """The replica-banked kernel at R=2 on its own (G, k, 2, K, R, Lp) bit
    layout: two chained 12-step calls, slot payloads EQUAL."""
    from hydrolim_tpu.ops.pallas_exclusion_rb import (
        exclusion_multi_step_rb as j_b4,
    )

    kw = B3_CASES[case]
    L, K, B, R, k_steps, dt = kw["L"], kw["site_capacity"], 2, 2, 12, 0.02
    rng = np.random.default_rng(3)
    slots = _slots0(B, K, L, kw["N"], rng)
    scal = np.array([[0.8, 1.0, 3.0], [2.2, 1.0, 3.0]], np.float32)
    conv, _ = _conv_for_jax(kw)
    (t_scal, t_seeds), band = _port_args(kw, scal, B)
    jsl = jnp.asarray(interop.pack_slots(slots, row_pad=False))
    psl = torch.tensor(slots)
    bidi = kw["active_model"] == "bidirectional"
    for c in range(2):
        bits = rng.integers(0, 2 ** 32, (B // R, k_steps, 2, K, R,
                                         jsl.shape[-1]), dtype=np.uint32)
        jsl = j_b4(jnp.asarray(scal), jnp.zeros((B,), jnp.int32), jsl,
                   jnp.asarray(conv), L=L, K=K, k_steps=k_steps, dt=dt,
                   periodic=kw["periodic"], bidirectional=bidi,
                   use_local_m=kw["local_kernel_sigma"] > 0, r_batch=R,
                   interpret=True, noise=jnp.asarray(bits))
        psl = exclusion_multi_step(
            t_scal, t_seeds, psl, band, k_steps=k_steps, dt=dt,
            periodic=kw["periodic"], bidirectional=bidi,
            noise=interop.exclusion_rb_noise(bits, L, device=CPU))
        np.testing.assert_array_equal(
            psl.numpy(), interop.unpack_slots(np.asarray(jsl), K, L,
                                              device=CPU).numpy(),
            err_msg=f"call {c}")
    assert not np.array_equal(psl.numpy(), slots)


# ---------------------------------------------------------------------------
# the smoothing band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("sigma_grid", [2, 5, 20])
def test_band_weights_match_jax_conv_matrix(periodic, sigma_grid):
    """Every band entry equals the JAX smoothing matrix's entry (input row,
    output column) to rtol 1e-6 / atol 1e-9; the inputs are ascending per
    output site; what the band leaves out of the matrix is exactly zero
    (reflect) or below 1e-7 of each column's mass (the periodic cut)."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.ops.pallas_exclusion import build_conv_matrix

    L = 200
    kw = _config(L, 3, sigma_grid / L, periodic)
    M = build_conv_matrix(JConfig(**kw))[:L, :L].astype(np.float64)
    idx, w = band_weights(ParticleConfig(**kw))
    out = np.broadcast_to(np.arange(L)[:, None], idx.shape)
    real = w != 0                         # padding entries have weight 0
    np.testing.assert_allclose(w[real], M[idx, out][real], rtol=1e-6,
                               atol=1e-9)
    assert (np.diff(np.where(real, idx, -1), axis=1)[real[:, 1:]] > 0).all()
    rest = M.copy()
    rest[idx[real], out[real]] = 0.0
    if periodic:
        assert (rest.sum(0) <= 1e-7 * M.sum(0)).all()
    else:
        assert not rest.any()


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("sigma_grid", [2, 5, 20])
def test_band_interior_rows_are_its_taps(periodic, sigma_grid):
    """The band's interior (``band_interior``), one row of taps translated:
    every row in [lo, hi) is those taps at x − radius + t, bit for bit;
    away from the walls and the wrap every site is interior; a row that
    breaks the translation invariance falls out of the interior."""
    from hydrolim_tpu_torch.ops.exclusion_kernel import (
        band_interior,
        smoothing_band,
    )

    L = 200
    idx, w = band_weights(ParticleConfig(**_config(L, 3, sigma_grid / L,
                                                   periodic)))
    W = idx.shape[1]
    band = smoothing_band(idx, w, device=CPU)
    taps, r, lo, hi = band_interior(idx, w)
    assert r == band.radius
    for x in range(lo, hi):
        np.testing.assert_array_equal(idx[x], x - r + np.arange(W))
        np.testing.assert_array_equal(w[x], taps)
    if W < L:
        assert (lo, hi) == (r, L - r)
        bent = w.copy()
        bent[L // 3, 0] += 1e-3
        _, _, lo2, hi2 = band_interior(idx, bent)
        assert not lo2 <= L // 3 < hi2
        assert hi2 - lo2 >= (L - 2 * r) // 2
    else:                                       # the full torus: no interior
        assert lo == hi


def test_band_smoothing_matches_dense_product():
    """The band applied in ascending input order equals the dense product
    x @ M to float32 roundoff (flagship σ_grid = 2, L = 1000, both walls)."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.ops.pallas_exclusion import build_conv_matrix

    kw = _config(1000, 3, 0.002, False)
    M = build_conv_matrix(JConfig(**kw))[:1000, :1000].astype(np.float64)
    x = np.random.default_rng(0).integers(-3, 4, (3, 1000)).astype(np.float32)
    band = build_smoothing_band(ParticleConfig(**kw), device=CPU)
    got = smooth_with_band(torch.tensor(x), band).numpy()
    np.testing.assert_allclose(got, x @ M, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# frame records, tracer sites, estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["local-periodic", "local-nonperiodic-walls"])
def test_frame_records_match_jax(case):
    """Three chained injected-bit frames on both sides, then each side's
    ``_record_fn``: slots and tracer sites equal; rho_p, rho_m, total,
    m_global, var to rtol 1e-6; m_local and fft_amp to rtol 1e-5 / atol
    1e-6 (float32 smoothing and spectra in a different order); the
    unwrapped tracer positions equal."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.sweeps.fast_exclusion import _record_fn as j_rec
    from hydrolim_tpu.sweeps.fast_exclusion import (
        unwrap_tracer_sites as j_unwrap,
    )
    from hydrolim_tpu_torch.sweeps.fast_exclusion import (
        _record_fn,
        unwrap_tracer_sites,
    )

    kw = B3_CASES[case]
    L, K, B = kw["L"], kw["site_capacity"], 2
    history, _, slots0 = _run_b3_pair(kw, B=B, k_steps=10, n_calls=3,
                                      dt=0.02, seed=5)
    rng = np.random.default_rng(1)
    occupied = [np.abs(slots0[b][slots0[b] != 0]) for b in range(B)]
    tags = np.stack([rng.choice(o, 12, replace=False) for o in occupied])
    valid = np.ones_like(tags, bool)
    valid[1, -1] = False
    jrec = j_rec(JConfig(**kw), True)
    prec = _record_fn(ParticleConfig(**kw), True, device=CPU)
    frames = [interop.pack_slots(slots0)] + history
    jraw, praw = [], []
    for sl in frames:
        jf, jr = jrec(jnp.asarray(sl), jnp.asarray(tags, jnp.int32),
                      jnp.asarray(valid))
        pf, pr = prec(interop.unpack_slots(sl, K, L, device=CPU),
                      torch.tensor(tags, dtype=torch.int32),
                      torch.tensor(valid))
        for name in ("rho_p", "rho_m", "total", "m_global", "var"):
            np.testing.assert_allclose(getattr(pf, name).numpy(),
                                       np.asarray(getattr(jf, name)),
                                       rtol=1e-6, atol=0, err_msg=name)
        for name in ("m_local", "fft_amp"):
            np.testing.assert_allclose(getattr(pf, name).numpy(),
                                       np.asarray(getattr(jf, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        jraw.append(np.asarray(jr))
        praw.append(pr.numpy())
    np.testing.assert_array_equal(
        unwrap_tracer_sites(torch.tensor(np.stack(praw)), L,
                            kw["periodic"]).numpy(),
        j_unwrap(np.stack(jraw), L, kw["periodic"]))
    assert (np.stack(praw)[:, 1, -1] == -1).all()


def test_batched_estimates_match_jax():
    """All five estimators on identical frames (a port sweep's output on
    the CPU): rtol 1e-5, with NaN in the same places.  v_eff also gets an
    atol of 2e-6: it is the time derivative of the density's centre of
    mass, whose float32 sum carries ~2e-7 of roundoff on either side
    (x ≤ 1), divided by the 0.2 frame spacing."""
    from hydrolim_tpu.observables.batched import batched_estimates as j_est
    from hydrolim_tpu_torch.observables.batched import batched_estimates
    from hydrolim_tpu_torch.particles.lattice_gas import tracer_valid_mask
    from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params
    from hydrolim_tpu_torch.sweeps.fast_exclusion import run_exclusion_sweep

    cfg = ParticleConfig(**_config(64, 3, 0.0, False, N=60))
    params = broadcast_params(cfg, beta=[0.5, 2.0], rate_diffusion=1.0,
                              rate_active=3.0, n_runs=2, device=CPU)
    T, obs_dt = 4.0, 0.2
    frames, _ = run_exclusion_sweep(cfg, params, T=T, obs_dt=obs_dt,
                                    dt=0.02, seed=3, device=CPU, n_tracers=60)
    times = np.arange(0.0, T, obs_dt)
    tr = frames.tracer_pos.numpy().copy()
    tr[0, :, -1] = np.iinfo(np.int32).min          # one phantom tracer
    alive = tracer_valid_mask(tr)
    args = (frames.total.numpy(), frames.m_global.numpy(),
            frames.rho_p.numpy(), times, tr, alive)
    want = j_est(*args, dx=cfg.dx, xlim=1.0, has_positions=True)
    got = batched_estimates(*(torch.as_tensor(np.asarray(a)) for a in args),
                            dx=cfg.dx, xlim=1.0, has_positions=True)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=2e-6 if name == "v_eff"
                                   else 0, equal_nan=True, err_msg=name)
    # no positions: D_eff is NaN everywhere on both sides
    got = batched_estimates(*(torch.as_tensor(np.asarray(a))
                              for a in args[:4]), dx=cfg.dx,
                            has_positions=False)
    assert torch.isnan(got.D_eff).all()


# ---------------------------------------------------------------------------
# initial conditions
# ---------------------------------------------------------------------------

def test_slots_from_particles_equals_jax():
    """Rank-within-site packing of the same numpy particles, dead ones
    included, batched on the port's side."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.particles.lattice_gas_k import (
        slots_from_particles as j_pack,
    )
    from hydrolim_tpu_torch.particles.lattice_gas_k import (
        slots_from_particles,
    )

    kw = _config(50, 3, 0.0, False, N=90)
    rng = np.random.default_rng(4)
    pos = np.stack([rng.choice(150, 96, replace=False) // 3
                    for _ in range(3)]).astype(np.int32)
    sig = rng.choice([-1, 1], (3, 96)).astype(np.int32)
    alive = np.arange(96)[None] < np.array([[90], [96], [70]])
    got = slots_from_particles(ParticleConfig(**kw), torch.tensor(pos),
                               torch.tensor(sig), torch.tensor(alive))
    for b in range(3):
        want = j_pack(JConfig(**kw), jnp.asarray(pos[b]), jnp.asarray(sig[b]),
                      jnp.asarray(alive[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_make_exp_gradient_equals_jax():
    from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient as j_grad
    from hydrolim_tpu_torch.sweeps.beta_sweep import make_exp_gradient

    for anchors in (None, (0.25, 0.6)):
        got = make_exp_gradient(300, 500, 0.75, 0.35, anchor_positions=anchors)
        want = j_grad(300, 500, 0.75, 0.35, anchor_positions=anchors)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, w, rtol=1e-12)
        xs = np.linspace(0, 1, 17)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g(xs), w(xs), rtol=1e-12)
            assert g(0.3) == w(0.3)


@pytest.mark.parametrize("init", ["fixed", "poisson"])
def test_lgk_init_laws(init):
    """The initial slot field: capacity respected and front-packed; fixed
    init places exactly N; Poisson init follows the exp-gradient profile
    (mean count per half within 5 SE of the truncated profile's)."""
    from hydrolim_tpu_torch.particles.lattice_gas_k import lgk_init
    from hydrolim_tpu_torch.sweeps.beta_sweep import make_exp_gradient

    L, K, N, B = 100, 2, 80, 64
    cfg = ParticleConfig(L=L, N=N, init=init, scale_rates=False,
                         local_kernel_sigma=0.0, periodic=False,
                         site_capacity=K)
    grad = make_exp_gradient(L, N, 0.75, 0.35, anchor_positions=None)
    gen = torch.Generator()
    gen.manual_seed(0)
    s = lgk_init(cfg, gen, grad[2], grad[3], B=B, device=CPU).numpy()
    occ = (s != 0).sum(1)
    assert occ.max() <= K
    assert not ((s[:, 1:] != 0) & (s[:, :-1] == 0)).any()   # front-packed
    n = occ.sum(1)
    if init == "fixed":
        assert (n == N).all()
        return
    left = occ[:, :L // 2].sum(1)
    assert left.mean() > 1.5 * occ[:, L // 2:].sum(1).mean()
    # the count kept per site is min(Poisson(ρ₊ + ρ₋), K)
    lam = (grad[2] + grad[3]).astype(np.float32)
    expect = sum(sum(j * poisson.pmf(j, lm) for j in range(K))
                 + K * poisson.sf(K - 1, lm) for lm in lam)
    assert abs(n.mean() - expect) < 5 * n.std() / np.sqrt(B), (n.mean(),
                                                                expect)
