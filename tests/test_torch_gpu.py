"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: each test skips without a CUDA device.  Run on a GPU host
with ``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`` (the
suite's conftest imports jax, which a GPU host need not have); ``chip_smoke.py``
runs the same comparisons at the main path's shapes.
"""
import functools

import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, PDEConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    band_interior,
    band_rotation,
    band_weights,
    build_smoothing_band,
    card_plan,
    exclusion_multi_step,
    exclusion_multi_step_plain,
    exclusion_multi_step_planned,
    smoothing_band,
)
from hydrolim_tpu_torch.ops.pde_kernel import (
    SMOOTH_FFT_FROM,
    m_field_of,
    pde_multi_step,
    pde_multi_step_plain,
    pde_spectra,
    pde_spectra_plain,
)
from hydrolim_tpu_torch.ops.stepper_kernel import (
    coresident_clusters,
    launch_plan,
    max_steps_per_launch,
    meanfield_multi_step,
    meanfield_multi_step_planned,
    meanfield_multi_step_plain,
)
from hydrolim_tpu_torch.pde.init import pde_initialize
from hydrolim_tpu_torch.sweeps.fast_exclusion import init_payload_slots

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(shape, gen, dev):
    return torch.randint(0, 2 ** 32, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("N", [96, 30_000])   # shared- and device-memory state
def test_b1_kernel_equals_plain(dev, bidirectional, N):
    B, L, k = 3, 64, 40
    gen = torch.Generator(device=dev)
    gen.manual_seed(N)
    pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32)
    sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1
    wind = torch.zeros_like(pos)
    scal = torch.tensor([[0.3, 0.5, 2.0], [1.3, 0.5, 2.0], [2.6, 0.5, 2.0]],
                        device=dev)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(L=L, k_steps=k, dt=0.02, bidirectional=bidirectional,
              noise=_bits((B, k, N), gen, dev))
    n0 = meanfield_multi_step.launches
    got = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
    assert meanfield_multi_step.launches == n0 + 1
    want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _b1_state(dev, gen, B, N, L):
    pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32)
    sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1
    wind = torch.randint(-3, 4, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    scal = torch.stack([torch.linspace(0.3, 2.6, B, device=dev),
                        torch.full((B,), 0.5, device=dev),
                        torch.full((B,), 2.0, device=dev)], 1).contiguous()
    return scal, pos, sig, wind


def _b1_plan(dev, B, N, L, k, C):
    return launch_plan(B, N, L, k, coresident_clusters(dev.index, N, L),
                       cluster=C)


# (N, L, cluster size, the state mode the plan must pick): every mode at
# several cluster sizes, and N not a multiple of 4·C
B1_PLANS = [
    (96, 64, 1, "registers"), (5000, 256, 1, "registers"),
    (5000, 256, 2, "registers"), (5003, 256, 3, "registers"),
    (5000, 256, 4, "registers"), (4999, 256, 8, "registers"),
    (30_001, 64, 1, "shared"), (100_000, 1000, 2, "shared"),
    (100_001, 1000, 3, "shared"), (100_000, 1000, 1, "global"),
    (90, 70_000, 1, "global"), (1001, 70_000, 2, "global"),
]


@pytest.mark.parametrize("N,L,C,mode", B1_PLANS)
def test_b1_kernel_equals_plain_under_every_plan(dev, N, L, C, mode):
    """Injected bits, both active models: pos, σ and wind EQUAL to the
    plain version under each cluster size and state mode."""
    B, k = 3, 40
    gen = torch.Generator(device=dev)
    gen.manual_seed(N + C)
    scal, pos, sig, wind = _b1_state(dev, gen, B, N, L)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    plan = _b1_plan(dev, B, N, L, k, C)
    assert (plan.shape.cluster, plan.shape.mode) == (C, mode)
    for bidi in (True, False):
        kw = dict(L=L, k_steps=k, dt=0.02, bidirectional=bidi,
                  noise=_bits((B, k, N), gen, dev))
        n0 = meanfield_multi_step.launches
        got = meanfield_multi_step_planned(plan, scal, seeds, pos, sig, wind,
                                           **kw)
        assert meanfield_multi_step.launches == n0 + 1
        want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert not torch.equal(got[0], pos)


def test_b1_split_call_equals_unsplit_plain(dev):
    """At L=3 a call longer than ``max_steps_per_launch`` (the packed
    winding change's limit) is split, step0 and the bits advanced; the
    result equals the plain version's one unsplit run."""
    B, N, L = 2, 64, 3
    k = max_steps_per_launch(L) + 500
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    scal, pos, sig, wind = _b1_state(dev, gen, B, N, L)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(L=L, k_steps=k, dt=0.05, bidirectional=True,
              noise=_bits((B, k, N), gen, dev))
    n0 = meanfield_multi_step.launches
    got = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
    assert meanfield_multi_step.launches == n0 + 2
    want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got[2] - wind).abs().max()) > 0    # the wrap branch ran


@pytest.mark.parametrize("N", [1024, 16_384])
def test_b1_at_the_critical_scaling_shape_equals_plain(dev, N):
    """The critical-scaling driver's shape: L=8, zero motion rates, B=64
    (β ∈ {0.5, 1.0} × 32 runs), its dt (0.03679 at β=1), injected bits
    under the wrapper's own plan.  The integers equal the plain version's;
    only σ moves (pos and wind stay as they are)."""
    from hydrolim_tpu_torch.sweeps.ensemble import ensemble_dt

    B, L, k = 64, 8, 60
    dt = ensemble_dt(ParticleConfig(
        L=L, N=N, n_pad=N, init="fixed", scale_rates=False,
        local_kernel_sigma=0.0, periodic=True, site_capacity=None,
        active_model="bidirectional"), beta_max=1.0, rate_diffusion=0.0,
        rate_active=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(N)
    pos = torch.randint(0, L, (B, N), generator=gen, device=dev,
                        dtype=torch.int32)
    sig = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                        dtype=torch.int32) * 2 - 1
    wind = torch.randint(-2, 3, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    scal = torch.tensor([[b, 0.0, 0.0] for b in (0.5, 1.0) for _ in range(32)],
                        device=dev)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(L=L, k_steps=k, dt=dt, bidirectional=True,
              noise=_bits((B, k, N), gen, dev))
    got = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
    want = meanfield_multi_step_plain(scal, seeds, pos, sig, wind, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], pos) and torch.equal(got[2], wind)
    assert not torch.equal(got[1], sig)


def test_b1_native_stream_is_the_same_under_every_plan(dev):
    """Native Philox: the same (seed, step0) gives the same state whatever
    the cluster size and state mode; and the wrapper's own plan seats every
    cluster at once at the main path's shape."""
    B, N, L, k = 4, 5000, 256, 300
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    scal, pos, sig, wind = _b1_state(dev, gen, B, N, L)
    seeds = torch.arange(11, 11 + B, dtype=torch.int32, device=dev)
    kw = dict(L=L, k_steps=k, dt=0.01, bidirectional=True, step0=77)
    ref = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
    for C in (1, 2, 3, 4, 8):
        got = meanfield_multi_step_planned(_b1_plan(dev, B, N, L, k, C),
                                           scal, seeds, pos, sig, wind, **kw)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert _b1_plan(dev, 33, 5000, 256, k, None).waves == 1
    assert _b1_plan(dev, 64, 100_000, 1000, k, None).waves == 1


def test_b1_native_streams(dev):
    """Native Philox: deterministic per (seed, step0), a new stream per
    step0, and the flip rate of σ at β = 0 close to its expectation."""
    B, N, L, k, dt = 2, 20_000, 100, 10, 0.01
    pos = torch.zeros((B, N), dtype=torch.int32, device=dev)
    sig = torch.ones((B, N), dtype=torch.int32, device=dev)
    wind = torch.zeros_like(pos)
    scal = torch.tensor([[0.0, 0.0, 0.0]] * B, device=dev)
    seeds = torch.tensor([7, 7], dtype=torch.int32, device=dev)
    kw = dict(L=L, k_steps=1, dt=dt, bidirectional=True)
    a = meanfield_multi_step(scal, seeds, pos, sig, wind, step0=0, **kw)
    b = meanfield_multi_step(scal, seeds, pos, sig, wind, step0=0, **kw)
    c = meanfield_multi_step(scal, seeds, pos, sig, wind, step0=1, **kw)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert not torch.equal(a[1][0], a[1][1])        # replica is in the key
    flips = sum(int((meanfield_multi_step(
        scal, seeds, pos, sig, wind, step0=s, **kw)[1] < 0).sum())
        for s in range(k))
    expect = B * N * k * dt                         # exp(0)·dt per step
    assert abs(flips - expect) < 5 * np.sqrt(expect)


# Kernel B2's covering set: (PDEConfig fields beyond the defaults, γ, dt,
# L, expected (m_mode, solve_mode)).  Defaults: B=3, n_t=200 (or the
# fields' n_tracers), window 10, kmax 8, periodic, bidirectional.  An odd
# n_t (global m) or an odd L + n_t (local m) puts the float part of shared
# memory at an odd length.
B2_MODES = {
    "global-exact": (dict(gaussian_kernel=True, kernel_sigma=2e5), 0.2,
                     5e-4, 256, ("global", "exact")),
    "global-none": (dict(gaussian_kernel=True, kernel_sigma=2e5), 0.0, 5e-4,
                    256, ("global", "none")),
    "pointwise-exact": ({}, 0.2, 5e-4, 256, ("pointwise", "exact")),
    "narrow-none": (dict(gaussian_kernel=True, kernel_sigma=0.01), 0.0, 5e-4,
                    256, ("narrow", "none")),
    "smooth-neumann-anchored-exact": (
        dict(gaussian_kernel=True, kernel_sigma=0.1, bc="neumann",
             active_model="anchored_minus"), 0.2, 5e-4, 256,
        ("smooth", "exact")),
    "smooth-odd-L-anchored-none": (
        dict(gaussian_kernel=True, kernel_sigma=0.1,
             active_model="anchored_minus"), 0.0, 5e-4, 255,
        ("smooth", "none")),
    "global-banded": (dict(gaussian_kernel=True, kernel_sigma=2e5,
                           diffusion_solver="banded"), 0.2, 1.5e-4, 256,
                      ("global", "banded")),
    "pointwise-banded-L8192": (dict(diffusion_solver="banded"), 0.2, 2e-7,
                               8192, ("pointwise", "banded")),
    "narrow-full-rfft": (dict(gaussian_kernel=True, kernel_sigma=0.01,
                              fft_kmax=129), 0.0, 5e-4, 256,
                         ("narrow", "none")),
    "global-exact-L1000": (dict(gaussian_kernel=True, kernel_sigma=2e5),
                           0.2, 5e-4, 1000, ("global", "exact")),
    "pointwise-neumann-exact-L1000": (dict(bc="neumann"), 0.2, 5e-4, 1000,
                                      ("pointwise", "exact")),
    "smooth-exact-L1000": (dict(gaussian_kernel=True, kernel_sigma=0.05),
                           0.2, 5e-4, 1000, ("smooth", "exact")),
    "global-exact-odd-n_t": (dict(gaussian_kernel=True, kernel_sigma=2e5,
                                  n_tracers=201), 0.2, 5e-4, 256,
                             ("global", "exact")),
    "pointwise-exact-L999": ({}, 0.2, 5e-4, 999, ("pointwise", "exact")),
    "smooth-neumann-exact-L999": (
        dict(gaussian_kernel=True, kernel_sigma=0.05, bc="neumann"), 0.2,
        5e-4, 999, ("smooth", "exact")),
}


@pytest.mark.parametrize("case", list(B2_MODES))
def test_b2_kernel_matches_plain(dev, case):
    """Every mode at injected bits, two chained 30-step calls, at the
    kernel-logic tolerances."""
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    over, gamma, dt, L, modes = B2_MODES[case]
    kw = dict(fft_kmax=8)
    kw.update(over)
    B, n_t, W, k = 3, kw.pop("n_tracers", 200), 10, 30
    config = PDEConfig(L=L, dt=dt, n_tracers=n_t,
                       tracer_window_time=W * dt * (1 + 1e-9), **kw)
    assert config.tracer_window == W
    m_mode, solve_mode, smooth, solve = kernel_operands(config, gamma, dev)
    assert (m_mode, solve_mode) == modes
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                noise=0.3, n_tracers=n_t, device=dev)
    scal = torch.tensor([[b, 0.6, gamma, 0.0] for b in (0.5, 1.5, 3.0)],
                        device=dev)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    noise = _bits((B, 2 * k, 3, n_t), gen, dev)
    sk = [rp, rm, tr.unwrapped, tr.spin.float(), tr.hist]
    sp = list(sk)
    n0 = pde_multi_step.launches
    for c in range(2):
        kw = dict(L=L, n_t=n_t, window=W, k_steps=k, dt=dt, xlim=1.0,
                  periodic=config.bc == "periodic", m_mode=m_mode,
                  solve_mode=solve_mode,
                  bidirectional=config.active_model == "bidirectional",
                  kmax_rec=config.kmax,
                  noise=noise[:, c * k:(c + 1) * k].contiguous())
        *sk, rk = pde_multi_step(scal, seeds, c * k, *sk, solve, smooth,
                                 **kw)
        *sp, rp_ = pde_multi_step_plain(scal, seeds, c * k, *sp, solve,
                                        smooth, **kw)
    assert pde_multi_step.launches == n0 + 2
    torch.testing.assert_close(sk[0], sp[0], rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(sk[1], sp[1], rtol=2e-4, atol=1e-7)
    torch.testing.assert_close(sk[2], sp[2], rtol=1e-4, atol=1e-5)
    assert torch.equal(sk[3], sp[3])
    torch.testing.assert_close(sk[4], sp[4], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rk[..., 2:4], rp_[..., 2:4], rtol=5e-4,
                               atol=1e-6, equal_nan=True)
    torch.testing.assert_close(rk[..., 0], rp_[..., 0], rtol=0, atol=1e-5)
    torch.testing.assert_close(rk[..., 4:], rp_[..., 4:], rtol=1e-4,
                               atol=1e-8)


def test_b2_wrapper_refuses_what_does_not_fit(dev, monkeypatch):
    """What neither route serves is refused before any launch, with the
    reason and the limit: a lattice past the device memory the card has
    free (here reported as 1 MB), with a pointwise m and with the full
    smoothing; so are missing operands.  The full smoothing past the
    65,536 sites a cluster holds (L = 140,000) is served, on the
    device-memory route's FFT stage, in one launch."""
    from hydrolim_tpu_torch.ops import pde_kernel as pk
    from hydrolim_tpu_torch.ops.convolve import periodic_gaussian_kernel

    B, n_t, W = 1, 64, 4

    def args(L, smooth=None):
        rp = torch.full((B, L), 0.5 / L, device=dev)
        pos = torch.zeros((B, n_t), device=dev)
        return (torch.tensor([[1.0, 0.6, 0.0, 0.0]], device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev), 0, rp,
                rp.clone(), pos, torch.ones_like(pos),
                torch.zeros((B, W, n_t), device=dev), None, smooth)

    kw = dict(n_t=n_t, window=W, k_steps=1, dt=1e-4, xlim=1.0,
              periodic=True, solve_mode="none", bidirectional=True)
    n0 = dict(pde_multi_step.route_launches)
    L = 140_000
    smooth = pk.build_smooth_operands(
        "smooth", periodic_gaussian_kernel(L, 1.0 / L, 0.05), dev)
    out = pde_multi_step(*args(L, smooth), L=L, m_mode="smooth", **kw)
    torch.cuda.synchronize()
    assert pde_multi_step.last_plan.route == "gmem"
    assert pde_multi_step.last_plan.fft.n == 524_288
    assert pde_multi_step.route_launches["gmem"] == n0["gmem"] + 1
    assert torch.isfinite(out[0]).all()
    assert torch.isfinite(out[5][..., :2]).all()       # m and Var
    with pytest.raises(ValueError, match="needs its SmoothOperands"):
        pde_multi_step(*args(L), L=L, m_mode="narrow", **kw)
    n0 = dict(pde_multi_step.route_launches)
    total = torch.cuda.mem_get_info(dev)[1]
    monkeypatch.setattr(pk.torch.cuda, "mem_get_info",
                        lambda *a: (1 << 20, total))
    with pytest.raises(ValueError, match="device-memory route: L=140000 .*"
                       "more than the 1048576 B free; the largest L"):
        pde_multi_step(*args(L, smooth), L=L, m_mode="smooth", **kw)
    L = 262_144
    with pytest.raises(ValueError, match="device-memory route: L=262144 .*"
                       "more than the 1048576 B free; the largest L"):
        pde_multi_step(*args(L), L=L, m_mode="pointwise", **kw)
    assert pde_multi_step.route_launches == n0


def _b2_large_case(dev, L, B, over, gamma=None, n_t=64, W=10, seed=0):
    """Inputs of kernel B2 at a large L, the large-lattice driver's recipe
    (dt = 0.5·dx/λ, γ = 2.5·dx²/dt) unless ``gamma`` is given."""
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    dt = 0.5 / L / 0.6
    gamma = 2.5 / L / L / dt if gamma is None else gamma
    config = PDEConfig(L=L, dt=dt, n_tracers=n_t, fft_kmax=8,
                       tracer_window_time=W * dt * (1 + 1e-9), **over)
    modes = kernel_operands(config, gamma, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                noise=0.3, n_tracers=n_t, device=dev)
    scal = torch.tensor([[b, 0.6, gamma, 0.0]
                         for b in np.linspace(0.5, 2.5, B)],
                        dtype=torch.float32, device=dev)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    kw = dict(L=L, n_t=n_t, window=config.tracer_window, dt=dt,
              xlim=config.xlim, periodic=config.bc == "periodic",
              m_mode=modes[0], solve_mode=modes[1],
              bidirectional=config.active_model == "bidirectional",
              kmax_rec=8)
    return gen, modes, scal, seeds, [rp, rm, tr.unwrapped, tr.spin.float(),
                                     tr.hist], kw


def _b2_held(got, want, field_atol=1e-7):
    """The kernel-logic tolerances (``test_b2_kernel_matches_plain``); Var
    rtol 1e-3, atol 1e-5 of the run's largest Var (Var scales with the
    lattice: ~1e-10 at L=16,384); the fields' atol 1e-7 unless a caller
    tightens it."""
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=field_atol)
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=field_atol)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5)
    assert torch.equal(got[3], want[3])
    torch.testing.assert_close(got[4], want[4], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[5][..., 2:4], want[5][..., 2:4],
                               rtol=5e-4, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(got[5][..., 0], want[5][..., 0], rtol=0,
                               atol=1e-5)
    var = want[5][..., 1]
    torch.testing.assert_close(got[5][..., 1], var, rtol=1e-3,
                               atol=1e-5 * float(var.abs().max()))
    torch.testing.assert_close(got[5][..., 4:], want[5][..., 4:],
                               rtol=1e-4, atol=1e-8)


def test_b2_is_the_same_at_every_cluster_size(dev):
    """The L=8192 banded row (pointwise, B=4) under every cluster size the
    card launches: the fields, tracers, ring and records EQUAL C=1's, under
    native Philox and at injected bits."""
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    gen, modes, scal, seeds, state, kw = _b2_large_case(
        dev, 8192, 4, dict(diffusion_solver="banded"))
    assert modes[:2] == ("pointwise", "banded")
    k = 40
    noise = _bits((4, k, 3, 64), gen, dev)
    circ = pk.call_circulants(8192, modes[0], modes[1], modes[2], modes[3])
    co = pk.card_coresident(0, 8192, 64, modes[0], circ)
    sizes = [C for C in pk.CLUSTER_SIZES if co[C] > 0]
    assert sizes[:3] == [1, 2, 4]
    runs = {}
    for C in sizes:
        plan = pk.pde_launch_plan(4, 8192, 64, modes[0], circ, co,
                                  cluster=C)
        runs[C] = [pk.pde_multi_step_planned(
            plan, scal, seeds, 3, *state, modes[3], modes[2], k_steps=k,
            noise=nz, **kw) for nz in (None, noise)]
    for C in sizes[1:]:
        for got, want in zip(runs[C], runs[1]):
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           equal_nan=True)


B2_LARGE = {  # (PDEConfig fields, γ (None: the recipe's), modes)
    "global-exact": (dict(gaussian_kernel=True, kernel_sigma=2e5,
                          diffusion_solver="dense"), None,
                     ("global", "exact")),
    "pointwise-banded": (dict(diffusion_solver="banded"), None,
                         ("pointwise", "banded")),
    "global-banded": (dict(gaussian_kernel=True, kernel_sigma=2e5,
                           diffusion_solver="banded"), None,
                      ("global", "banded")),
    "pointwise-neumann-exact": (dict(bc="neumann"), None,
                                ("pointwise", "exact")),
    "narrow-banded": (dict(gaussian_kernel=True, diffusion_solver="banded"),
                      None, ("narrow", "banded")),
    "narrow-none-anchored": (dict(gaussian_kernel=True,
                                  active_model="anchored_minus"), 0.0,
                             ("narrow", "none")),
    "smooth-exact": (dict(gaussian_kernel=True, kernel_sigma=0.05,
                          diffusion_solver="dense"), None,
                     ("smooth", "exact")),
}


@pytest.mark.parametrize("case, L", [
    (case, L) for L in (16_384, 65_536) for case in B2_LARGE] + [
    (case, 131_072) for case in ("global-exact", "pointwise-banded",
                                 "pointwise-neumann-exact")])
def test_b2_past_one_cta_matches_plain(dev, case, L):
    """Every m mode and solve past one CTA's shared memory, on the plan's
    cluster, against the plain version at injected bits (B=2, 64 tracers,
    the large-lattice recipe, 8 steps; the full circulant 3 steps; the
    narrow σ = 8.2 sites, r = 48); and at L = 131,072, the largest lattice
    a cluster serves with a global or pointwise m."""
    over, gamma, modes_want = B2_LARGE[case]
    if modes_want[0] == "narrow":
        over = dict(over, kernel_sigma=5e-4 * 16_384 / L)
    gen, modes, scal, seeds, state, kw = _b2_large_case(
        dev, L, 2, over, gamma=gamma, seed=L)
    assert modes[:2] == modes_want
    k = 3 if modes[0] == "smooth" else 8
    kw["noise"] = _bits((2, k, 3, 64), gen, dev)
    n0 = pde_multi_step.launches
    got = pde_multi_step(scal, seeds, 0, *state, modes[3], modes[2],
                         k_steps=k, **kw)
    assert pde_multi_step.launches == n0 + 1
    want = pde_multi_step_plain(scal, seeds, 0, *state, modes[3], modes[2],
                                k_steps=k, **kw)
    _b2_held(got, want)
    assert not torch.equal(got[0], state[0])


def _density_atol(want):
    """The fields' atol of the full smoothing's checks: 1e-7, or 1e-5 of
    the largest density where that is less."""
    return min(1e-7, 1e-5 * float(torch.maximum(want[0].abs().max(),
                                                want[1].abs().max())))


def _b2_m_field_held(state, modes, scal, seeds, kw):
    """The m field the FFT stage leaves for the step's reaction and
    tracers, site by site: one step from ``state`` with the launch's m
    field kept (``pde_multi_step.m_fields``) against ``m_field_of`` on the
    same densities, atol 1e-5."""
    pde_multi_step.m_fields = []
    try:
        pde_multi_step(scal, seeds, 0, *state, modes[3], modes[2],
                       k_steps=1, **kw)
        got = torch.cat(pde_multi_step.m_fields)
    finally:
        pde_multi_step.m_fields = None
    want = m_field_of("smooth", state[0], state[1], modes[2])
    assert got.shape == want.shape == (scal.shape[0], kw["L"])
    torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=1e-5)


# the two routes where both serve: (case of B2_LARGE, L)
B2_ROUTES = [("pointwise-banded", 65_536), ("narrow-banded", 65_536),
             ("global-banded", 131_072), ("pointwise-neumann-exact", 131_072)]


@pytest.mark.parametrize("case, L", B2_ROUTES)
def test_b2_routes_are_bitwise_equal(dev, case, L):
    """Where a cluster serves, the device-memory route forced at its own G
    (64 CTAs a replica, more than the scan's 16 tiles) and at G = 8 (two
    tiles a CTA) gives the cluster route's fields, tracers, ring and
    records bit for bit, under native Philox and at injected bits (B = 2,
    40 steps of the large-lattice recipe)."""
    from hydrolim_tpu_torch.ops import pde_kernel as pk

    over, gamma, modes_want = B2_LARGE[case]
    if modes_want[0] == "narrow":
        over = dict(over, kernel_sigma=5e-4 * 16_384 / L)
    gen, modes, scal, seeds, state, kw = _b2_large_case(
        dev, L, 2, over, gamma=gamma, seed=L + 1)
    assert modes[:2] == modes_want
    k = 40
    noise = _bits((2, k, 3, 64), gen, dev)
    circ = pk.call_circulants(L, modes[0], modes[1], modes[2], modes[3])
    co = pk.card_coresident(0, L, 64, modes[0], circ)
    ctas = functools.partial(pk.gmem_max_ctas, 0)
    plans = [pk.pde_route_plan(2, L, 64, modes[0], circ, co, ctas)]
    plans += [pk.pde_route_plan(2, L, 64, modes[0], circ, co, ctas,
                                route="gmem", ctas=G) for G in (None, 8)]
    assert [p.route for p in plans] == ["cluster", "gmem", "gmem"]
    assert plans[1].ctas > 16
    runs = [[pk.pde_multi_step_planned(p, scal, seeds, 5, *state, modes[3],
                                       modes[2], k_steps=k, noise=nz, **kw)
             for nz in (None, noise)] for p in plans]
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           equal_nan=True)
    assert not torch.equal(runs[0][0][0], state[0])


@pytest.mark.parametrize("case, L", [
    ("pointwise-banded", 262_144), ("pointwise-banded", 1_048_576),
    ("pointwise-banded", 4_194_304), ("global-banded", 262_144),
    ("narrow-banded", 262_144), ("pointwise-neumann-exact", 262_144),
    ("smooth-exact", 262_144), ("smooth-exact", 131_071),
    ("smooth-exact", 4_194_304), ("smooth-exact", SMOOTH_FFT_FROM),
    ("smooth-exact", 32_768), ("smooth-exact", 1_048_576)])
def test_b2_device_memory_route_matches_plain(dev, case, L):
    """Past a cluster's shared memory the card's plan is the device-memory
    route, held to the plain version at injected bits (B = 2, 64 tracers,
    the large-lattice recipe, 8 steps), at the three large lattices of
    the recipe and in every m mode and solve it serves at 262,144; the full
    smoothing (its FFT stage), which takes that route from the route line
    on (``SMOOTH_FFT_FROM``), also there and at 32,768 (where a cluster
    fits too), at the prime L = 131,071, the row wrapped and padded to
    262,144 points, and at 1,048,576 and 4,194,304 (512 x 8192 points),
    with the fields' atol 1e-5 of the largest density (a site holds ~1/L
    of the mass) and the stage's m field held site by site
    (``_b2_m_field_held``)."""
    over, gamma, modes_want = B2_LARGE[case]
    if modes_want[0] == "narrow":
        over = dict(over, kernel_sigma=5e-4 * 16_384 / L)
    gen, modes, scal, seeds, state, kw = _b2_large_case(
        dev, L, 2, over, gamma=gamma, seed=L)
    assert modes[:2] == modes_want
    k = 8
    kw["noise"] = _bits((2, k, 3, 64), gen, dev)
    n0 = dict(pde_multi_step.route_launches)
    fft0 = pde_multi_step.fft_launches
    got = pde_multi_step(scal, seeds, 0, *state, modes[3], modes[2],
                         k_steps=k, **kw)
    assert pde_multi_step.last_plan.route == "gmem"
    assert pde_multi_step.route_launches["gmem"] == n0["gmem"] + 1
    assert pde_multi_step.route_launches["cluster"] == n0["cluster"]
    assert pde_multi_step.fft_launches == fft0 + (modes[0] == "smooth")
    want = pde_multi_step_plain(scal, seeds, 0, *state, modes[3], modes[2],
                                k_steps=k, **kw)
    if modes[0] != "smooth":
        _b2_held(got, want)
    else:
        _b2_held(got, want, _density_atol(want))
        del kw["noise"]
        _b2_m_field_held(got[:5], modes, scal, seeds, kw)
    assert not torch.equal(got[0], state[0])


def _density_atol(want):
    """The fields' atol of the full smoothing's checks: 1e-7, or 1e-5 of
    the largest density where that is less."""
    return min(1e-7, 1e-5 * float(torch.maximum(want[0].abs().max(),
                                                want[1].abs().max())))


def _b2_m_field_held(state, modes, scal, seeds, kw):
    """The m field the FFT stage leaves for the step's reaction and
    tracers, site by site: one step from ``state`` with the launch's m
    field kept (``pde_multi_step.m_fields``) against ``m_field_of`` on the
    same densities, atol 1e-5."""
    pde_multi_step.m_fields = []
    try:
        pde_multi_step(scal, seeds, 0, *state, modes[3], modes[2],
                       k_steps=1, **kw)
        got = torch.cat(pde_multi_step.m_fields)
    finally:
        pde_multi_step.m_fields = None
    want = m_field_of("smooth", state[0], state[1], modes[2])
    assert got.shape == want.shape == (scal.shape[0], kw["L"])
    torch.testing.assert_close(got, want.to(got.dtype), rtol=0, atol=1e-5)


# |B2's mass change − the plain version's| after 1500 steps of the
# large-lattice recipe at L = 8192, the bound set from the readings
# (PERF.md, C8): 1.19e-5 and 1.58e-5 (β = 0.5, 2.5) after the repair of
# the circulant's law, 1.93e-5 and 5.90e-5 before it
B2_MASS_BOUND = 2.5e-5


def test_b2_mass_over_1500_steps_holds_the_plain_versions(dev):
    """C8: over 1500 steps of the large-lattice recipe (L = 8192, β = 0.5
    and 2.5, the driver's initial fields, pointwise m, the banded solve),
    the kernel's total mass moves as its plain version's does, within
    ``B2_MASS_BOUND`` of step 0's mass."""
    from hydrolim_tpu_torch.experiments.large_lattice import pde_rho0

    L = 8192
    gen, modes, scal, seeds, state, kw = _b2_large_case(
        dev, L, 2, dict(diffusion_solver="banded"))
    rho0 = [pde_rho0(L, 0, bi) for bi in range(2)]
    for i, c in ((0, 1.2), (1, 0.8)):
        state[i] = torch.tensor(np.stack([c * r[i] for r in rho0]),
                                dtype=torch.float32, device=dev)
    mass0 = (state[0] + state[1]).double().sum(-1)
    got = pde_multi_step(scal, seeds, 0, *state, modes[3], modes[2],
                         k_steps=1500, **kw)
    want = pde_multi_step_plain(scal, seeds, 0, *state, modes[3], modes[2],
                                k_steps=1500, generator=gen, **kw)
    moved = [((r[0] + r[1]).double().sum(-1) / mass0 - 1.0)
             for r in (got, want)]
    gap = (moved[0] - moved[1]).abs().max().item()
    assert gap < B2_MASS_BOUND, (moved, gap)


def test_run_pde_ensemble_full_smoothing_past_a_cluster(dev, monkeypatch):
    """``run_pde_ensemble`` with the full Gaussian m (σ = 0.05, 13,107
    sites) at L = 131,072 on the card: every block call on the
    device-memory route (its FFT stage), none on the cluster, against the
    same ensemble stepped by the plain version on the card from the same
    initial state: the fields at rtol 2e-4 and phase 4's atol 1e-7
    tightened to 1e-5 of the largest density (``_density_atol``), m atol
    1e-5, Var rtol 1e-3 (atol 1e-5 of the largest), the spectra rtol 1e-4
    / atol 1e-8 (the tracers' draws differ, and no field reads them)."""
    from hydrolim_tpu_torch.ops import pde_kernel as pk
    from hydrolim_tpu_torch.pde import fast_solve
    from hydrolim_tpu_torch.sweeps.pde_sweeps import run_pde_ensemble

    L, steps = 131_072, 40
    dt = 0.5 / L / 0.6
    config = PDEConfig(L=L, T=steps * dt, dt=dt, gaussian_kernel=True,
                       kernel_sigma=0.05, snapshot_interval=20, fft_kmax=8,
                       tracer_window_time=10 * dt * (1 + 1e-9))
    kw = dict(gamma=2.5 / L / L / dt, lam=0.6, n_runs=1, seed=3,
              n_tracers=64, device=dev)
    assert fast_solve.kernel_operands(config, kw["gamma"], dev)[0] == \
        "smooth"
    pk.reset_launches()
    got, _ = run_pde_ensemble(config, [0.5, 2.5], **kw)
    n = dict(pk.pde_multi_step.route_launches)
    assert n["gmem"] == pk.pde_multi_step.launches >= 1 and not n["cluster"]
    assert pk.pde_multi_step.fft_launches == n["gmem"]
    assert pk.pde_spectra.launches >= 1

    def plain(*args, generator=None, route=None, **k):
        return pk.pde_multi_step_plain(*args, generator=generator, **k)
    monkeypatch.setattr(fast_solve, "pde_multi_step", plain)
    want, _ = run_pde_ensemble(config, [0.5, 2.5], **kw)
    assert pk.pde_multi_step.launches == n["gmem"]
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    fa = _density_atol((t(want.rho_p), t(want.rho_m)))
    for a, b in ((got.rho_p, want.rho_p), (got.rho_m, want.rho_m),
                 (got.snapshots, want.snapshots)):
        torch.testing.assert_close(t(a), t(b), rtol=2e-4, atol=fa)
    rec, wrec = got.records, want.records
    torch.testing.assert_close(t(rec.m_mean), t(wrec.m_mean), rtol=0,
                               atol=1e-5)
    var = np.abs(wrec.var).max()
    torch.testing.assert_close(t(rec.var), t(wrec.var), rtol=1e-3,
                               atol=1e-5 * var)
    torch.testing.assert_close(t(rec.fft_ri), t(wrec.fft_ri), rtol=1e-4,
                               atol=1e-8)
    assert not np.array_equal(got.rho_p, got.snapshots[:, 0])


def test_b2_spectra_kernel_at_65536(dev):
    """The spectra kernel past one block's shared memory (L=65,536: the
    table and rows read through L2), at 8 bins (stage-1 sums in shared
    memory) and at every bin (in the device scratch), against
    ``pde_spectra_plain``: rtol 1e-4, atol 1e-6 as at L=1000, the sums
    being chains of 256 terms."""
    from hydrolim_tpu_torch.ops.pde_kernel import spectra_plan

    gen = torch.Generator(device=dev)
    gen.manual_seed(65)
    L = 65_536
    for kmax, rows in ((8, 12), (L // 2 + 1, 3)):
        plan = spectra_plan(1, rows, L, kmax)
        assert not plan.stage and plan.scratch == (kmax > 8)
        dens = torch.rand((1, rows, L), generator=gen, device=dev) + 0.5
        recs = torch.zeros((1, rows, 4 + 2 * kmax), device=dev)
        n0 = pde_spectra.launches
        pde_spectra(dens, recs, kmax)
        assert pde_spectra.launches == n0 + 1
        torch.testing.assert_close(recs[..., 4:],
                                   pde_spectra_plain(dens, kmax),
                                   rtol=1e-4, atol=1e-6)


def _exclusion_inputs(dev, *, B, K, L, sigma, periodic, seed):
    cfg = ParticleConfig(L=L, N=(K * L) // 2, init="fixed", scale_rates=False,
                         local_kernel_sigma=sigma, periodic=periodic,
                         site_capacity=K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    slots = init_payload_slots(cfg, gen, B=B, device=dev)
    scal = torch.stack([torch.linspace(0.0, 3.0, B, device=dev),
                        torch.full((B,), 1.0, device=dev),
                        torch.full((B,), 3.0, device=dev)], 1).contiguous()
    band = build_smoothing_band(cfg, dev) if sigma > 0 else None
    return gen, slots, scal, band


@pytest.mark.parametrize("sigma,periodic,bidirectional", [
    (0.0, True, True),          # global m
    (0.002, False, False),      # local m, the flagship smoothing
])
def test_b3_kernel_equals_plain(dev, sigma, periodic, bidirectional):
    """40 steps at injected bits: slots EQUAL to the plain version's."""
    B, K, L, k = 5, 3, 1000, 40
    gen, slots, scal, band = _exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=sigma, periodic=periodic, seed=K)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=k, dt=0.02, periodic=periodic,
              bidirectional=bidirectional,
              noise=_bits((B, k, 2, K, L), gen, dev))
    n0 = exclusion_multi_step.launches
    got = exclusion_multi_step(scal, seeds, slots, band, **kw)
    assert exclusion_multi_step.launches == n0 + 1
    want = exclusion_multi_step_plain(scal, seeds, slots, band, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, slots)


def test_b3_kernel_equals_plain_on_a_bent_band(dev):
    """A band with one interior row changed (so not one row of taps): the
    kernel reads that row from the band, and stays EQUAL to the plain
    version."""
    B, K, L, k = 3, 3, 1000, 40
    cfg = ParticleConfig(L=L, N=(K * L) // 2, init="fixed",
                         scale_rates=False, local_kernel_sigma=0.005,
                         periodic=False, site_capacity=K)
    idx, w = band_weights(cfg)
    w = w.copy()
    w[L // 3] *= 1.5
    band = smoothing_band(idx, w, device=dev)
    _, _, lo, hi = band_interior(idx, w)
    assert not lo <= L // 3 < hi
    gen, slots, scal, _ = _exclusion_inputs(dev, B=B, K=K, L=L, sigma=0.0,
                                            periodic=False, seed=4)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=k, dt=0.02, periodic=False, bidirectional=False,
              noise=_bits((B, k, 2, K, L), gen, dev))
    got = exclusion_multi_step(scal, seeds, slots, band, **kw)
    want = exclusion_multi_step_plain(scal, seeds, slots, band, **kw)
    assert torch.equal(got, want)


def test_b3_native_streams_conserve(dev):
    """Native Philox: deterministic per (seed, step0), a new stream per
    step0; particle ids conserved and occupancy ≤ K."""
    B, K, L = 4, 3, 500
    _, slots, scal, band = _exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=0.01, periodic=False, seed=1)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=200, dt=0.01, periodic=False, bidirectional=False)
    a = exclusion_multi_step(scal, seeds, slots, band, step0=0, **kw)
    b = exclusion_multi_step(scal, seeds, slots, band, step0=0, **kw)
    c = exclusion_multi_step(scal, seeds, slots, band, step0=200, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for r in range(B):
        assert torch.equal(a[r].abs()[a[r] != 0].sort().values,
                           slots[r].abs()[slots[r] != 0].sort().values)
    assert int((a != 0).sum(1).max()) <= K


def test_b3_wrapper_refusals(dev):
    """Wrong dtype, non-contiguous slots, and a K·L past the shared memory
    of a cluster of 8 CTAs are refused before any launch."""
    B, K, L = 2, 3, 256
    _, slots, scal, _ = _exclusion_inputs(dev, B=B, K=K, L=L, sigma=0.0,
                                          periodic=True, seed=2)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=1, dt=0.01, periodic=True, bidirectional=True)
    n0 = exclusion_multi_step.launches
    with pytest.raises(ValueError):
        exclusion_multi_step(scal, seeds, slots.to(torch.int64), **kw)
    with pytest.raises(ValueError):
        exclusion_multi_step(scal, seeds, slots.transpose(1, 2).contiguous()
                             .transpose(1, 2), **kw)
    big = torch.zeros((1, 8, 20_000), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        exclusion_multi_step(scal[:1], seeds[:1], big, **kw)
    assert exclusion_multi_step.launches == n0


# chip_smoke.B3_CHECKS: (K, σ, periodic, bidirectional)
B3_CONFIGS = {
    "global m, periodic, bidirectional": (3, 0.0, True, True),
    "local m sigma=0.002, walls": (3, 0.002, False, False),
    "local m sigma=0.02, periodic": (3, 0.02, True, False),
    "K=1, local m sigma=0.005, walls": (1, 0.005, False, False),
}


def _b3_plan(dev, B, K, L, band, periodic, C=None):
    return card_plan(B, K, L, band, periodic, dev.index, cluster=C)


@pytest.mark.parametrize("L", [1000, 999])
@pytest.mark.parametrize("B", [4, 33])
@pytest.mark.parametrize("config", list(B3_CONFIGS))
def test_b3_kernel_equals_plain_under_every_cluster_size(dev, config, B, L):
    """40 steps at injected bits under each cluster size C ≤ 8 (the
    periodic σ=0.02 band, 215 taps, carries its band in the halo up to
    C=4 and reads the exchanged count field past it): slots EQUAL to the
    plain version's."""
    K, sigma, periodic, bidi = B3_CONFIGS[config]
    k = 40
    gen, slots, scal, band = _exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=sigma, periodic=periodic, seed=B + L)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=k, dt=0.02, periodic=periodic, bidirectional=bidi,
              noise=_bits((B, k, 2, K, L), gen, dev))
    want = exclusion_multi_step_plain(scal, seeds, slots, band, **kw)
    assert not torch.equal(want, slots)
    ran = []
    for C in range(1, 9):
        try:
            plan = _b3_plan(dev, B, K, L, band, periodic, C)
        except ValueError:
            continue
        n0 = exclusion_multi_step.launches
        got = exclusion_multi_step_planned(plan, scal, seeds, slots, band,
                                           **kw)
        assert exclusion_multi_step.launches == n0 + 1
        assert torch.equal(got, want), f"C={C}"
        ran.append(C)
    assert ran == list(range(1, 9))


def test_b3_band_rows_of_any_form_under_every_cluster_size(dev):
    """A band with a bent interior row (read with its own weights) and a
    row whose inputs run in descending order (no rotation of the taps: the
    kernel reads its index table), at walls and on a torus: slots EQUAL to
    the plain version's under every cluster size."""
    B, K, L, k = 3, 3, 1000, 40
    for periodic in (False, True):
        cfg = ParticleConfig(L=L, N=(K * L) // 2, init="fixed",
                             scale_rates=False, local_kernel_sigma=0.005,
                             periodic=periodic, site_capacity=K)
        idx, w = band_weights(cfg)
        idx, w = idx.copy(), w.copy()
        w[L // 3] *= 1.5
        idx[L // 2], w[L // 2] = idx[L // 2, ::-1], w[L // 2, ::-1]
        band = smoothing_band(idx, w, device=dev)
        assert band_rotation(idx, w, periodic)[L // 2] == -1
        gen, slots, scal, _ = _exclusion_inputs(
            dev, B=B, K=K, L=L, sigma=0.0, periodic=periodic, seed=6)
        seeds = torch.zeros(B, dtype=torch.int32, device=dev)
        kw = dict(k_steps=k, dt=0.02, periodic=periodic,
                  bidirectional=False, noise=_bits((B, k, 2, K, L), gen, dev))
        want = exclusion_multi_step_plain(scal, seeds, slots, band, **kw)
        for C in range(1, 9):
            got = exclusion_multi_step_planned(
                _b3_plan(dev, B, K, L, band, periodic, C), scal, seeds,
                slots, band, **kw)
            assert torch.equal(got, want), f"periodic={periodic} C={C}"


def test_b3_native_stream_is_the_same_under_every_plan(dev):
    """Native Philox: the same (seed, step0) gives the same slots whatever
    the cluster size, at global and local m."""
    B, K, L = 6, 3, 1000
    for sigma in (0.0, 0.002):
        _, slots, scal, band = _exclusion_inputs(
            dev, B=B, K=K, L=L, sigma=sigma, periodic=False, seed=7)
        seeds = torch.arange(3, 3 + B, dtype=torch.int32, device=dev)
        kw = dict(k_steps=300, dt=0.01, periodic=False, bidirectional=False,
                  step0=123)
        ref = exclusion_multi_step(scal, seeds, slots, band, **kw)
        assert not torch.equal(ref, slots)
        for C in range(1, 9):
            got = exclusion_multi_step_planned(
                _b3_plan(dev, B, K, L, band, False, C), scal, seeds, slots,
                band, **kw)
            assert torch.equal(got, ref), f"sigma={sigma} C={C}"


def test_b3_past_one_block(dev):
    """L=8192 at K=3 (more than one block's shared memory) runs on a
    cluster: particle ids conserved, occupancy ≤ K, and EQUAL to the plain
    version at injected bits."""
    B, K, L, k = 3, 3, 8192, 20
    gen, slots, scal, band = _exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=0.002, periodic=False, seed=9)
    assert _b3_plan(dev, B, K, L, band, False).cluster >= 2
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=k, dt=0.02, periodic=False, bidirectional=False)
    got = exclusion_multi_step(scal, seeds, slots, band, **kw)
    for r in range(B):
        assert torch.equal(got[r].abs()[got[r] != 0].sort().values,
                           slots[r].abs()[slots[r] != 0].sort().values)
    assert int((got != 0).sum(1).max()) <= K
    assert not torch.equal(got, slots)
    kw["noise"] = _bits((B, k, 2, K, L), gen, dev)
    assert torch.equal(exclusion_multi_step(scal, seeds, slots, band, **kw),
                       exclusion_multi_step_plain(scal, seeds, slots, band,
                                                  **kw))


@pytest.mark.parametrize("sigma,periodic", [
    (0.3, False),      # the σ sweep's σ=0.3: reflect radius 1200 ≥ L
    (2.0, True),       # the phase diagram's σ=2.0: 2r+1 ≥ L on the torus
    (0.1, False),      # the σ sweep's σ=0.1: 801 taps
])
def test_b3_dense_band_equals_plain(dev, sigma, periodic):
    """The wide and dense bands, on the exchanged count field at the
    plan's C > 1: 40 steps at injected bits, slots EQUAL to the plain
    version's under the plan and every C ≤ 8; native Philox at the plan's
    C EQUAL to C=1."""
    B, K, L, k = 4, 3, 1000, 40
    gen, slots, scal, band = _exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=sigma, periodic=periodic, seed=7)
    assert tuple(band.idx.shape) == (L, 801 if sigma == 0.1 else L)
    plan = card_plan(B, K, L, band, periodic)
    assert plan.cluster > 1 and plan.exchange
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    kw = dict(k_steps=k, dt=0.02, periodic=periodic, bidirectional=periodic,
              noise=_bits((B, k, 2, K, L), gen, dev))
    got = exclusion_multi_step(scal, seeds, slots, band, **kw)
    want = exclusion_multi_step_plain(scal, seeds, slots, band, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, slots)
    for C in range(1, 9):
        got = exclusion_multi_step_planned(
            _b3_plan(dev, B, K, L, band, periodic, C), scal, seeds, slots,
            band, **kw)
        assert torch.equal(got, want), f"C={C}"
    kw = dict(k_steps=300, dt=0.02, periodic=periodic,
              bidirectional=periodic, step0=11)
    seeds = torch.arange(B, dtype=torch.int32, device=dev)
    ref = exclusion_multi_step_planned(_b3_plan(dev, B, K, L, band, periodic,
                                                1), scal, seeds, slots,
                                       band, **kw)
    assert torch.equal(exclusion_multi_step(scal, seeds, slots, band, **kw),
                       ref)
    assert not torch.equal(ref, slots)


@pytest.mark.parametrize("kmax", [8, 40, 501])
def test_b2_spectra_kernel_equals_plain(dev, kmax, monkeypatch):
    """The spectra computed by ``pde_spectra`` from the step's densities
    are within the spectra tolerance (rtol 1e-4, atol 1e-8) of the plain
    version; a call whose density scratch is cut into pieces of 7 steps
    (9 launches of each kernel) EQUALS the call in one launch, fields,
    tracers and records, at injected bits and under native Philox; the
    spectra kernel alone against ``pde_spectra_plain`` on uniform random
    rows in [0.5, 1.5), whose bins are sums of L terms of size ~1 in
    another order than cuBLAS's: rtol 1e-4, atol 1e-6 (√L·2⁻²⁴·1.5,
    float32's typical rounding of such a sum, over L = 1000 is 3e-6)."""
    from hydrolim_tpu_torch.ops import pde_kernel
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    B, L, k = 2, 1000, 60
    config = PDEConfig(L=L, dt=5e-4, n_tracers=64, gaussian_kernel=True,
                       kernel_sigma=0.005, fft_kmax=kmax,
                       tracer_window_time=20 * 5e-4 * (1 + 1e-9))
    m_mode, solve_mode, smooth, solve = kernel_operands(config, 0.0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(kmax)
    rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                noise=0.3, n_tracers=64, device=dev)
    args = (torch.tensor([[1.5, 0.6, 0.0, 0.0]] * B, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev), 0, rp, rm,
            tr.unwrapped, tr.spin.float(), tr.hist, solve, smooth)
    kw = dict(L=L, n_t=64, window=config.tracer_window, k_steps=k,
              dt=config.dt, xlim=config.xlim, periodic=True, m_mode=m_mode,
              solve_mode=solve_mode, bidirectional=True, kmax_rec=kmax)
    noise = _bits((B, k, 3, 64), gen, dev)
    for nz in (noise, None):
        n0, m0 = pde_spectra.launches, pde_multi_step.launches
        whole = pde_multi_step(*args, noise=nz, **kw)
        assert (pde_spectra.launches - n0, pde_multi_step.launches - m0) \
            == (1, 1)
        with monkeypatch.context() as mp:
            mp.setattr(pde_kernel, "SPECTRA_SCRATCH_BYTES", 4 * B * 7 * L)
            cut = pde_multi_step(*args, noise=nz, **kw)
        assert (pde_spectra.launches - n0, pde_multi_step.launches - m0) \
            == (10, 10)
        for a, b in zip(whole, cut):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    kw["noise"] = noise
    sep = pde_multi_step(*args, **kw)[-1]
    want = pde_multi_step_plain(*args, **kw)[-1]
    torch.testing.assert_close(sep[..., 4:], want[..., 4:], rtol=1e-4,
                               atol=1e-8)
    dens = torch.rand((3, 7, L), generator=gen, device=dev) + 0.5
    recs = torch.zeros((3, 7, 4 + 2 * kmax), device=dev)
    pde_spectra(dens, recs, kmax)
    torch.testing.assert_close(recs[..., 4:], pde_spectra_plain(dens, kmax),
                               rtol=1e-4, atol=1e-6)
    assert not recs[..., :4].any()


@pytest.mark.parametrize("periodic", [True, False])
def test_run_particles_routes_on_the_card(dev, periodic):
    """``run_particles`` on CUDA tensors takes kernel B1 inside its scope
    (periodic, the fixed init) and the torch fast path outside it (walls):
    the launch counter shows which."""
    from hydrolim_tpu_torch.particles.run import B1_ROUTE, TORCH_ROUTE
    from hydrolim_tpu_torch.particles.system import ParticleSystem

    ps = ParticleSystem(L=256, xlim=1, rate_diffusion=0.5, rate_active=2.0,
                        beta=2.0, N=1000, periodic=periodic,
                        site_capacity=None, local_kernel_sigma=0.0,
                        scale_rates=False, active_model="bidirectional",
                        rng=0, device="cuda")
    n0 = meanfield_multi_step.launches
    out = ps.run(T=2.0, obs_dt=0.5)
    n = meanfield_multi_step.launches - n0
    assert ps.last_run_info["engine"] == (B1_ROUTE if periodic
                                          else TORCH_ROUTE)
    assert (n > 0) == periodic
    assert np.isfinite(out["m_global"]).all()
    if not periodic:
        assert 0 <= out["pos_frames"].min() <= out["pos_frames"].max() < 256


def _matched_slot_draws(gen, B, K, L, dev):
    """One step's draws for kernel B3 and the slot engine at once: event
    bits, and a distinct random rank per slot, encoded as B3's priority
    bits (``rank << 6``) and as the slot engine's priority
    (``rank << 17 | slot id``): no ties, so the same admission."""
    from hydrolim_tpu_torch.ops.stepper_kernel import bits_to_uniform

    u_bits = _bits((B, K, L), gen, dev)
    rank = torch.rand((B, K * L), generator=gen, device=dev).argsort(
        1).reshape(B, K, L)
    noise = torch.stack([u_bits, (rank << 6).to(torch.int32)], 1)[:, None]
    ids = torch.arange(K * L, device=dev).reshape(K, L)
    return noise, bits_to_uniform(u_bits.to(torch.int64)), (rank << 17) | ids


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("sigma,periodic,bidirectional", [
    (0.0, True, True),          # global m
    (0.005, False, False),      # local m, walls
])
def test_slot_engine_step_equals_b3_kernel(dev, K, sigma, periodic,
                                           bidirectional):
    """30 steps at dt = 0.02, rd = 1, ra = 3 (where the slot engine's
    (rd + ra)·Δt and B3's rd·Δt + ra·Δt round alike): the plain-torch
    ``lgk_step`` on the card and kernel B3 at the same bits, spins EQUAL
    after every step, one B3 launch per step."""
    from hydrolim_tpu_torch.core.config import ParticleParams
    from hydrolim_tpu_torch.particles.lattice_gas_k import lgk_step

    B, L, dt = 4, 1000, 0.02
    gen, slots, scal, band = _exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=sigma, periodic=periodic, seed=K)
    cfg = ParticleConfig(L=L, N=(K * L) // 2, init="fixed",
                         scale_rates=False, local_kernel_sigma=sigma,
                         periodic=periodic, site_capacity=K,
                         active_model="bidirectional" if bidirectional
                         else "plus_forward")
    zero = torch.zeros(B, device=dev)
    params = ParticleParams(beta=scal[:, 0], rate_diffusion=scal[:, 1],
                            rate_active=scal[:, 2], k_on=zero, k_off=zero,
                            k_exit=zero)
    seeds = torch.zeros(B, dtype=torch.int32, device=dev)
    spins = torch.sign(slots)
    n0 = exclusion_multi_step.launches
    for s in range(30):
        noise, u, prio = _matched_slot_draws(gen, B, K, L, dev)
        slots = exclusion_multi_step(scal, seeds, slots, band, k_steps=1,
                                     dt=dt, periodic=periodic,
                                     bidirectional=bidirectional,
                                     noise=noise)
        spins, _, _ = lgk_step(cfg, params, band, spins, dt,
                               _inject=(u, prio))
        assert torch.equal(torch.sign(slots), spins), f"step {s}"
    assert exclusion_multi_step.launches == n0 + 30
    assert not torch.equal(spins, torch.sign(_exclusion_inputs(
        dev, B=B, K=K, L=L, sigma=sigma, periodic=periodic, seed=K)[1]))


# τ-leap configurations for the card-against-CPU checks: ParticleConfig
# fields beyond L=1000, N=900, K=3, the fixed init, plus_forward, and the
# anchor rates where there are anchors
TAU_LEAP_CASES = {
    "K=3 local m walls": dict(local_kernel_sigma=0.002, periodic=False),
    "anchors bind/unbind/exit": dict(
        local_kernel_sigma=0.002, periodic=False, N=600,
        anchor_positions=(0.25, 0.6, 0.8), anchor_radius=0.01,
        exit_buffer=600),
    "K=12 sort path": dict(site_capacity=12, N=3000, periodic=True,
                           local_kernel_sigma=0.0),
}


def _tau_leap_inputs(case, dev, B=8):
    from hydrolim_tpu_torch.particles.init import init_particles
    from hydrolim_tpu_torch.particles.stepper import (
        ParticleState,
        build_static_arrays,
        with_exit_log,
    )
    from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params

    kw = dict(L=1000, N=900, init="fixed", scale_rates=False,
              site_capacity=3, active_model="plus_forward")
    kw.update(TAU_LEAP_CASES[case])
    cfg = ParticleConfig(**kw)
    rates = dict(rate_diffusion=1.0, rate_active=3.0, k_on=20.0, k_off=2.0,
                 k_exit=10.0)
    params = {d: broadcast_params(cfg, beta=np.linspace(0, 3, B),
                                  device=d, **rates) for d in ("cpu", dev)}
    gen = torch.Generator().manual_seed(7)
    st = init_particles(cfg, gen, B=B, device="cpu")
    state = with_exit_log(cfg, ParticleState(
        pos=st.pos, sigma=st.sigma, wind=torch.zeros_like(st.pos),
        alive=st.alive)).__dict__
    state = {d: ParticleState(**{k: v.to(d) for k, v in state.items()})
             for d in ("cpu", dev)}
    statics = {d: build_static_arrays(cfg, d) for d in ("cpu", dev)}
    return cfg, params, state, statics


STATE_FIELDS = ("pos", "wind", "sigma", "bound", "alive", "init_bin",
                "exit_count", "exit_times", "exit_pos", "exit_init_bin")


@pytest.mark.parametrize("case", list(TAU_LEAP_CASES))
def test_tau_leap_step_on_the_card_equals_cpu(dev, case):
    """50 steps of the τ-leap step on the card and on the CPU from the
    same state at the same injected (u, bits), Δt = 0.01: every event
    equal, or an event that differs has its u within 1e-6 of one of its
    thresholds (one ulp of m or of a flip rate apart); where the events
    agree the whole state and exit log are equal.  The card's state goes
    on."""
    from hydrolim_tpu_torch.particles.stepper import draw_events, step

    cfg, params, state, statics = _tau_leap_inputs(case, dev)
    B, n = state["cpu"].pos.shape
    rng = np.random.default_rng(3)
    moved = 0
    for i in range(50):
        u = torch.tensor(rng.random((B, n), dtype=np.float32))
        bits = torch.tensor(rng.integers(0, 2 ** 32, (B, n)))
        ev = {d: draw_events(cfg, params[d], statics[d], state[d], 0.01,
                             u.to(d))[:2] for d in ("cpu", dev)}
        new = {d: step(cfg, params[d], statics[d], state[d], 0.01, i * 0.01,
                       _inject=(u.to(d), bits.to(d))) for d in ("cpu", dev)}
        diff = ev["cpu"][0] != ev[dev][0].cpu()
        if diff.any():
            gap = (u[..., None] - ev["cpu"][1]).abs().min(-1).values
            assert (gap[diff] < 1e-6).all(), (case, i, gap[diff])
        else:
            for k in STATE_FIELDS:
                a, b = getattr(new["cpu"], k), getattr(new[dev], k).cpu()
                assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0)) \
                    if a.is_floating_point() else torch.equal(a, b), (case,
                                                                     i, k)
        moved += int((new[dev].pos != state[dev].pos).sum())
        state = {dev: new[dev], "cpu": type(new[dev])(**{
            k: (v.cpu() if v is not None else None)
            for k, v in new[dev].__dict__.items()})}
    assert moved > 0
    if case.startswith("anchors"):
        assert int(state[dev].exit_count.sum()) > 0


def test_tau_leap_step_and_run_issue_no_host_sync(dev):
    """Under ``torch.cuda.set_sync_debug_mode('error')`` the τ-leap step
    (anchors, local m, walls) and a 2-frame ``run_particles`` run without
    one host synchronisation."""
    from hydrolim_tpu_torch.particles.run import TAU_LEAP_ROUTE, run_particles
    from hydrolim_tpu_torch.particles.stepper import step

    cfg, params, state, statics = _tau_leap_inputs(
        "anchors bind/unbind/exit", dev)
    st = state[dev]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(5):
            st = step(cfg, params[dev], statics[dev], st, 0.01, i * 0.01,
                      generator=gen)
        res = run_particles(cfg, params[dev], state[dev], T=0.1,
                            obs_dt=0.05, dt=0.01, seed=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.engine == TAU_LEAP_ROUTE
    assert res.frames.m_local.shape == (8, 2, 1000)
    assert torch.isfinite(res.frames.m_local).all()


# ---------------------------------------------------------------------------
# chunked checkpoint/resume on the card: the run in chunks, stopped and
# resumed from disk, equals the run in one piece bit for bit
# ---------------------------------------------------------------------------

def _equal_tree(a, b, what):
    for name, x in a.items():
        y = b[name]
        if x is None:
            assert y is None, f"{what}.{name}"
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}.{name}"
        assert x.device == y.device, f"{what}.{name}"
        assert torch.equal(x.nan_to_num(7.0) if x.is_floating_point() else x,
                           y.nan_to_num(7.0) if y.is_floating_point() else y
                           ), f"{what}.{name}"


def test_b1_route_chunked_equals_one_piece(dev, tmp_path):
    """``run_particles_checkpointed`` on B1's route (periodic mean field,
    the fixed init): stopped after one 3-frame chunk and resumed, frames
    and final state equal the unsplit run's; B1 launched."""
    import dataclasses

    from hydrolim_tpu_torch.particles.run import B1_ROUTE, run_particles
    from hydrolim_tpu_torch.sweeps.ensemble import (
        broadcast_params,
        ensemble_states,
    )
    from hydrolim_tpu_torch.utils.checkpoint import (
        run_particles_checkpointed,
    )

    cfg = ParticleConfig(L=64, N=96, init="fixed", scale_rates=False,
                         periodic=True, site_capacity=None,
                         local_kernel_sigma=0.0)
    p = broadcast_params(cfg, beta=[0.8, 2.0], rate_diffusion=5.0,
                         rate_active=3.0, device=dev)
    st = ensemble_states(cfg, 2, 3, device=dev)
    run = dict(T=1.0, obs_dt=0.1, dt=0.005, seed=11)
    want = run_particles(cfg, p, st, **run)
    assert want.engine == B1_ROUTE
    ck = dict(ckpt_dir=tmp_path / "ck", chunk_frames=3)
    assert run_particles_checkpointed(cfg, p, st, stop_after_chunks=1,
                                      **run, **ck) is None
    meanfield_multi_step.launches = 0
    got = run_particles_checkpointed(cfg, p, st, **run, **ck)
    assert meanfield_multi_step.launches == 7          # frames 4..10
    _equal_tree(want.frames._asdict(), got.frames._asdict(), "frames")
    asdict = lambda s: {f.name: getattr(s, f.name)
                        for f in dataclasses.fields(s)}
    _equal_tree(asdict(want.final_state), asdict(got.final_state), "state")


def test_b2_chunked_equals_one_piece_across_a_window_split(dev, tmp_path):
    """``pde_solve_checkpointed`` on B2 (smooth m, exact solve): chunks of
    3 blocks of 10 steps split at step 30, which is not a multiple of the
    tracer window (14 steps); stopped after one chunk and resumed, every
    record, snapshot and the final fields equal the unsplit solve's, and
    both leave the generator in the same state."""
    from hydrolim_tpu_torch.core.config import PDEParams
    from hydrolim_tpu_torch.pde.fast_solve import pde_solve_fused
    from hydrolim_tpu_torch.utils.checkpoint import pde_solve_checkpointed

    cfg = PDEConfig(L=96, T=0.087, dt=1e-3, bc="periodic",
                    active_model="bidirectional", gaussian_kernel=True,
                    kernel_sigma=0.05, snapshot_interval=10, fft_kmax=12,
                    tracer_window_time=0.014, n_tracers=24)
    assert cfg.tracer_window == 14 and 30 % cfg.tracer_window
    full = lambda v: torch.full((2,), v, device=dev)
    params = PDEParams(gamma=full(0.2), lam=full(0.6),
                       beta=torch.tensor([0.5, 2.0], device=dev))

    def inputs():
        gen = torch.Generator(device=dev)
        gen.manual_seed(4)
        return (*pde_initialize(cfg, gen, B=2, mode="homogeneous",
                                noise=0.3, n_tracers=24, device=dev), gen)

    *x, gen_a = inputs()
    want = pde_solve_fused(cfg, params, *x, gen_a)
    *x, gen_b = inputs()
    ck = dict(ckpt_dir=tmp_path / "ck", chunk_blocks=3)
    assert pde_solve_checkpointed(cfg, params, *x, gen_b,
                                  stop_after_chunks=1, **ck) is None
    *x, gen_b = inputs()
    pde_multi_step.launches = 0
    got = pde_solve_checkpointed(cfg, params, *x, gen_b, **ck)
    assert pde_multi_step.launches == 6                # blocks 3..8
    fields = lambda r: dict(rho_p=r.rho_p, rho_m=r.rho_m,
                            snapshots=r.snapshots, m_snapshots=r.m_snapshots,
                            snap_times=r.snap_times,
                            **{k: getattr(r.records, k) for k in (
                                "m_mean", "var", "fft_ri", "v_eff", "D_eff")})
    _equal_tree(fields(want), fields(got), "pde")
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.parametrize("K,sigma,periodic", [(3, 0.02, False),
                                              (1, 0.0, True)])
def test_b3_chunked_equals_one_piece(dev, tmp_path, K, sigma, periodic):
    """``run_exclusion_sweep(ckpt_dir=)`` on B3: 4-frame chunks, stopped
    after one and resumed; frames, unwrapped tracer positions and the
    final slots equal the unsplit run's."""
    from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params
    from hydrolim_tpu_torch.sweeps.fast_exclusion import run_exclusion_sweep

    cfg = ParticleConfig(L=200, N=150 * K, init="fixed", scale_rates=False,
                         periodic=periodic, site_capacity=K,
                         local_kernel_sigma=sigma)
    p = broadcast_params(cfg, beta=[0.5, 2.5], rate_diffusion=0.5,
                         rate_active=3.0, n_runs=2, device=dev)
    run = dict(T=1.5, obs_dt=0.1, dt=0.01, seed=3, device=dev,
               n_tracers=64)
    want = run_exclusion_sweep(cfg, p, **run)
    ck = dict(ckpt_dir=tmp_path / "ck", chunk_frames=4)
    assert run_exclusion_sweep(cfg, p, stop_after_chunks=1, **run,
                               **ck) is None
    exclusion_multi_step.launches = 0
    got = run_exclusion_sweep(cfg, p, **run, **ck)
    assert exclusion_multi_step.launches == 11         # frames 4..14
    _equal_tree(want[0]._asdict(), got[0]._asdict(), "frames")
    assert torch.equal(want[1], got[1])


# ---------------------------------------------------------------------------
# b0: a launch of rows [b0, b0 + n) draws the whole batch's launch's streams
# ---------------------------------------------------------------------------

def test_b1_rows_at_b0_equal_the_whole_launch(dev):
    """Native Philox keyed on (seed[b], b0 + b): rows [2, 5) launched with
    b0=2 equal rows [2, 5) of the whole batch's launch bit for bit, and at
    injected bits the kernel at b0 > 0 equals its plain version."""
    B, N, L, k = 6, 5000, 256, 300
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    scal, pos, sig, wind = _b1_state(dev, gen, B, N, L)
    seeds = torch.arange(11, 11 + B, dtype=torch.int32, device=dev)
    kw = dict(L=L, k_steps=k, dt=0.01, bidirectional=True, step0=77)
    whole = meanfield_multi_step(scal, seeds, pos, sig, wind, **kw)
    rows = slice(2, 5)
    part = meanfield_multi_step(*(t[rows].contiguous() for t in (
        scal, seeds, pos, sig, wind)), b0=2, **kw)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[rows])
    noise = _bits((3, 20, N), gen, dev)
    args = [t[rows].contiguous() for t in (scal, seeds, pos, sig, wind)]
    kw = dict(L=L, k_steps=20, dt=0.01, bidirectional=True, noise=noise)
    for a, b in zip(meanfield_multi_step(*args, b0=2, **kw),
                    meanfield_multi_step_plain(*args, b0=2, **kw)):
        assert torch.equal(a, b)


def test_b3_rows_at_b0_equal_the_whole_launch(dev):
    """As B1's, at global and local m."""
    B, K, L = 6, 3, 1000
    for sigma in (0.0, 0.002):
        gen, slots, scal, band = _exclusion_inputs(
            dev, B=B, K=K, L=L, sigma=sigma, periodic=False, seed=7)
        seeds = torch.arange(3, 3 + B, dtype=torch.int32, device=dev)
        kw = dict(k_steps=300, dt=0.01, periodic=False, bidirectional=False,
                  step0=123)
        whole = exclusion_multi_step(scal, seeds, slots, band, **kw)
        rows = slice(3, 6)
        part = exclusion_multi_step(scal[rows].contiguous(), seeds[rows],
                                    slots[rows].contiguous(), band, b0=3,
                                    **kw)
        assert torch.equal(part, whole[rows]), f"sigma={sigma}"
        noise = _bits((3, 20, 2, K, L), gen, dev)
        kw = dict(k_steps=20, dt=0.01, periodic=False, bidirectional=False,
                  noise=noise)
        args = (scal[rows].contiguous(), seeds[rows],
                slots[rows].contiguous(), band)
        assert torch.equal(exclusion_multi_step(*args, b0=3, **kw),
                           exclusion_multi_step_plain(*args, b0=3, **kw))


def test_b2_rows_at_b0_equal_the_whole_launch(dev):
    """As B1's: native tracer draws keyed on the global replica index."""
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands

    B, n_t, W, k, L = 4, 200, 10, 40, 256
    config = PDEConfig(L=L, dt=5e-4, n_tracers=n_t, fft_kmax=8,
                       tracer_window_time=W * 5e-4 * (1 + 1e-9))
    m_mode, solve_mode, smooth, solve = kernel_operands(config, 0.2, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rp, rm, tr = pde_initialize(config, gen, B=B, mode="homogeneous",
                                noise=0.3, n_tracers=n_t, device=dev)
    scal = torch.tensor([[b, 0.6, 0.2, 0.0] for b in (0.5, 1.5, 2.0, 3.0)],
                        device=dev)
    seeds = torch.arange(5, 5 + B, dtype=torch.int32, device=dev)
    state = [rp, rm, tr.unwrapped, tr.spin.float(), tr.hist]
    kw = dict(L=L, n_t=n_t, window=W, k_steps=k, dt=5e-4, xlim=1.0,
              periodic=True, m_mode=m_mode, solve_mode=solve_mode,
              bidirectional=True, kmax_rec=config.kmax)
    whole = pde_multi_step(scal, seeds, 7, *state, solve, smooth, **kw)
    rows = slice(1, 3)
    part = pde_multi_step(scal[rows].contiguous(), seeds[rows], 7,
                          *(t[rows].contiguous() for t in state), solve,
                          smooth, b0=1, **kw)
    for a, b in zip(part, whole):       # the records hold NaN v/D at first
        torch.testing.assert_close(a, b[rows], rtol=0, atol=0,
                                   equal_nan=True)


# ---------------------------------------------------------------------------
# the lattice over a 'space' mesh of four segments of the one card
# ---------------------------------------------------------------------------

FOUR = ["cuda:0"] * 4


@pytest.mark.parametrize("engine", ["lg", "lgk", "grid"])
def test_lattice_sharding_on_the_card_equals_one_device(dev, engine):
    """``run_lattice_gas`` (K=1) and ``run_lattice_gas_k`` (K=3, local m,
    walls) with the lattice over ``space_mesh(devices=["cuda:0"] * 4)``,
    and both on a (2, 2) ``grid_mesh``, equal the one-device run bit for
    bit on the card: every frame field and the final field."""
    from hydrolim_tpu_torch.parallel.spatial import (
        grid_mesh,
        grid_sharding,
        space_mesh,
        space_sharding,
    )
    from hydrolim_tpu_torch.particles.lattice_gas import run_lattice_gas
    from hydrolim_tpu_torch.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu_torch.sweeps.ensemble import broadcast_params

    k1 = ParticleConfig(L=1000, N=500, init="fixed", scale_rates=False,
                        local_kernel_sigma=0.0, periodic=True,
                        site_capacity=1, active_model="bidirectional")
    k3 = ParticleConfig(L=1000, N=750, init="fixed", scale_rates=False,
                        local_kernel_sigma=0.002, periodic=False,
                        site_capacity=3)
    kw = dict(T=0.3, obs_dt=0.1, dt=0.005, seed=1, device=dev, n_tracers=16)
    runs = []
    for cfg, run in ((k1, run_lattice_gas), (k3, run_lattice_gas_k)):
        slots = cfg.K > 1
        if engine == "grid":
            sh = grid_sharding(grid_mesh(2, 2, devices=FOUR), slots=slots)
        elif (engine == "lgk") != slots:
            continue
        else:
            sh = space_sharding(space_mesh(devices=FOUR), slots=slots)
        p = broadcast_params(cfg, beta=np.linspace(0.5, 2.5, 5),
                             rate_diffusion=1.0, rate_active=3.0, device=dev)
        runs.append((run(cfg, p, **kw), run(cfg, p, occ_sharding=sh, **kw)))
    for (fa, oa), (fb, ob) in runs:
        assert torch.equal(oa, ob)
        for name in fa._fields:
            assert torch.equal(getattr(fa, name), getattr(fb, name)), name
