"""Kernel B3/B4's cluster decomposition and launch plan, on the CPU.

The kernel runs a replica on a cluster of C CTAs: CTA r steps the sites of
its segment from a window of pre-step slots that reaches ``halo_width``
sites past each side (none past a wall), recomputing the events and the
admission of the halo's inner sites itself.  Here that decomposition is
emulated with the plain version's own step: each step, every CTA's window
is cut from the lattice (``cta_window``, ``segments``), stepped as a lattice
of its own at the same injected bits (walls at the window's edges, the
band's rows restricted to the window, global m from the whole lattice),
and only its segment is kept.  The result must EQUAL the plain version's
over the whole lattice; with a halo one site short it must not.  Then the
plan: which C it picks, and that what it picks fits.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    MAX_CLUSTER,
    MAX_SMEM,
    SITES_PER_CTA,
    SLOT_HALO,
    SmoothingBand,
    band_rotation,
    band_weights,
    cluster_fits,
    cta_smem_bytes,
    cta_threads,
    cta_window,
    exclusion_launch_plan,
    exclusion_multi_step_plain,
    exclusion_step_plain,
    halo_width,
    segments,
    smooth_with_band,
    smoothing_band,
)
from test_torch_exclusion_bands import emulate_exchange


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test processes on the host's cores, and torch's thread pool in each
    would only contend (a test of thousands of tiny ops then runs tens of
    times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band(K, L, sigma, periodic, bent=False):
    if sigma == 0:
        return None
    cfg = ParticleConfig(L=L, N=(K * L) // 2, init="fixed",
                         scale_rates=False, local_kernel_sigma=sigma,
                         periodic=periodic, site_capacity=K)
    idx, w = band_weights(cfg)
    if bent:                    # one interior row changed: read from the band
        w = w.copy()
        w[L // 3] *= 1.5
    return smoothing_band(idx, w, device="cpu")


def _inputs(B, K, L, k, seed):
    """Front-packed slots (each site a random count of particles, random
    spins, unique payloads), the scalars and k steps of injected bits."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, K + 1, (B, 1, L))
    sign = rng.choice([-1, 1], (B, K, L))
    ids = np.arange(1, B * K * L + 1).reshape(B, K, L)
    slots = np.where(np.arange(K)[None, :, None] < n, sign * ids, 0)
    scal = np.stack([np.linspace(0.0, 3.0, B), np.full(B, 1.0),
                     np.full(B, 3.0)], 1)
    noise = rng.integers(0, 2 ** 32, (B, k, 2, K, L), dtype=np.uint64)
    return (torch.tensor(slots, dtype=torch.int32),
            torch.tensor(scal, dtype=torch.float32),
            torch.tensor(noise.astype(np.uint32).view(np.int32)))


def _window_band(band, sites, L, periodic):
    """The band's rows of the window's sites, their inputs as window
    indices; an input outside the window gets weight 0 (only the outer
    halo sites have such rows, and their m must not matter)."""
    idx = band.idx.numpy()[sites].astype(np.int64) - sites[0]
    if periodic:
        idx %= L
    w = band.w.numpy()[sites].copy()
    out = (idx < 0) | (idx >= len(sites))
    w[out], idx[out] = 0.0, 0
    return SmoothingBand(torch.tensor(idx, dtype=torch.int32),
                         torch.tensor(w), band.radius, 0, 0)


def emulate(scal, slots, band, noise, *, C, halo, dt, periodic,
            bidirectional):
    """The cluster decomposition of ``exclusion_multi_step_plain``."""
    B, K, L = slots.shape
    for s in range(noise.shape[1]):
        bits = noise[:, s].to(torch.int64) & 0xFFFFFFFF
        m = None
        if band is None:    # global m from the whole lattice
            nz = slots != 0
            sgn = (slots > 0).float() - (slots < 0).float()
            m = (sgn.sum(1).sum(-1) / nz.float().sum(1).sum(-1)
                 .clamp(min=1.0)).reshape(B, 1, 1)
        new = torch.empty_like(slots)
        for r in range(C):
            win = cta_window(L, C, r, halo, periodic)
            sites = win.sites(L)
            got = exclusion_step_plain(
                slots[:, :, sites], scal,
                None if band is None else _window_band(band, sites, L,
                                                       periodic),
                bits[:, 0][:, :, sites], bits[:, 1][:, :, sites], dt=dt,
                periodic=periodic and C == 1, bidirectional=bidirectional,
                m=m)
            new[:, :, win.lo:win.hi] = got[:, :, win.left:win.left + win.hi
                                           - win.lo]
        slots = new
    return slots


# (K, L, σ, periodic, bidirectional, bent band)
CASES = {
    "global m, walls": (3, 64, 0.0, False, False, False),
    "global m, torus, K=1": (1, 67, 0.0, True, True, False),
    "global m, torus, K=8": (8, 1000, 0.0, True, False, False),
    "narrow band, walls": (3, 64, 0.008, False, False, False),
    "narrow band, walls, K=1": (1, 1000, 0.002, False, True, False),
    "periodic band that wraps": (3, 1000, 0.002, True, False, False),
    "periodic band that wraps, K=8": (8, 67, 0.01, True, True, False),
    "bent band": (3, 1000, 0.005, False, False, True),
    "full-torus band": (3, 64, 0.1, True, False, False),
}
B, STEPS, DT = 2, 40, 0.02


@pytest.mark.parametrize("C", range(1, MAX_CLUSTER + 1))
@pytest.mark.parametrize("case", list(CASES))
def test_cluster_decomposition_equals_plain(case, C):
    """40 steps at injected bits: the segments stepped from their windows
    EQUAL the plain version.  A C whose segments are narrower than two
    halos takes the exchanged count field instead where it has a band and
    that fits (its decomposition, ``emulate_exchange``, EQUALS the plain
    version too), and is refused by the plan otherwise."""
    K, L, sigma, periodic, bidi, bent = CASES[case]
    band = _band(K, L, sigma, periodic, bent)
    W = 0 if band is None else band.idx.shape[1]
    halo = halo_width(band, periodic)
    seats = {c: 64 for c in range(1, MAX_CLUSTER + 1)}
    exchange = False
    if not cluster_fits(K, L, W, C, halo):
        assert C > 1 and L // C < 2 * halo
        exchange = bool(W) and cluster_fits(K, L, W, C, SLOT_HALO, True)
        if not exchange:
            with pytest.raises(ValueError, match="no cluster size"):
                exclusion_launch_plan(B, K, L, W, halo, seats, cluster=C)
            return
    plan = exclusion_launch_plan(B, K, L, W, halo, seats, cluster=C)
    assert (plan.cluster, plan.exchange) == (C, exchange)
    assert plan.halo == (SLOT_HALO if exchange else halo if C > 1 else 0)
    slots, scal, noise = _inputs(B, K, L, STEPS, seed=L + K + C)
    kw = dict(dt=DT, periodic=periodic, bidirectional=bidi)
    want = exclusion_multi_step_plain(scal, None, slots, band, k_steps=STEPS,
                                      noise=noise, **kw)
    if exchange:
        got = emulate_exchange(scal, slots, band, noise, C=C, **kw)
    else:
        got = emulate(scal, slots, band, noise, C=C, halo=halo, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(want, slots)


@pytest.mark.parametrize("K,L,periodic,C", [(1, 64, False, 4),
                                             (3, 67, True, 3)])
def test_a_halo_one_site_short_differs(K, L, periodic, C):
    """The same emulation with ``halo_width`` − 1 sites of halo reads a
    wall where a neighbour stands, and the slots drift from the plain
    version's.  The drift needs a right-mover two sites out of a segment
    to compete with the segment's left-mover for the site between, so the
    rates here are high (p_dif = 0.1) and the run long."""
    B, k = 8, 100
    slots, scal, noise = _inputs(B, K, L, k, seed=L + K + C)
    kw = dict(dt=0.1, periodic=periodic, bidirectional=True)
    want = exclusion_multi_step_plain(scal, None, slots, None, k_steps=k,
                                      noise=noise, **kw)
    halo = halo_width(None, periodic)
    assert torch.equal(
        emulate(scal, slots, None, noise, C=C, halo=halo, **kw), want)
    assert not torch.equal(
        emulate(scal, slots, None, noise, C=C, halo=halo - 1, **kw), want)


def test_halo_width_and_windows():
    """3 sites for global m, reach + 2 for a band (its wrap distance on a
    torus); windows stop at the walls; segments tile the lattice."""
    assert halo_width(None, True) == halo_width(None, False) == 3
    band = _band(3, 1000, 0.002, False)
    assert (band.reach, halo_width(band, False)) == (8, 10)
    wrap = _band(3, 1000, 0.002, True)
    assert wrap.reach > wrap.reach_wrap == wrap.radius
    assert halo_width(wrap, True) == wrap.radius + 2
    for L, C in ((1000, 3), (67, 8), (8192, 5)):
        seg = segments(L, C)
        assert seg[0][0] == 0 and seg[-1][1] == L
        assert all(a[1] == b[0] for a, b in zip(seg, seg[1:]))
        assert {b - a for a, b in seg} <= {L // C, -(-L // C)}
    w0, w2 = cta_window(1000, 3, 0, 10, False), cta_window(1000, 3, 2, 10,
                                                           False)
    assert (w0.left, w0.right, w0.start) == (0, 10, 0)
    assert (w2.left, w2.right) == (10, 0) and w2.sites(1000)[-1] == 999
    t = cta_window(1000, 3, 0, 10, True)
    assert t.sites(1000)[0] == 990 and t.sites(1000)[10] == 0


# clusters the card seats with a CTA per SM, per C: as an H100's GPCs give
# them (clusters of 4 seat only 32), and a table where every C seats 40
SEATS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
EVEN = {C: 40 for C in range(1, MAX_CLUSTER + 1)}


@pytest.mark.parametrize("seats", [SEATS, EVEN], ids=["h100", "even"])
@pytest.mark.parametrize("B", [1, 16, 33, 132, 264])
def test_plan_seats_every_cluster(B, seats):
    """The plan's C seats all B clusters at once where any C does, fits
    shared memory with segments two halos wide, and is the smallest that
    brings a CTA to ``SITES_PER_CTA`` sites: C=4 at L=1000, or C=3 at
    B=33 where clusters of 4 seat only 32; past what one wave holds, the
    fewest waves (C=1 from B=132 on)."""
    K, L, W, halo = 3, 1000, 17, 10
    plan = exclusion_launch_plan(B, K, L, W, halo, seats)
    C = plan.cluster
    assert plan.waves == min(-(-B // n) for n in seats.values())
    assert -(-B // seats[C]) == plan.waves
    assert plan.smem == cta_smem_bytes(K, L, W, C, plan.halo, False)
    assert plan.smem <= MAX_SMEM and L // C >= 2 * halo
    assert plan.threads == cta_threads(L, C) and plan.threads % 32 == 0
    want = {1: 4, 16: 4, 33: 3 if seats is SEATS else 4,
            132: 1 if seats is SEATS else 4, 264: 1 if seats is SEATS else 4}
    assert C == want[B]


@pytest.mark.parametrize("L,B,want", [(250, 33, 1), (4000, 33, 3),
                                      (8192, 33, 3), (1000, 200, 1)])
def test_plan_rule(L, B, want):
    """L=250 fits one CTA of ≤ 256 sites: C=1.  L=4000 and 8192 have no C
    within 256 sites that seats all 33 clusters: the fewest sites per CTA
    among those that do (C=3; clusters of 4 seat only 32).  B=200 needs
    two waves at C=1 and more at any other: C=1."""
    plan = exclusion_launch_plan(B, 3, L, 17, 10, SEATS)
    assert plan.cluster == want
    assert plan.waves == -(-B // SEATS[want])
    assert -(-L // want) <= SITES_PER_CTA or all(
        -(-B // SEATS[C]) > plan.waves for C in SEATS
        if -(-L // C) <= SITES_PER_CTA)


def test_plan_past_one_block():
    """L=8192 at K=3 does not fit one block: the plan takes C ≥ 2, and at
    K=8 it runs to about 8 × 1,900 sites; past that nothing fits."""
    plan = exclusion_launch_plan(33, 3, 8192, 17, 10, SEATS)
    assert plan.cluster >= 2
    assert not cluster_fits(3, 8192, 17, 1, 10)
    assert cluster_fits(8, 15_000, 17, 8, 10)
    assert not any(cluster_fits(8, 20_000, 17, C, 10)
                   for C in range(1, MAX_CLUSTER + 1))
    with pytest.raises(ValueError, match="no cluster size"):
        exclusion_launch_plan(1, 8, 20_000, 17, 10, SEATS)


def test_plan_wide_band_takes_one_cta():
    """A periodic band that spans most of the torus (σ=0.05 at L=1000: 533
    taps, reach 266) has a halo wider than half of any segment, so no
    cluster carries it in its halo: the plan takes C > 1 on the exchanged
    count field, with slot halos of ``SLOT_HALO`` sites."""
    band = _band(3, 1000, 0.05, True)
    W = band.idx.shape[1]
    assert (W, band.reach_wrap) == (533, 266)
    halo = halo_width(band, True)
    plan = exclusion_launch_plan(16, 3, 1000, W, halo, SEATS)
    assert plan.cluster > 1 and plan.exchange
    assert plan.halo == SLOT_HALO
    assert plan.smem == cta_smem_bytes(3, 1000, W, plan.cluster, SLOT_HALO,
                                       False, True)
    assert not any(cluster_fits(3, 1000, W, C, halo)
                   for C in range(2, MAX_CLUSTER + 1))


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2] > 0]
                         + ["wide periodic band", "wide reflect band"])
def test_band_rows_by_rotation_equal_the_band(case):
    """Every row of the periodic and reflect bands (and the bent one) is a
    rotation (``band_rotation``): its inputs x − radius + ((t + rot) mod W),
    wrapped on a torus and clamped at a wall where the weight is 0, summed
    in tap order with the row's weights, give the band's smoothing bit for
    bit.  A row of no such form is marked −1."""
    K, L, sigma, periodic, _, bent = CASES.get(
        case, (3, 1000, 0.05, True, False, False) if "periodic" in case
        else (3, 1000, 0.02, False, False, False))
    band = _band(K, L, sigma, periodic, bent)
    rot = torch.from_numpy(band_rotation(band.idx.numpy(), band.w.numpy(),
                                         periodic)).long()
    assert bool((rot != -1).all())
    if not periodic:
        assert bool((rot >= 0).all())
    rot = torch.where(rot <= -2, -2 - rot, rot)
    W = band.idx.shape[1]
    t = torch.arange(W)
    src = torch.arange(L)[:, None] - band.radius + (t + rot[:, None]) % W
    src = src % L if periodic else src.clamp(0, L - 1)
    x = torch.tensor(np.random.default_rng(L).integers(-K, K + 1, (2, L)),
                     dtype=torch.float32)
    acc = torch.zeros_like(x)
    for j in range(W):
        acc = acc + band.w[:, j] * x[:, src[:, j]]
    assert torch.equal(acc, smooth_with_band(x, band))
    idx, w = band.idx.numpy().copy(), band.w.numpy()
    idx[L // 2, :] = idx[L // 2, ::-1]        # inputs in descending order
    assert band_rotation(idx, w)[L // 2] == -1
