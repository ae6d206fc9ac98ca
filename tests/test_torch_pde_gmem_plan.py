"""Kernel B2's route chooser and its device-memory route, on the CPU.

(a) ``pde_route_plan`` at the drivers' shapes: the cluster route wherever
    a cluster holds the fields (up to 131,072 sites with a global or
    pointwise m, 65,536 with a narrow smoothing), the device-memory route
    past it with its G CTAs a replica, segment, tiles and waves; the full
    smoothing on the device-memory route's FFT stage from the route line
    on (the cluster route refuses it past 65,536); a forced route; a
    reduced
    per-CTA budget that sends a small L to the device-memory route; the
    largest L the card's memory serves and the ValueError past it.  The
    co-resident counts are an H100's (clusters: 132, 66, 30, 15, 7 of 1,
    2, 4, 8, 16 CTAs; the device-memory route's CTAs of 512 threads and
    128 registers: one an SM, 132).
(b) The sums' law on G CTAs: the kernel's reduction (a warp's butterfly
    over 32 sites, trees over groups of 32 chunks and over the groups, over
    16 warps, over G CTAs with C/32 of them a lane past 32) emulated in
    float32 is the one adjacent-pairing tree over the padded lattice, bit
    for bit, at every G up to 256: the cluster route's sum.
(c) The scan's law on G CTAs: the exact solve's tiles and runs are the
    cluster route's at every G, and the CTAs take each tile once.
(d) The circulant's law keeps the mass its float32 taps carry: one banded
    solve of the large-lattice driver's fields, summed from the outermost
    tap inward, moves the mass by the taps' own sum to within 1e-9; summed
    outward from the centre tap (the kernel's law before) it misses by
    4e-9 to 5e-8 a step, field by field: the drift of B2's mass that
    PERF.md records.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.ops.pde_kernel import (
    SCAN_TILES,
    GmemPlan,
    PDEPlan,
    check_gmem_memory,
    cta_layout,
    gmem_call_bytes,
    gmem_launch_plan,
    gmem_layout,
    gmem_max_lattice,
    lattice_pow2,
    padded_taps,
    pde_route_plan,
    tap_law,
)

H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
H100_CTAS = 132
WARPS = 16
BANDED = {"solve": 48}        # the recipe's banded solve (97 padded taps)


# ---------------------------------------------------------------------------
# (a) the route
# ---------------------------------------------------------------------------

# (B, L, m_mode, circulants, route, CTAs a replica, sites a CTA, waves)
SHAPES = [
    (2, 65_536, "pointwise", BANDED, "cluster", 16, 4096, 1),
    (2, 131_072, "global", BANDED, "cluster", 16, 8192, 1),
    (2, 131_072, "pointwise", {}, "cluster", 16, 8192, 1),
    (2, 131_072, "narrow", {"smooth": 48}, "gmem", 64, 2048, 1),
    (2, 262_144, "pointwise", BANDED, "gmem", 64, 4096, 1),
    (2, 262_144, "global", BANDED, "gmem", 64, 4096, 1),
    (2, 262_144, "narrow", {"smooth": 33}, "gmem", 64, 4096, 1),
    (1, 262_144, "pointwise", {}, "gmem", 128, 2048, 1),
    (2, 1_048_576, "pointwise", BANDED, "gmem", 64, 16_384, 1),
    (2, 4_194_304, "pointwise", BANDED, "gmem", 64, 65_536, 1),
    (33, 262_144, "global", BANDED, "gmem", 4, 65_536, 1),
    (300, 262_144, "global", {}, "gmem", 1, 262_144, 3),
]


@pytest.mark.parametrize("B,L,m_mode,radii,route,G,seg,waves", SHAPES)
def test_route_at_the_drivers_shapes(B, L, m_mode, radii, route, G, seg,
                                     waves):
    """The cluster route where a cluster fits, else the device-memory
    route with the largest G that holds every replica at once (at least
    one CTA a replica); its segments cover the padded lattice, its scan
    and circulant laws are the cluster route's."""
    plan = pde_route_plan(B, L, 64, m_mode, radii, H100, H100_CTAS)
    assert (plan.route, plan.ctas, plan.seg, plan.waves) == (route, G, seg,
                                                             waves)
    assert plan.seg * plan.ctas == lattice_pow2(L)
    assert plan.tseg * plan.ctas >= 64
    if route == "cluster":
        assert isinstance(plan, PDEPlan)
        return
    assert isinstance(plan, GmemPlan)
    assert plan.per_launch * G <= H100_CTAS and plan.per_launch >= 1
    assert plan.waves == -(-B // plan.per_launch)
    assert plan.tiles * 32 * plan.run >= L and plan.tiles <= SCAN_TILES
    assert 32 <= plan.tile <= plan.seg and plan.smem <= 232_448
    for name, c in (("smooth", plan.smooth), ("solve", plan.solve)):
        if name in radii:
            assert (c.ns, c.length) == tap_law(L, radii[name])
            assert c.direct                  # one pass over its taps


def test_forced_routes_and_sizes():
    """``route='gmem'`` and ``ctas=G`` force the device-memory route where
    a cluster fits too (the card's bitwise comparison); ``route='cluster'``
    past a cluster raises the cluster route's ValueError."""
    for L in (65_536, 131_072):
        p = pde_route_plan(2, L, 64, "pointwise", BANDED, H100, H100_CTAS,
                           route="gmem")
        assert p.route == "gmem" and p.ctas == 64
        for G in (1, 16, 32, 128):
            q = pde_route_plan(1, L, 64, "pointwise", BANDED, H100,
                               H100_CTAS, route="gmem", ctas=G)
            assert (q.route, q.ctas, q.seg) == ("gmem", G,
                                                lattice_pow2(L) // G)
        assert pde_route_plan(2, L, 64, "pointwise", BANDED, H100,
                              H100_CTAS).route == "cluster"
    with pytest.raises(ValueError, match="fit no cluster"):
        pde_route_plan(2, 262_144, 64, "pointwise", BANDED, H100, H100_CTAS,
                       route="cluster")
    with pytest.raises(ValueError, match="unknown route"):
        pde_route_plan(2, 1000, 64, "pointwise", {}, H100, H100_CTAS,
                       route="xla")
    with pytest.raises(ValueError, match="fewer than the 256"):
        gmem_launch_plan(1, 262_144, 64, "pointwise", BANDED, H100_CTAS,
                         ctas=256)


def test_full_smoothing_past_a_cluster_is_refused():
    """The full circulant (radius L//2) fits a cluster up to 65,536 sites
    (``route='cluster'`` forces it there, though the route line sends the
    call to the FFT stage); past that the cluster route refuses it (its
    ValueError names 65,536), and the chooser takes the device-memory
    route, whose full smoothing is the FFT stage (no circulant staged)."""
    lay = gmem_layout(262_144, 64, 64, "smooth", {"smooth": 131_072})
    assert lay is not None and lay.fft is not None
    assert lay.smooth.taps == 0 and lay.wf == 0
    assert pde_route_plan(1, 65_536, 64, "smooth", {"smooth": 32_768}, H100,
                          H100_CTAS, route="cluster").route == "cluster"
    assert pde_route_plan(1, 65_536, 64, "smooth", {"smooth": 32_768}, H100,
                          H100_CTAS).route == "gmem"
    with pytest.raises(ValueError, match="largest L .* is 65536"):
        pde_route_plan(1, 131_072, 64, "smooth", {"smooth": 65_536}, H100,
                       H100_CTAS, route="cluster")
    plan = pde_route_plan(1, 131_072, 64, "smooth", {"smooth": 65_536},
                          H100, H100_CTAS)
    assert (plan.route, plan.ctas, plan.fft.n) == ("gmem", 128, 131_072)


@pytest.mark.parametrize("L,m_mode,radii", [
    (1000, "pointwise", BANDED), (1000, "global", {}),
    (4096, "narrow", {"smooth": 32}), (999, "pointwise", {})])
def test_reduced_budget_sends_a_small_lattice_to_device_memory(L, m_mode,
                                                               radii):
    """Under a per-CTA budget that no cluster's fields fit, the chooser
    takes the device-memory route at L = 1000-4096, its CTAs within the
    budget; at the card's budget the same call takes a cluster."""
    budget = 3000
    assert all(cta_layout(L, 64, C, m_mode, radii, budget) is None
               for C in H100)
    plan = pde_route_plan(4, L, 64, m_mode, radii, H100, H100_CTAS,
                          smem_limit=budget)
    assert plan.route == "gmem" and plan.smem <= budget
    assert plan.ctas == min(32, lattice_pow2(L) // 32)
    assert pde_route_plan(4, L, 64, m_mode, radii, H100,
                          H100_CTAS).route == "cluster"


def test_largest_lattice_from_the_cards_memory():
    """The largest L the device-memory route serves grows with the free
    memory and shrinks with B; a call one site past it needs more bytes
    than are free, and the wrapper's check refuses it naming the
    limit."""
    def plan_of(B):
        return lambda L: gmem_launch_plan(B, L, 64, "pointwise", BANDED,
                                          H100_CTAS)
    free = 2 << 30
    tops = {B: gmem_max_lattice(plan_of(B), B, 64, 20, "pointwise", 8,
                                1500, free) for B in (1, 2, 8)}
    assert tops[1] > tops[2] > tops[8] > 4_194_304, tops
    top = tops[2]
    need = gmem_call_bytes(plan_of(2)(top), 2, top, 64, 20, "pointwise", 8,
                           1500)
    past = gmem_call_bytes(plan_of(2)(top + 1), 2, top + 1, 64, 20,
                           "pointwise", 8, 1500)
    assert need <= free < past
    assert gmem_max_lattice(plan_of(2), 2, 64, 20, "pointwise", 8, 1500,
                            2 * free) > top
    kw = dict(B=2, n_t=64, window=20, m_mode="pointwise", circulants=BANDED,
              kmax_rec=8, k_steps=1500, coresident_ctas=H100_CTAS)
    check_gmem_memory(plan_of(2)(top), free, L=top, **kw)
    with pytest.raises(ValueError, match=f"L={top + 1} at B=2 needs {past} "
                       f"B .* the largest L this configuration serves "
                       f"with them is {top}"):
        check_gmem_memory(plan_of(2)(top + 1), free, L=top + 1, **kw)


# ---------------------------------------------------------------------------
# (b) the sums on G CTAs
# ---------------------------------------------------------------------------

def _butterfly(v):
    """The kernel's warp_tree on (..., 32) float32 lanes."""
    lane = np.arange(32)
    for o in (1, 2, 4, 8, 16):
        v = (v + v[..., lane ^ o]).astype(np.float32)
    return v[..., 0]


def _pairs(v):
    """An adjacent-pairing tree over a power-of-two count of values."""
    v = np.asarray(v, np.float32)
    while v.shape[0] > 1:
        v = (v[0::2] + v[1::2]).astype(np.float32)
    return v[0]


def _warp_total(s, w, k, nch):
    """warp_sums: the warp's k chunks in groups of ≤ 32 (a chunk a lane,
    the group's butterfly), the groups paired as one tree (the kernel's
    stack of pending left halves)."""
    kg = min(k, 32)
    groups = []
    for gi in range(k // kg):
        lanes = np.zeros(32, np.float32)
        for i in range(kg):
            c = w * k + gi * kg + i
            if c < nch:
                lanes[i] = _butterfly(s[32 * c:32 * c + 32])
        groups.append(_butterfly(lanes) if kg > 1 else lanes[0])
    stack, total = [], None
    for gi, t in enumerate(groups):          # the kernel's binary counter
        z = gi
        while z & 1:
            t = np.float32(stack.pop() + t)
            z >>= 1
        stack.append(t)
        total = t
    return total


def _kernel_sum(x, L, G):
    """The kernel's sum of the float32 per-site values x (L,) on G CTAs."""
    Lp = lattice_pow2(L)
    seg = Lp // G
    xp = np.zeros(Lp, np.float32)
    xp[:L] = x
    ctas = []
    for r in range(G):
        s = xp[r * seg:(r + 1) * seg]
        nch = max(1, seg // 32)
        k = nch // WARPS if nch > WARPS else 1
        warps = np.zeros(32, np.float32)
        for w in range(WARPS):
            if w * k < nch:
                warps[w] = _warp_total(s, w, k, nch)
        ctas.append(_butterfly(warps))
    per = max(1, G // 32)                   # CTAs a lane adds, as a tree
    lanes = np.zeros(32, np.float32)
    for lane in range(32):
        if lane * per < G:
            lanes[lane] = _pairs(ctas[lane * per:(lane + 1) * per])
    return _butterfly(lanes) if G > 1 else ctas[0]


def _tree(x, L):
    v = np.zeros(lattice_pow2(L), np.float32)
    v[:L] = x
    return _pairs(v)


@pytest.mark.parametrize("L", [1000, 65_536, 131_072, 262_144])
def test_sums_are_one_tree_at_every_cta_count(L):
    rng = np.random.default_rng(L)
    x = rng.uniform(0.0, 2.0 / L, L).astype(np.float32)
    want = _tree(x, L)
    sizes = [G for G in (1, 2, 4, 16, 32, 64, 128, 256)
             if gmem_layout(L, 64, G, "global", {}) is not None]
    assert len(sizes) >= 4
    for G in sizes:
        assert _kernel_sum(x, L, G) == want, G


# ---------------------------------------------------------------------------
# (c) the scan on G CTAs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1000, 65_536, 131_072, 262_144])
def test_scan_tiles_are_the_clusters_at_every_cta_count(L):
    """Every G runs the cluster route's scan (its tiles and runs, a
    function of L), and the CTAs' tiles (r·ntl + t for the block's 16
    half-warps, ntl = tiles / G, or tile r past `tiles` CTAs) take each
    tile exactly once."""
    Lp = lattice_pow2(L)
    lay = cta_layout(L, 64, 16 if L > 8192 else 1, "pointwise", {})
    for G in (1, 2, 8, 16, 32, 64, 256):
        plan = gmem_layout(L, 64, G, "pointwise", {})
        if plan is None:
            continue
        if lay is not None:
            assert (plan.tiles, plan.run) == (lay.tiles, lay.run)
        tile = max(32, Lp // SCAN_TILES)
        assert (plan.tiles, plan.run) == (Lp // tile, tile // 32)
        ntl = plan.tiles // G if plan.tiles >= G else 1
        taken = [r * ntl + t for r in range(G) for t in range(16)
                 if t < ntl and r * ntl + t < plan.tiles]
        assert sorted(taken) == list(range(plan.tiles)), G


# ---------------------------------------------------------------------------
# (d) the circulant's law and the mass
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    return (np.float64(a) * b.astype(np.float64) + c).astype(np.float32)


def _chain(x, half, inward):
    """One field through a circulant chain of the half taps, inward (the
    kernel's law: the outermost tap first, the centre last) or outward
    (from the centre tap)."""
    R = half.shape[0] - 1
    pair = lambda d: (np.roll(x, d) + np.roll(x, -d)).astype(np.float32)
    if inward:
        acc = np.zeros_like(x)
        for d in range(R, 0, -1):
            acc = _fma(half[d], pair(d), acc)
        return _fma(half[0], x, acc)
    acc = (half[0] * x).astype(np.float32)
    for d in range(1, R + 1):
        acc = _fma(half[d], pair(d), acc)
    return acc


def test_circulant_law_keeps_the_taps_mass():
    """At the large-lattice recipe (L = 8192, its 67 taps) on the driver's
    initial fields (1.2·ρ₀ and 0.8·ρ₀): the kernel's chain moves each
    field's mass by the float32 taps' own sum − 1 (+1.06e-8) to within
    1e-9; the outward chain misses it by 4e-9 on one field and by more
    than 4e-8 on the other."""
    from hydrolim_tpu_torch.experiments.large_lattice import pde_grid, pde_rho0
    from hydrolim_tpu_torch.ops.diffusion import banded_kernel

    L = 8192
    config, gamma, _ = pde_grid(L, small=False)
    w = np.asarray(banded_kernel(config.dx, config.dt, gamma), np.float32)
    half = padded_taps(torch.tensor(w[(len(w) - 1) // 2:]),
                       *tap_law(L, (len(w) - 1) // 2)).numpy()
    excess = float(half[0] + 2 * half[1:].astype(np.float64).sum() - 1.0)
    assert 5e-9 < excess < 2e-8, excess
    rho0 = pde_rho0(L, 0, 0)
    miss = []
    for c, i in ((1.2, 0), (0.8, 1)):
        x = np.float32(c * rho0[i])
        mass = x.astype(np.float64).sum()
        moved = {inward: _chain(x, half, inward).astype(np.float64).sum()
                 / mass - 1.0 for inward in (True, False)}
        assert abs(moved[True] - excess) < 1e-9, (c, moved)
        miss.append(abs(moved[False] - excess))
    assert min(miss) > 2e-9 and max(miss) > 4e-8, miss
