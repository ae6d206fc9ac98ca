"""Kernel B2's launch plan on a cluster of CTAs, and the laws that make its
results the same at every cluster size, on the CPU.

(a) ``pde_launch_plan`` at the drivers' shapes: L = 1000 (B = 33, the main
    path; B = 5, the σ sweep; B = 64, the phase diagram), L = 8192 (B = 4,
    the banded bench row), 16,384 and 65,536 (B = 2, the large lattice's
    recipe): the cluster size, each CTA's sites and tracers, its shared
    memory within ``SMEM_LIMIT``, the largest L served, and the
    ``ValueError`` past it, before any launch.  The co-resident clusters
    are an H100's (``cudaOccupancyMaxActiveClusters`` at these layouts,
    NVIDIA H100 80GB HBM3: 132, 66, 30, 15 and 7 clusters of 1, 2, 4, 8,
    16 CTAs).
(b) The sums' law: the kernel's reduction (a warp's butterfly over 32
    sites, a tree over the warp's chunks, over 16 warps, over the C CTAs)
    emulated in float32 for every C is the one adjacent-pairing tree over
    the padded lattice, bit for bit.
(c) The circulant's law (each chain from its outermost tap inward, the
    centre tap last): the staged passes and segments of every C and pass
    length, emulated in float32, equal one pass over the whole lattice bit
    for bit, and the dense product to float32 roundoff.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.ops.pde_kernel import (
    CLUSTER_SIZES,
    KBLOCK,
    SMEM_LIMIT,
    SmoothOperands,
    cta_layout,
    lattice_pow2,
    padded_taps,
    pde_launch_plan,
    pde_max_lattice,
    tap_law,
)

H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
WARPS = 16        # a CTA's warps (512 threads)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

# (B, L, n_t, m_mode, circulants (name → radius), cluster, sites per CTA):
# the measured table (``profile_pde_kernel.py --mode cluster``, PERF.md §6)
SHAPES = [
    (33, 1000, 1000, "global", {}, 1, 1024),
    (5, 1000, 1000, "pointwise", {}, 1, 1024),
    (5, 1000, 1000, "narrow", {"smooth": 32}, 1, 1024),
    (5, 1000, 1000, "smooth", {"smooth": 500}, 4, 256),
    (64, 1000, 64, "smooth", {"smooth": 500}, 2, 512),   # C=4: 3 waves
    (4, 8192, 64, "pointwise", {"solve": 48}, 8, 1024),
    (2, 16_384, 64, "pointwise", {"solve": 48}, 8, 2048),
    (2, 16_384, 64, "narrow", {"smooth": 48}, 8, 2048),
    (1, 16_384, 64, "smooth", {"smooth": 8192}, 16, 1024),
    (2, 65_536, 64, "pointwise", {"solve": 48}, 16, 4096),
    (1, 65_536, 64, "smooth", {"smooth": 32768}, 16, 4096),
]


@pytest.mark.parametrize("B,L,n_t,m_mode,radii,C,seg", SHAPES)
def test_plan_at_the_drivers_shapes(B, L, n_t, m_mode, radii, C, seg):
    """The plan's cluster size and segment; its layout fits shared memory,
    covers the padded lattice with no empty CTA, and holds the exact
    solve's scan tiles and the tracers."""
    laws = {k: tap_law(L, r) for k, r in radii.items()}
    plan = pde_launch_plan(B, L, n_t, m_mode, radii, H100)
    assert (plan.cluster, plan.seg) == (C, seg)
    assert plan.smem <= SMEM_LIMIT
    assert plan.seg * C == lattice_pow2(L) and (C - 1) * plan.seg < L
    assert plan.tiles % C == 0 and plan.tiles * 32 * plan.run >= L
    assert plan.tseg * C >= n_t
    assert plan.waves == -(-B // H100[C])
    for name, c in (("smooth", plan.smooth), ("solve", plan.solve)):
        if name in laws:
            assert (c.ns, c.length) == laws[name]
            assert c.tb % KBLOCK == 0 and c.ns * c.length >= radii[name]
    # a forced cluster size takes its own layout
    for C2 in CLUSTER_SIZES:
        lay = cta_layout(L, n_t, C2, m_mode, radii)
        if lay is not None:
            forced = pde_launch_plan(B, L, n_t, m_mode, radii, H100,
                                     cluster=C2)
            assert forced.cluster == C2 and forced.smem == lay.smem


def test_largest_lattice_and_the_refusal():
    """The largest L served is a power of two that fits at C = 16; one
    site more is refused with the limit named; without C = 16 on the card
    the limit halves."""
    for m_mode, radii, want in (("global", {}, 131_072),
                                ("pointwise", {"solve": 48}, 131_072),
                                ("narrow", {"smooth": 48}, 65_536),
                                ("smooth", {}, 65_536)):
        top = pde_max_lattice(64, m_mode, radii, H100)
        assert top == want, (m_mode, top)
        at = dict(radii, smooth=top // 2) if m_mode == "smooth" else radii
        pde_launch_plan(2, top, 64, m_mode, at, H100)
        with pytest.raises(ValueError, match=f"more than the {SMEM_LIMIT} B"
                           f".*largest L .* is {top}"):
            pde_launch_plan(2, top + 2, 64, m_mode,
                            dict(at, smooth=top // 2 + 1)
                            if m_mode == "smooth" else radii, H100)
        no16 = {C: n for C, n in H100.items() if C < 16}
        assert pde_max_lattice(64, m_mode, radii, no16) == top // 2


def test_one_cta_past_its_shared_memory_is_refused():
    """C = 1 holds the parent kernel's range (~11,600 sites with a local
    m): 8192 fits one CTA, 16,384 needs a cluster."""
    assert cta_layout(8192, 64, 1, "pointwise", {}) is not None
    assert cta_layout(16_384, 64, 1, "pointwise", {}) is None
    assert cta_layout(16_384, 64, 2, "pointwise", {}) is not None


# ---------------------------------------------------------------------------
# (b) the sums
# ---------------------------------------------------------------------------

def _butterfly(v):
    """The kernel's warp_tree on (..., 32) float32 lanes: lane l adds lane
    l ^ o for o = 1, 2, 4, 8, 16."""
    lane = np.arange(32)
    for o in (1, 2, 4, 8, 16):
        v = (v + v[..., lane ^ o]).astype(np.float32)
    return v[..., 0]


def _kernel_sum(x, L, C):
    """The kernel's sum of the float32 per-site values x (L,) on C CTAs."""
    Lp = lattice_pow2(L)
    seg = Lp // C
    xp = np.zeros(Lp, np.float32)
    xp[:L] = x
    ctas = []
    for r in range(C):
        s = xp[r * seg:(r + 1) * seg]
        nch = max(1, seg // 32)
        k = nch // WARPS if nch > WARPS else 1
        warps = np.zeros(32, np.float32)
        for w in range(WARPS):
            if w * k >= nch:
                continue
            lanes = np.zeros(32, np.float32)
            for i in range(k):
                c = w * k + i
                lanes[i] = _butterfly(s[32 * c:32 * c + 32])
            warps[w] = _butterfly(lanes) if k > 1 else lanes[0]
        ctas.append(_butterfly(warps))
    return _butterfly(np.array(ctas + [0.0] * (32 - C), np.float32))


def _tree(x, L):
    """The adjacent-pairing tree over the padded lattice."""
    v = np.zeros(lattice_pow2(L), np.float32)
    v[:L] = x
    while v.shape[0] > 1:
        v = (v[0::2] + v[1::2]).astype(np.float32)
    return v[0]


@pytest.mark.parametrize("L", [1000, 999, 8192, 16_384, 65_536])
def test_sums_are_one_tree_at_every_cluster_size(L):
    rng = np.random.default_rng(L)
    x = rng.uniform(0.0, 2.0 / L, L).astype(np.float32)
    want = _tree(x, L)
    sizes = [C for C in CLUSTER_SIZES
             if cta_layout(L, 64, C, "global", {}) is not None]
    assert len(sizes) >= 2
    for C in sizes:
        assert _kernel_sum(x, L, C) == want, C
    assert abs(float(want) - float(x.astype(np.float64).sum())) < 1e-6


# ---------------------------------------------------------------------------
# (c) the circulant
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """float32 fused multiply-add (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _circulant_staged(x, half, L, C, tb):
    """The kernel's circulant on one field: C segments, passes of ``tb``
    taps from the outermost inward over the law's slices, each site's
    slice one fused chain from its outermost tap inward (slice 0 ending
    with the centre tap) from its staged window, the slices added from the
    last to the first."""
    ns, length = tap_law(L, half.shape[0] - 1)
    w = padded_taps(torch.tensor(half), ns, length).numpy()
    R = ns * length
    seg = lattice_pow2(L) // C
    out = np.zeros(L, np.float32)
    for r in range(C):
        lo, n = r * seg, max(0, min(L - r * seg, seg))
        sites = lo + np.arange(n)
        part = np.zeros((ns, n), np.float32)
        E1 = R
        while True:
            E0 = max(0, E1 - tb)
            for sl in range(ns):
                t0, t1 = max(E0, sl * length), min(E1, (sl + 1) * length)
                if t0 >= t1 and not (R == 0 and sl == 0):
                    continue
                acc = (np.zeros(n, np.float32) if t1 == (sl + 1) * length
                       else part[sl])
                for d in range(t1, t0, -1):
                    pair = (x[(sites - d) % L] + x[(sites + d) % L]).astype(
                        np.float32)
                    acc = _fma(np.float32(w[d]), pair, acc)
                if t0 == 0:
                    acc = _fma(np.float32(w[0]), x[sites], acc)
                part[sl] = acc
            E1 = E0
            if E1 <= 0:
                break
        o = part[ns - 1]
        for sl in range(ns - 2, -1, -1):
            o = (o + part[sl]).astype(np.float32)
        out[lo:lo + n] = o
    return out


@pytest.mark.parametrize("L,sigma", [(1000, 0.05), (999, 0.05),
                                     (256, 0.1), (64, 0.02)])
def test_staged_circulant_is_the_law_at_every_c_and_pass(L, sigma):
    """The full circulant (R = L//2) and a narrow band: every C and pass
    length gives the one-pass, one-CTA result bit for bit, and the dense
    float64 product to rtol 1e-5 / atol 1e-9."""
    from hydrolim_tpu_torch.ops.convolve import periodic_gaussian_kernel

    k = periodic_gaussian_kernel(L, 1.0 / L, sigma)
    rng = np.random.default_rng(L)
    x = rng.uniform(0.0, 2.0 / L, L).astype(np.float32)
    for half in (SmoothOperands("smooth", torch.tensor(k)).half_taps.numpy(),
                 rng.uniform(0.1, 1.0, min(L // 2, 20) + 1).astype(
                     np.float32)):
        R = half.shape[0] - 1
        ns, length = tap_law(L, R)
        want = _circulant_staged(x, half, L, 1, max(KBLOCK, ns * length))
        for C in (2, 4):
            if lattice_pow2(L) // C < 32:
                continue
            for tb in (KBLOCK, 2 * KBLOCK, max(KBLOCK, ns * length)):
                got = _circulant_staged(x, half, L, C, tb)
                np.testing.assert_array_equal(got, want)
        kk = np.zeros(L)
        kk[:R + 1] += half
        kk[L - R:] += half[1:][::-1]
        if L % 2 == 0 and R == L // 2:
            kk[L // 2] = 2 * half[R]     # the halved d = L/2 tap, added once
        i = np.arange(L)
        dense = kk[(i[None, :] - i[:, None]) % L]
        np.testing.assert_allclose(want, x.astype(np.float64) @ dense,
                                   rtol=1e-5, atol=1e-9)
