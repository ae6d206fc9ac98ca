"""The redesigned kernels' arithmetic and launch plans, on the CPU.

Kernels B1 and B2 run only on the card; what decides their results and
their shape is checked here:
(a) B2's scan solve: a torch emulation in the kernel's order and
    precision (a run of sites per thread, a 32-lane shuffle scan, a shuffle
    scan of the warp totals, composed in float64 and stored in f32; forward
    and back sweeps; the periodic correction) against the sequential Thomas
    solve and the float64 dense inverse;
(b) B2's blocked circulant: an emulation of the kernel's work units
    (KBLOCK sites per thread, register windows rotating through their slots
    as the taps are taken inward, the centre tap last, the tap slices
    meeting from the last to the first) against the dense circulant
    product and the JAX package's ``build_conv_matrix``;
(c) B1's launch plan: co-resident clusters at the main path's and the
    headline's shapes, the cluster-size rule, forced state modes, the
    packed state within shared memory, the winding change within its bits,
    and the unpacked fallback.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.ops.diffusion import (
    build_dense_inverse,
    tridiag_factors,
    tridiag_solve,
)
from hydrolim_tpu_torch.ops.pde_kernel import (
    KBLOCK,
    KERNEL_THREADS,
    SmoothOperands,
    padded_taps,
    tap_plan,
)
from hydrolim_tpu_torch.ops.stepper_kernel import (
    MAX_CLUSTER,
    MAX_DWIND,
    ONE_PASS_GROUPS,
    SLOT_BYTES,
    SMEM_LIMIT,
    cta_shape,
    launch_plan,
    max_steps_per_launch,
)

HALF = KERNEL_THREADS // 2      # threads per field in the scan solve


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


# ---------------------------------------------------------------------------
# (a) the scan solve
# ---------------------------------------------------------------------------

def _after(l, e):
    """(la, lb) ∘ (ea, eb) as the kernel composes affine maps (float64)."""
    return l[0] * e[0], l[0] * e[1] + l[1]


def _scan_sweep(coef, val_of, F, L):
    """One sweep of the kernel's scan over (batch, L) in increasing site
    order: v_i = coef_i·v_{i−1} + val_i from v_{−1} = 0, composed in
    float64 and stored in f32, where ``val_of(i_idx, F)`` gives val (float64)
    at the sites i_idx.  Threads own runs of ⌈L/HALF⌉ sites; lanes and
    warps scan in thread order."""
    batch = F.shape[0]
    run = -(-L // HALF)
    t = torch.arange(HALF)
    coef = coef.double()
    A = torch.ones(batch, HALF, dtype=torch.float64)
    Bv = torch.zeros(batch, HALF, dtype=torch.float64)
    for j in range(run):                      # the run, in registers
        i = t * run + j
        ok = i < L
        ic = i.clamp(max=L - 1)
        a_i, v_i = coef[ic], val_of(ic, F)
        A = torch.where(ok, a_i * A, A)
        Bv = torch.where(ok, a_i * Bv + v_i, Bv)
    A, Bv = A.view(batch, HALF // 32, 32), Bv.view(batch, HALF // 32, 32)
    lane = torch.arange(32)
    d = 1
    while d < 32:                             # the warp scan by shuffle
        nA, nB = _after((A, Bv), (torch.roll(A, d, -1),
                                  torch.roll(Bv, d, -1)))
        A = torch.where(lane >= d, nA, A)
        Bv = torch.where(lane >= d, nB, Bv)
        d <<= 1
    tA, tB = A[..., 31], Bv[..., 31]          # the cross-warp level: a
    eA = torch.where(lane >= 1, torch.roll(A, 1, -1), torch.ones_like(A))
    eB = torch.where(lane >= 1, torch.roll(Bv, 1, -1), torch.zeros_like(Bv))
    nwarp = HALF // 32                        # shuffle scan of the totals
    widx = torch.arange(nwarp)
    d = 1
    while d < nwarp:
        nA, nB = _after((tA, tB), (torch.roll(tA, d, -1),
                                   torch.roll(tB, d, -1)))
        tA = torch.where(widx >= d, nA, tA)
        tB = torch.where(widx >= d, nB, tB)
        d <<= 1
    qA = torch.where(widx >= 1, torch.roll(tA, 1, -1), torch.ones_like(tA))
    qB = torch.where(widx >= 1, torch.roll(tB, 1, -1), torch.zeros_like(tB))
    y = _after((eA, eB), (qA[..., None], qB[..., None]))[1].view(batch, HALF)
    out = F.clone()
    for j in range(run):                      # the run again, applied
        i = t * run + j
        ok = i < L
        ic = i.clamp(max=L - 1)
        y = torch.where(ok, coef[ic] * y + val_of(ic, F), y)
        out[:, ic[ok]] = y[:, ok].float()
    return out


def scan_solve(f, rho):
    """Kernel B2's exact solve, emulated: the forward sweep, the back sweep
    (the same scan on the reversed thread order) and, when periodic, the
    Sherman–Morrison correction."""
    inv, cp, alpha, z = f.scan
    L = rho.shape[-1]
    y = _scan_sweep(alpha, lambda i, F: F[:, i].double() * inv[i], rho, L)
    # back: x_i = −c'_i x_{i+1} + y_i; thread t's run reversed is thread
    # HALF−1−t's run in site-reversed coordinates
    run = -(-L // HALF)
    P = HALF * run                            # pad so reversal maps runs
    ypad = torch.zeros(rho.shape[0], P)
    ypad[:, :L] = y
    cpad = torch.zeros(P, dtype=torch.float64)
    cpad[:L] = -cp
    x = _scan_sweep(cpad.flip(0), lambda i, F: F[:, i].double(),
                    ypad.flip(1), P)
    x = x.flip(1)[:, :L]
    if not f.periodic:
        return x
    coef = f.fac * (x[:, :1] + f.v_last * x[:, -1:])
    return x - coef * z.float()


@pytest.mark.parametrize("bc", ["periodic", "neumann"])
@pytest.mark.parametrize("L", [3, 4, 33, 256, 1000, 1023])
def test_scan_solve_matches_thomas_and_dense_inverse(bc, L):
    """The scan solve (float64 maps, f32 fields) against f32 Thomas and the
    dense inverse at c = γ·dt/dx² up to 100: rtol 2e-5, atol 1e-9 of fields
    ~1/L; and on fields ~1 at L=1000 no further from the exact solve than
    Thomas (the f32 scan was 2.4× further, past the card check's spectra
    tolerance)."""
    gamma, dt = 0.2, 5e-4
    dx = 1.0 / L
    f = tridiag_factors(L, dx, dt, gamma, bc, device="cpu")
    x = torch.tensor(np.random.default_rng(L).uniform(0.0, 2.0 / L, (3, L)),
                     dtype=torch.float32)
    got = scan_solve(f, x)
    want = x.double() @ build_dense_inverse(L, dx, dt, gamma, bc,
                                            device="cpu").double().T
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=1e-9)
    np.testing.assert_allclose(got.numpy(), tridiag_solve(f, x).numpy(),
                               rtol=2e-5, atol=1e-9)
    if L == 1000:
        x1 = torch.tensor(1 + 0.3 * np.random.default_rng(0)
                          .standard_normal((4, L)), dtype=torch.float32)
        exact = torch.linalg.solve(
            torch.linalg.inv(build_dense_inverse(
                L, dx, dt, gamma, bc, device="cpu").double()),
            x1.double().T).T
        err = lambda v: float((v.double() - exact).abs().max())
        assert err(scan_solve(f, x1)) <= err(tridiag_solve(f, x1))


@pytest.mark.parametrize("bc", ["periodic", "neumann"])
def test_scan_coefficients_are_the_thomas_factors(bc):
    """The scan's float64 table [1/pivot, c', α, z] is Thomas' factors and
    the Sherman–Morrison column (the f32 rows rounded from it), α_i =
    a_i/pivot_i: the affine forward recurrence y_i = α_i·y_{i−1} +
    ρ_i/pivot_i is Thomas' forward sweep (ρ_i + a_i·y_{i−1})/pivot_i, to
    float64 roundoff."""
    L = 1000
    f = tridiag_factors(L, 1.0 / L, 5e-4, 0.2, bc, device="cpu")
    inv, cp, alpha, z = f.scan
    assert f.scan.dtype == torch.float64
    assert torch.equal(f.rows[0], inv.float())
    assert torch.equal(f.rows[1], cp.float())
    assert torch.equal(f.rows[2], z.float())
    assert bool((z != 0).any()) == (bc == "periodic")
    a = alpha / inv
    np.testing.assert_allclose(a.numpy(), f.rows[3].double().numpy(),
                               rtol=1e-7)
    rho = torch.rand(L, dtype=torch.float64, generator=torch.Generator()
                     .manual_seed(0))
    y_aff = y_th = torch.zeros((), dtype=torch.float64)
    for i in range(L):
        y_aff = alpha[i] * y_aff + rho[i] * inv[i]
        y_th = (rho[i] + a[i] * y_th) * inv[i]
        assert float(abs(y_aff - y_th)) <= 1e-12 * float(abs(y_th))


# ---------------------------------------------------------------------------
# (b) the blocked circulant
# ---------------------------------------------------------------------------

def blocked_circulant(x, half, avail_floats):
    """Kernel B2's ``circulant`` on one field, emulated unit by unit (all
    units at once): out[i] = Σ_d w(d)·(x[i−d] + x[i+d]) + w0·x[i], each
    slice's chain from its outermost tap inward."""
    L, S = x.shape[0], KBLOCK
    nb, ns, length = tap_plan(L, half.shape[0] - 1, avail_floats)
    w = padded_taps(half, ns, length)
    x0 = (torch.arange(nb) * S)[None, :]
    t1 = (torch.arange(ns) * length + length)[:, None]   # a slice's top tap
    # the windows of tap t1 + 1 (left slot 0 and right slot S-1 unused)
    la = [x[(x0 + s - t1 - 1) % L] for s in range(S)]
    ra = [x[(x0 + s + t1 + 1) % L] for s in range(S)]
    acc = [torch.zeros(ns, nb) for _ in range(S)]
    for c in range(0, length, S):
        for u in range(S):
            d = t1 - c - u
            la[u], ra[S - 1 - u] = x[(x0 + S - 1 - d) % L], x[(x0 + d) % L]
            wd = w[d].expand(ns, nb)
            for s in range(S):
                il, ir = (s + u + 1) % S, (s + 2 * S - 1 - u) % S
                acc[s] = _fma(wd, la[il] + ra[ir], acc[s])
    for s in range(S):                        # slice 0: the centre tap
        acc[s][0] = _fma(w[0].expand(nb), x[(x0[0] + s) % L], acc[s][0])
    part = torch.zeros(ns, nb * S)
    for s in range(S):
        part[:, s::S] = acc[s]
    part = part[:, :L]
    out = part[ns - 1]
    for sl in range(ns - 2, -1, -1):          # the last slice first
        out = out + part[sl]
    return out, (nb, ns, length)


def _circulant(k):
    L = k.shape[0]
    i = np.arange(L)
    return k[(i[None, :] - i[:, None]) % L]   # rows input, columns output


@pytest.mark.parametrize("L,sigma", [(1000, 0.05), (999, 0.05), (256, 0.1),
                                     (255, 0.3), (64, 0.02), (11, 0.2)])
@pytest.mark.parametrize("avail", [10 ** 6, 2000])
def test_blocked_circulant_matches_dense_product(L, sigma, avail):
    """The full circulant (R = L//2, the d = L/2 tap halved for even L)
    against the float64 dense product of the periodic Gaussian and the JAX
    package's ``build_conv_matrix`` (rows input, columns output): rtol 1e-5,
    atol 1e-9 on fields ~1/L.  KBLOCK = 9 divides 999 only, so the other
    L end in a ragged unit; ``avail`` = 2000 floats forces a single slice
    (no partial-sum buffer) at L ≥ 1000."""
    from hydrolim_tpu.core.config import ParticleConfig as JConfig
    from hydrolim_tpu.ops.pallas_exclusion import build_conv_matrix

    from hydrolim_tpu_torch.ops.convolve import periodic_gaussian_kernel

    k = periodic_gaussian_kernel(L, 1.0 / L, sigma)
    ops = SmoothOperands("smooth", torch.tensor(k))
    x = torch.tensor(np.random.default_rng(L).uniform(0.0, 2.0 / L, L),
                     dtype=torch.float32)
    got, (nb, ns, length) = blocked_circulant(x, ops.half_taps, avail)
    assert ns * length >= L // 2 and length % KBLOCK == 0
    assert nb * KBLOCK >= L > (nb - 1) * KBLOCK
    assert nb * ns <= KERNEL_THREADS and (ns == 1 or ns * L <= avail)
    want = x.double().numpy() @ _circulant(k.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)
    M = build_conv_matrix(JConfig(L=L, N=L // 2, init="fixed",
                                  scale_rates=False,
                                  local_kernel_sigma=sigma, periodic=True,
                                  site_capacity=1))[:L, :L]
    np.testing.assert_allclose(got.numpy(), x.double().numpy() @ M,
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("L,R", [(1000, 32), (1000, 63), (8192, 48),
                                 (20, 3)])
def test_blocked_narrow_and_banded_taps(L, R):
    """The narrow smoothing's and banded solve's radii through the same
    routine, against the dense product of their (2R+1,) taps."""
    rng = np.random.default_rng(R)
    half = torch.tensor(rng.uniform(0.1, 1.0, R + 1), dtype=torch.float32)
    x = torch.tensor(rng.uniform(0.0, 1.0, L), dtype=torch.float32)
    got, _ = blocked_circulant(x, half, 160_000)
    k = np.zeros(L)
    k[:R + 1] = half.double().numpy()
    k[L - R:] = half.double().numpy()[1:][::-1]
    np.testing.assert_allclose(got.numpy(),
                               x.double().numpy() @ _circulant(k),
                               rtol=1e-5, atol=1e-9)


def test_tap_plan_fills_the_block_and_pads_least():
    """At the smooth rows' L=1000, R=500: 112 units of 9 sites, 8 slices of
    63 taps (896 threads); narrow r=32 gets its slices too; an L past the
    block's threads takes one slice; R = 0 takes no taps; a small buffer
    caps the slices."""
    assert KBLOCK == 9
    assert tap_plan(1000, 500, 10 ** 6) == (112, 8, 63)
    assert tap_plan(1000, 32, 10 ** 6) == (112, 4, 9)
    assert tap_plan(8192, 48, 10 ** 6) == (911, 1, 54)
    assert tap_plan(1000, 500, 5_999) == (112, 5, 108)
    assert tap_plan(64, 0, 10 ** 6) == (8, 1, 0)


# ---------------------------------------------------------------------------
# (c) B1's launch plan
# ---------------------------------------------------------------------------

# co-residency as an H100's GPCs may give it: clusters of C CTAs the card
# holds at once, per C (a table for the main path's and one for the
# headline's CTA shapes)
MAIN_SEATS = {1: 132, 2: 66, 3: 42, 4: 32, 5: 24, 6: 20, 7: 16, 8: 16}
HEAD_SEATS = {1: 132, 2: 66, 3: 42, 4: 32, 5: 0, 6: 0, 7: 0, 8: 16}


@pytest.mark.parametrize("B,n,L,seats", [(33, 5000, 256, MAIN_SEATS),
                                         (64, 100_000, 1000, HEAD_SEATS)])
def test_b1_plan_seats_every_cluster_at_once(B, n, L, seats):
    """The plan picks a C whose B clusters are all co-resident (C=4 seats
    only 32 at the main path's B=33), with the state on chip: C=3 (417
    groups per CTA, in registers) at the main path, C=2 at the headline."""
    plan = launch_plan(B, n, L, 132_000, seats)
    C = plan.shape.cluster
    assert plan.waves == 1 and seats[C] >= B and plan.shape.mode != "global"
    assert C == (3 if n == 5000 else 2)
    forced = launch_plan(B, n, L, 132_000, seats, cluster=4)
    assert forced.waves == (2 if B > 32 else 1)
    # a table where nothing but C=1 fits still gives a plan
    one = launch_plan(B, n, L, 1000, {1: 132})
    assert one.shape.cluster == 1


def test_b1_plan_headline_state_in_shared_memory():
    """C=2: 12,500 groups per CTA, 200 KB of packed state, 17 passes of
    736 threads (12 idle thread-slots) rather than 13 of 992 (396)."""
    plan = launch_plan(64, 100_000, 1000, 1000, HEAD_SEATS)
    assert (plan.shape.cluster, plan.shape.mode) == (2, "shared")
    assert plan.shape.smem_bytes == 200_000
    assert (plan.shape.threads, plan.shape.groups_per_thread) == (736, 17)


@pytest.mark.parametrize("n", [4, 5000, 30_001, 100_000, 450_000])
@pytest.mark.parametrize("C", range(1, MAX_CLUSTER + 1))
def test_b1_packed_state_fits_and_covers(n, C):
    """Every packed CTA fits the block's shared memory beside the
    reduction slots, the threads cover the groups with fewer idle
    thread-slots than one warp per pass, and registers hold ≤ 4 groups a
    thread."""
    sh = cta_shape(n, 1000, C)
    groups = -(-n // 4)
    assert sh.groups_per_cta * C >= groups
    assert sh.threads % 32 == 0 and 32 <= sh.threads <= 1024
    assert sh.groups_per_thread * sh.threads >= sh.groups_per_cta
    assert sh.groups_per_thread * sh.threads - sh.groups_per_cta < 32 \
        * sh.groups_per_thread
    if sh.mode == "registers":
        assert sh.groups_per_thread in (1, 2, 4)
    if sh.mode == "shared":
        assert sh.smem_bytes + SLOT_BYTES <= SMEM_LIMIT
    if sh.mode == "global":
        assert 16 * sh.groups_per_cta + SLOT_BYTES > SMEM_LIMIT


@pytest.mark.parametrize("L", [3, 4, 256, 65_536])
def test_b1_winding_change_never_overflows(L):
    """|Δwind| ≤ ⌈k/L⌉ + 1 must fit 14 signed bits: a long call at small
    L is split into launches of at most ``max_steps_per_launch(L)`` steps
    that cover it."""
    k = 3 * max_steps_per_launch(L) + 17
    plan = launch_plan(8, 5000, L, k, MAIN_SEATS)
    spl = plan.steps_per_launch
    assert spl < k and -(-spl // L) + 1 <= MAX_DWIND
    assert -(-k // spl) == 4
    short = launch_plan(8, 5000, L, 1000, MAIN_SEATS)
    assert short.steps_per_launch == 1000


def test_b1_unpacked_state_past_the_packed_limits():
    """L > 65,536 (pos past 16 bits) and N past what C=8 holds take the
    unpacked device-memory state, which needs no split."""
    for n, L in ((5000, 65_537), (1_000_000, 1000)):
        plan = launch_plan(4, n, L, 10 ** 7, MAIN_SEATS)
        assert plan.shape.mode == "global"
        assert plan.steps_per_launch == 10 ** 7


@pytest.mark.parametrize("B,n,seats,want", [
    (33, 5000, {C: 40 for C in range(1, 9)}, 3),    # first C at ≤ 512
    (1, 2000, MAIN_SEATS, 1),                        # 500 groups at C=1
    (200, 5000, MAIN_SEATS, 1),                      # fewest waves first
    (16, 100_000, HEAD_SEATS, 8),                    # fewest groups per CTA
])
def test_b1_plan_rule(B, n, seats, want):
    """Among the sizes with the fewest waves, the smallest C that brings a
    CTA to ``ONE_PASS_GROUPS`` groups, else the fewest groups per CTA."""
    plan = launch_plan(B, n, 1000, 1000, seats)
    assert plan.shape.cluster == want
    waves = {C: -(-B // seats[C]) for C in seats if seats[C]}
    assert plan.waves == min(waves.values())
    if plan.shape.groups_per_cta > ONE_PASS_GROUPS:
        assert all(cta_shape(n, 1000, C).groups_per_cta > ONE_PASS_GROUPS
                   for C in waves if waves[C] == plan.waves)


@pytest.mark.parametrize("mode", ["registers", "shared", "global"])
def test_b1_forced_state_mode(mode):
    """A forced mode keeps the CTA's groups and, off registers, spreads
    them as the wrapper's own shared or device-memory plan would; the
    plan carries it; a mode that does not hold the groups is refused."""
    sh = cta_shape(5000, 256, 3, mode)
    assert (sh.mode, sh.groups_per_cta, sh.threads) == (mode, 417, 448)
    assert sh.groups_per_thread == 1
    plan = launch_plan(33, 5000, 256, 1000, MAIN_SEATS, cluster=3, mode=mode)
    assert plan.shape == sh
    if mode != "global":
        with pytest.raises(ValueError, match="does not hold"):
            cta_shape(100_000, 70_000 if mode == "shared" else 1000, 2, mode)
