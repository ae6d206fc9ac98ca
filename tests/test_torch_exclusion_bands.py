"""Kernel B3's band layouts and its exchanged count field, on the CPU.

The kernel reads a band row by its rotation (``kernel_rotation``):
consecutive entries of a count array continued periodically past its ends
(``band_pad``), stepping back W where the rotation wraps, the weights from
the rotation vector ``utaps`` where every row of the warp rotates it, else
from the transposed table ``wt``.  Here
that read order is emulated in plain torch, one rounded multiply and one
rounded add per tap, and must EQUAL ``smooth_with_band`` bit for bit on the
dense periodic, dense reflect, wide reflect and narrow bands, over the
whole lattice (one CTA, or the exchanged field) and over the windows of a
cluster whose halo carries the band.  Then the cluster decomposition with
the exchanged field (``SLOT_HALO`` sites of slots, m from the whole
lattice's counts) must EQUAL the plain version over 20 steps, and the
launch plan must admit C > 1 for the wide and dense bands at L=1000 with
the shared memory the kernel takes.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.ops.exclusion_kernel import (
    MAX_CLUSTER,
    MAX_SMEM,
    SLOT_HALO,
    band_m,
    band_interior,
    band_pad,
    band_rotation,
    band_weights,
    build_smoothing_band,
    cluster_fits,
    cta_mode,
    cta_smem_bytes,
    cta_threads,
    cta_window,
    exclusion_launch_plan,
    exclusion_multi_step_plain,
    exclusion_step_plain,
    halo_width,
    kernel_rotation,
    rotation_taps,
    smooth_with_band,
    smoothing_band,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small tensors (several test processes
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (K, L, σ, periodic, how the band is changed)
BANDS = {
    "dense periodic": (3, 96, 2.0, True, None),
    "dense periodic, odd L": (3, 67, 2.0, True, None),
    "dense reflect": (1, 64, 0.5, False, None),
    "wide reflect": (1, 96, 0.1, False, None),
    "wide periodic": (3, 96, 0.05, True, None),
    "narrow reflect": (3, 96, 0.02, False, None),
    "narrow periodic": (3, 96, 0.02, True, None),
    "bent narrow reflect": (3, 96, 0.02, False, "bent"),
    "reversed row, periodic": (3, 96, 0.02, True, "reversed"),
}


def _config(K, L, sigma, periodic):
    return ParticleConfig(L=L, N=(K * L) // 2, init="fixed",
                          scale_rates=False, local_kernel_sigma=sigma,
                          periodic=periodic, site_capacity=K)


def _band(case):
    K, L, sigma, periodic, change = BANDS[case]
    idx, w = band_weights(_config(K, L, sigma, periodic))
    idx, w = idx.copy(), w.copy()
    if change == "bent":            # one interior row: not the taps
        w[L // 3] *= 1.5
    elif change == "reversed":      # inputs in descending order: no rotation
        idx[L // 2], w[L // 2] = idx[L // 2, ::-1], w[L // 2, ::-1]
    return smoothing_band(idx, w, device="cpu", periodic=periodic)


def _counts(K, L, seed):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, K + 1, (L,))
    cnt = occ - 2 * rng.binomial(occ, 0.4)
    return torch.tensor(np.stack([cnt, occ]), dtype=torch.float32)


def kernel_order_sums(f, band, rows, zc, periodic, base=0):
    """The kernel's band read (``band_m`` in ``csrc/exclusion_multi_step.
    cu``) of rows ``rows`` (global sites) at positions ``zc`` in the count
    array ``f`` (2, n), continued periodically by ``band_pad`` entries:
    (2, len(rows)) float32 sums.  Warps are 32 consecutive rows."""
    n = f.shape[1]
    L, W = band.idx.shape[0], band.idx.shape[1]
    P = band_pad(W)
    ext = f[:, torch.arange(-P, n + P) % n]
    g = torch.as_tensor(rows)
    zc = torch.as_tensor(zc)
    rot = band.krot[g].long()
    gen = rot == -1
    rr = torch.where(rot <= -2, -2 - rot, rot).clamp(min=0)
    tA = W - rr
    on = band.on_taps[g].bool() | gen
    on_warp = torch.stack([c.all() for c in on.split(32)])
    on = on_warp.repeat_interleave(32)[:len(rows)]
    utaps2 = torch.cat([band.utaps, band.utaps])
    acc = torch.zeros((2, len(rows)))
    for t in range(W):
        j = zc - band.radius + rr + t - torch.where(t >= tA, W, 0)
        v = ext[:, P + j]
        w = torch.where(on, utaps2[(rr + t).clamp(max=2 * W - 1)],
                        band.wt[t // 4, g, t % 4])
        acc = torch.where(gen, acc, acc + w * v)
    for i in torch.nonzero(gen).flatten().tolist():     # the index table
        for t in range(W):
            w = band.w[g[i], t]
            if w == 0:
                continue
            src = int(band.idx[g[i], t]) - base
            acc[:, i] = acc[:, i] + w * f[:, src % L if periodic else src]
    return acc


@pytest.mark.parametrize("case", list(BANDS))
def test_kernel_layouts_rebuild_the_rows(case):
    """``wt`` is ``w`` transposed, four taps interleaved (zeros past W);
    each row marked ``on_taps`` is
    ``utaps`` rotated by its ``krot``, bit for bit: every row of a
    periodic band (the dense one too), a reflect band's interior; the
    dense reflect band's rows are rotations around the lattice's ends
    (−1 in ``rot``, not in ``krot``)."""
    K, L, sigma, periodic, change = BANDS[case]
    band = _band(case)
    W = band.idx.shape[1]
    w = band.w.numpy()
    W4 = -(-W // 4)
    assert band.wt.shape == (W4, L, 4)
    rows = band.wt.numpy().transpose(1, 0, 2).reshape(L, 4 * W4)
    np.testing.assert_array_equal(rows[:, :W].view(np.uint32),
                                  w.view(np.uint32))
    assert not rows[:, W:].any()
    krot = band.krot.numpy()
    np.testing.assert_array_equal(krot, kernel_rotation(
        band.idx.numpy(), w, periodic))
    rot = band_rotation(band.idx.numpy(), w, periodic)
    assert ((krot == rot) | (rot == -1)).all()
    on = band.on_taps.numpy().astype(bool)
    u = np.where(krot <= -2, -2 - krot, krot)
    for x in np.flatnonzero(on):
        row = band.utaps.numpy()[(np.arange(W) + u[x]) % W]
        np.testing.assert_array_equal(row.view(np.uint32),
                                      w[x].view(np.uint32))
    utaps, on2 = rotation_taps(w, krot)
    np.testing.assert_array_equal(on2, band.on_taps.numpy())
    if change == "reversed":
        assert krot[L // 2] == -1 and not on[L // 2]
        return
    assert (krot != -1).all()
    if change == "bent":
        assert not on[L // 3]
    elif periodic:
        assert on.all()
    else:
        _, _, lo, hi = band_interior(band.idx.numpy(), w)
        assert on[lo:hi].all() and lo < hi or W == L
    if W == L and not periodic:
        assert (rot == -1).sum() >= L - 1 and (krot <= -2).sum() >= L - 1


@pytest.mark.parametrize("case", list(BANDS))
def test_kernel_read_order_equals_smooth_with_band(case):
    """The kernel's read order over the whole lattice (one CTA, or the
    exchanged field) and over each window of every cluster size whose halo
    carries the band: sums EQUAL to ``smooth_with_band`` bit for bit."""
    K, L, sigma, periodic, _ = BANDS[case]
    band = _band(case)
    W = band.idx.shape[1]
    f = _counts(K, L, seed=L + W)
    want = smooth_with_band(f, band)
    rows = np.arange(L)
    got = kernel_order_sums(f, band, rows, rows, periodic)
    assert torch.equal(got, want)
    halo = halo_width(band, periodic)
    sizes = [C for C in range(2, MAX_CLUSTER + 1)
             if cta_mode(K, L, W, C, halo) == (halo, False)]
    if W == L or "wide" in case:
        assert not sizes            # such a halo fits no cluster
    for C in sizes:
        for r in range(C):
            win = cta_window(L, C, r, halo, periodic)
            sites = win.sites(L)
            z = np.arange(win.left - (2 if win.left else 0),
                          win.left + win.hi - win.lo
                          + (2 if win.right else 0))
            got = kernel_order_sums(f[:, sites], band, sites[z], z,
                                    periodic, base=win.start)
            assert torch.equal(got, want[:, sites[z]]), (C, r)


def emulate_exchange(scal, slots, band, noise, *, C, dt, periodic,
                     bidirectional):
    """The cluster decomposition with the exchanged count field: m of the
    whole lattice each step (every CTA holds its counts), each CTA's
    segment stepped from a window of ``SLOT_HALO`` sites of slots."""
    B, K, L = slots.shape
    for s in range(noise.shape[1]):
        bits = noise[:, s].to(torch.int64) & 0xFFFFFFFF
        nz = slots != 0
        sgn = (slots > 0).float() - (slots < 0).float()
        m = band_m(sgn.sum(1), nz.float().sum(1), band)        # (B, L)
        new = torch.empty_like(slots)
        for r in range(C):
            win = cta_window(L, C, r, SLOT_HALO, periodic)
            sites = win.sites(L)
            got = exclusion_step_plain(
                slots[:, :, sites], scal, None, bits[:, 0][:, :, sites],
                bits[:, 1][:, :, sites], dt=dt, periodic=False,
                bidirectional=bidirectional, m=m[:, None, sites])
            new[:, :, win.lo:win.hi] = got[:, :, win.left:win.left + win.hi
                                           - win.lo]
        slots = new
    return slots


def _inputs(B, K, L, k, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, K + 1, (B, 1, L))
    sign = rng.choice([-1, 1], (B, K, L))
    ids = np.arange(1, B * K * L + 1).reshape(B, K, L)
    slots = np.where(np.arange(K)[None, :, None] < n, sign * ids, 0)
    scal = np.stack([np.linspace(0.5, 3.0, B), np.full(B, 1.0),
                     np.full(B, 3.0)], 1)
    noise = rng.integers(0, 2 ** 32, (B, k, 2, K, L), dtype=np.uint64)
    return (torch.tensor(slots, dtype=torch.int32),
            torch.tensor(scal, dtype=torch.float32),
            torch.tensor(noise.astype(np.uint32).view(np.int32)))


@pytest.mark.parametrize("C", [2, 3, 8])
@pytest.mark.parametrize("case", ["dense periodic", "dense reflect",
                                  "wide reflect"])
def test_exchange_decomposition_equals_plain(case, C):
    """20 steps at injected bits: segments stepped from windows of
    ``SLOT_HALO`` sites with m from the exchanged field EQUAL the plain
    version; the plan takes that mode at this C, since the band's own halo
    does not fit."""
    K, L, sigma, periodic, _ = BANDS[case]
    band = _band(case)
    W = band.idx.shape[1]
    halo = halo_width(band, periodic)
    seats = {c: 64 for c in range(1, MAX_CLUSTER + 1)}
    plan = exclusion_launch_plan(2, K, L, W, halo, seats, cluster=C)
    assert (plan.cluster, plan.halo, plan.exchange) == (C, SLOT_HALO, True)
    assert not cluster_fits(K, L, W, C, halo)
    slots, scal, noise = _inputs(2, K, L, 20, seed=L + C)
    kw = dict(dt=0.05, periodic=periodic, bidirectional=periodic)
    want = exclusion_multi_step_plain(scal, None, slots, band, k_steps=20,
                                      noise=noise, **kw)
    got = emulate_exchange(scal, slots, band, noise, C=C, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(want, slots)


# clusters an H100 seats with a CTA per SM, per C (clusters of 4 seat 32)
SEATS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# the three wide bands of the drivers at L=1000: (K, σ, periodic, B)
WIDE = {
    "phase diagram, dense periodic sigma=2": (3, 2.0, True, 64),
    "sigma sweep, dense reflect sigma=0.3": (1, 0.3, False, 55),
    "sigma sweep, reflect sigma=0.1": (1, 0.1, False, 55),
}


@pytest.mark.parametrize("case", list(WIDE))
def test_plan_admits_clusters_for_wide_bands(case):
    """At L=1000 the band's own halo fits no cluster; on the exchanged
    count field every C ≤ 8 fits, and the plan takes C=2
    (all B clusters in one wave on 2B SMs), and its shared memory is the
    kernel's count: slot halos of 3, the field's mailbox and padded field,
    the window with its slots, the taps twice over, the draw queue."""
    K, sigma, periodic, B = WIDE[case]
    L = 1000
    band = build_smoothing_band(_config(K, L, sigma, periodic), device="cpu")
    W = band.idx.shape[1]
    assert W == (801 if sigma == 0.1 else 1000)
    halo = halo_width(band, periodic)
    assert not any(cluster_fits(K, L, W, C, halo)
                   for C in range(2, MAX_CLUSTER + 1))
    plan = exclusion_launch_plan(B, K, L, W, halo, SEATS)
    assert (plan.cluster, plan.halo, plan.exchange, plan.waves) == (
        2, SLOT_HALO, True, 1)
    P = W // 2 + 4
    window = 500 + 2 * SLOT_HALO
    want = (32 * K * SLOT_HALO + 16 * L + 8 * (L + 2 * P)
            + 8 * window + 4 * window + (2 * 4 + 4 + 1) * K * window
            + 8 * W + K * cta_threads(L, 2))
    assert plan.smem == want == cta_smem_bytes(K, L, W, 2, SLOT_HALO, False,
                                               True)
    for C in range(2, MAX_CLUSTER + 1):
        assert cta_mode(K, L, W, C, halo) == (SLOT_HALO, True)
        forced = exclusion_launch_plan(B, K, L, W, halo, SEATS, cluster=C)
        assert forced.exchange and forced.smem <= MAX_SMEM


@pytest.mark.parametrize("B", [16, 33])
def test_plan_keeps_the_halo_where_it_fits(B):
    """The flagship narrow band (σ=0.002, 17 taps) and global m keep the
    halo plan: the halo carries the band's inputs, no field is exchanged,
    and the shared memory is the halo mode's."""
    L, K = 1000, 3
    band = build_smoothing_band(_config(K, L, 0.002, False), device="cpu")
    for W, halo in ((17, halo_width(band, False)), (0, SLOT_HALO)):
        plan = exclusion_launch_plan(B, K, L, W, halo, SEATS)
        C = plan.cluster
        assert C > 1 and not plan.exchange and plan.halo == halo
        assert plan.smem == cta_smem_bytes(K, L, W, C, halo, W == 0)
    assert cta_mode(K, L, 0, 1, 3) == (0, False)
    assert cta_mode(K, L, 0, 8, 3) == (3, False)
    assert not cta_smem_bytes(K, L, 0, 4, 3, True) > MAX_SMEM
