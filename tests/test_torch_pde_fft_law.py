"""Kernel B2's full smoothing on its device-memory route: the FFT stage's
law and plan, on the CPU.

(a) The stage's arithmetic emulated in numpy float32 as
    ``csrc/pde_multi_step.cu`` ``fft_smooth`` runs it: the row num + i·den
    wrapped and padded (``fft_plan``), the two-pass split n = n1·n2 with
    its index maps, radix-2 sub-transforms (decimation in frequency
    forward, in time inverse, conjugate twiddles) with W_n2^i and the
    passes' W_n^(n2'·k1) from the float64-built table (``fft_twiddles``),
    the spectrum in the second pass's order (``SmoothOperands.
    fft_spectrum``), each complex product rounded as the kernel rounds it
    (``--fmad=false``).  Held against the float64 ``numpy.fft`` circular
    convolution by the Gaussian's circulant row at L = 1000, 4096,
    131,072, 131,071 (prime) and 200,000, σ = 0.0005 and 0.05 (xlim 1):
    the smoothed num and den to 2e-6 of max|den|, m = num/(den + 1e-12)
    to atol 1e-5.  The same emulation in float64 meets the reference to
    1e-12: the index maps and the wrap are exact, only float32 rounds.
(b) The plan: ``fft_plan``'s sizes and refusal, the route of m_mode
    'smooth' (the cluster at 65,536, the device-memory route and its FFT
    stage at 131,072 and 4,194,304), the stage's bytes in
    ``gmem_call_bytes``, and the memory refusal naming the largest L.
"""
import numpy as np
import pytest
import torch

from hydrolim_tpu_torch.ops import pde_kernel as pk
from hydrolim_tpu_torch.ops.convolve import periodic_gaussian_kernel

H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
H100_CTAS = 132


# ---------------------------------------------------------------------------
# (a) the stage's arithmetic
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cmulc(ar, ai, br, bi):
    """(a) · conj(b)."""
    return ar * br + ai * bi, ai * br - ar * bi


def _radix2(xr, xi, twr, twi, inverse):
    """The kernel's ``fft_batch`` on (…, n) rows in place: W_nt^i in
    (twr, twi), i < nt/2; forward DIF (natural in, bit-reversed out),
    inverse DIT (bit-reversed in, natural out, unscaled)."""
    n, nt = xr.shape[-1], 2 * twr.shape[0]
    spans = [1 << s for s in range(n.bit_length() - 1)]
    for h in (spans if inverse else spans[::-1]):
        shape = xr.shape[:-1] + (n // (2 * h), 2, h)
        vr, vi = xr.reshape(shape), xi.reshape(shape)
        w = np.arange(h) * (nt // (2 * h))
        ar, ai = vr[..., 0, :].copy(), vi[..., 0, :].copy()
        dr, di = vr[..., 1, :].copy(), vi[..., 1, :].copy()
        if inverse:
            dr, di = _cmulc(dr, di, twr[w], twi[w])
            vr[..., 0, :], vi[..., 0, :] = ar + dr, ai + di
            vr[..., 1, :], vi[..., 1, :] = ar - dr, ai - di
        else:
            vr[..., 0, :], vi[..., 0, :] = ar + dr, ai + di
            vr[..., 1, :], vi[..., 1, :] = _cmul(ar - dr, ai - di, twr[w],
                                                 twi[w])


def fft_stage_emulated(num, den, smooth, L, dtype=np.float32):
    """The smoothed (num, den) rows of ``fft_smooth`` in ``dtype``
    arithmetic (float32: the kernel's; float64: the law without
    rounding)."""
    f = pk.fft_plan(L, 1)
    n, n1, n2 = f.n, f.n1, f.n2
    if dtype == np.float32:
        tw = pk.fft_twiddles(f, "cpu").numpy()
        spec = smooth.fft_spectrum(f).numpy()
    else:
        ang = np.concatenate([np.outer(np.arange(n1), np.arange(n2)).ravel()
                              * (2 * np.pi / n),
                              np.arange(n2 // 2) * (2 * np.pi / n2)])
        tw = np.stack([np.cos(ang), -np.sin(ang)], -1)
        spec = pk.fft_spectrum_order(pk.taps_spectrum(
            smooth.half_taps.numpy().astype(np.float64), n), f)
    Twr, Twi = (tw[:n, 0].reshape(n1, n2), tw[:n, 1].reshape(n1, n2))
    twr, twi = tw[n:, 0], tw[n:, 1]
    K = spec.reshape(n1, n2)
    rev1 = pk.bitrev(n1)
    # the padded row: t < L + 2·wrap reads site (t − wrap) mod L
    t = np.arange(n)
    j = (t - f.wrap) % L
    live = t < L + 2 * f.wrap
    zr = np.where(live, num.astype(dtype)[j], 0).astype(dtype)
    zi = np.where(live, den.astype(dtype)[j], 0).astype(dtype)
    # pass 1: column n2' over n1' (t = n2' + n2·n1'), times W_n^(n2'·k1)
    ar, ai = zr.reshape(n1, n2).T.copy(), zi.reshape(n1, n2).T.copy()
    _radix2(ar, ai, twr, twi, inverse=False)
    ar, ai = ar[:, rev1].T, ai[:, rev1].T               # (k1, n2')
    xr, xi = _cmul(ar, ai, Twr, Twi)
    # pass 2: row k1 over n2', the spectrum, back, times W_n^-(n2'·k1)
    xr, xi = xr.copy(), xi.copy()
    _radix2(xr, xi, twr, twi, inverse=False)
    xr, xi = xr * K, xi * K
    _radix2(xr, xi, twr, twi, inverse=True)
    xr, xi = _cmulc(xr, xi, Twr, Twi)
    # pass 3: column n2' over k1, bit-reversed in, natural out, over n
    yr, yi = xr.T[:, rev1].copy(), xi.T[:, rev1].copy()
    _radix2(yr, yi, twr, twi, inverse=True)
    inv_n = dtype(1.0 / n)
    yr, yi = yr.T.ravel() * inv_n, yi.T.ravel() * inv_n
    return yr[f.wrap:f.wrap + L], yi[f.wrap:f.wrap + L]


def _fields(L, seed):
    rng = np.random.default_rng(seed)
    rp = (0.5 + 0.15 * rng.uniform(-1, 1, L)).astype(np.float32)
    rm = (0.5 + 0.15 * rng.uniform(-1, 1, L)).astype(np.float32)
    return rp - rm, rp + rm


@pytest.mark.parametrize("sigma", [0.0005, 0.05])
@pytest.mark.parametrize("L", [1000, 4096, 131_072, 131_071, 200_000])
def test_fft_stage_meets_the_float64_circular_convolution(L, sigma):
    """The emulated stage against the float64 circular convolution by the
    circulant row ``m_field_of`` smooths with: num and den to 2e-6 of
    max|den| (float32), m to atol 1e-5; in float64 to 1e-12."""
    w = periodic_gaussian_kernel(L, 1.0 / L, sigma)
    smooth = pk.build_smooth_operands("smooth", w, "cpu")
    num, den = _fields(L, L + int(sigma * 1e4))
    kr = np.fft.rfft(w.astype(np.float64))
    conv = lambda x: np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * kr,
                                  n=L)
    want_n, want_d = conv(num), conv(den)
    scale = np.abs(want_d).max()
    got_n, got_d = fft_stage_emulated(num, den, smooth, L)
    assert got_n.dtype == np.float32
    assert np.abs(got_n - want_n).max() < 2e-6 * scale
    assert np.abs(got_d - want_d).max() < 2e-6 * scale
    m = got_n / (got_d + np.float32(1e-12))
    np.testing.assert_allclose(m, want_n / (want_d + 1e-12), rtol=0,
                               atol=1e-5)
    e_n, e_d = fft_stage_emulated(num, den, smooth, L, np.float64)
    assert np.abs(e_n - want_n).max() < 1e-12 * scale
    assert np.abs(e_d - want_d).max() < 1e-12 * scale


def test_spectrum_is_the_circulants():
    """The taps' spectrum is real and symmetric with K[0] = Σ taps; on n =
    L (a power of two) it is the DFT of the circulant row (the halved
    ±L/2 tap counted once); the kernel's copy is in the second pass's
    order."""
    for L in (4096, 1000):
        w = periodic_gaussian_kernel(L, 1.0 / L, 0.05)
        smooth = pk.build_smooth_operands("smooth", w, "cpu")
        t = smooth.half_taps.numpy().astype(np.float64)
        f = pk.fft_plan(L, 1)
        K = pk.taps_spectrum(t, f.n)
        assert K.shape == (f.n,)
        np.testing.assert_allclose(K[0], w.astype(np.float64).sum(),
                                   rtol=1e-12)
        np.testing.assert_allclose(K[1:], K[1:][::-1], rtol=0, atol=1e-15)
        if f.n == L:
            np.testing.assert_allclose(K, np.fft.fft(w.astype(np.float64))
                                       .real, rtol=0, atol=1e-12)
        order = smooth.fft_spectrum(f).numpy().reshape(f.n1, f.n2)
        rev = pk.bitrev(f.n2)
        k1, p = 3, 5
        assert order[k1, p] == np.float32(K[k1 + f.n1 * rev[p]])


# ---------------------------------------------------------------------------
# (b) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,n,n1,wrap", [
    (1000, 2048, 32, 500), (4096, 4096, 64, 0), (131_072, 131_072, 256, 0),
    (131_071, 262_144, 512, 65_535), (200_000, 524_288, 512, 100_000),
    (4_194_304, 4_194_304, 2048, 0), (1 << 26, 1 << 26, 8192, 0),
    ((1 << 25) - 1, 1 << 26, 8192, (1 << 24) - 1)])
def test_fft_plan_sizes(L, n, n1, wrap):
    """A power-of-two L at n = L; any other L at the power of two n ≥
    L + 2·(L//2), wrapped by L//2; n1 = 2^⌊log₂n/2⌋, n2 = n/n1, both at
    most 8192; past n = 2²⁶ refused, naming the largest L."""
    f = pk.fft_plan(L, 1)
    assert (f.n, f.n1, f.n2, f.wrap) == (n, n1, n // n1, wrap)
    assert f.n1 <= f.n2 <= pk.FFT_MAX_SUB
    assert f.n >= L + 2 * f.wrap
    for G in (1, 64, 256):      # a CTA's unit fits its shared buffer
        g = pk.fft_plan(L, G)
        assert g.buf <= pk.FFT_MAX_SUB and g.w1 >= 1 and g.w2 >= 1
        assert (g.n, g.n1, g.n2, g.wrap) == (f.n, f.n1, f.n2, f.wrap)


@pytest.mark.parametrize("L", [(1 << 26) + 1, (1 << 25) + 1, 1 << 27])
def test_fft_plan_refuses_past_its_reach(L):
    with pytest.raises(ValueError, match="largest L it serves is 67108864 "
                       r"\(a power of two\), else 33554431"):
        pk.fft_plan(L, 1)


def test_smooth_routes_and_stage():
    """m_mode 'smooth' takes the cluster route where a cluster fits (65,536:
    the direct circulant, as before) and the device-memory route with its
    FFT stage past it; the stage's units cover every CTA at the drivers'
    shapes and its shared memory is counted in the CTA's."""
    p = pk.pde_route_plan(2, 65_536, 64, "smooth", {"smooth": 32_768}, H100,
                          H100_CTAS)
    assert p.route == "cluster"
    for B, L, G in ((2, 131_072, 64), (5, 131_072, 16), (2, 4_194_304, 64)):
        p = pk.pde_route_plan(B, L, 64, "smooth", {"smooth": L // 2}, H100,
                              H100_CTAS)
        assert (p.route, p.ctas) == ("gmem", G)
        f = p.fft
        assert f == pk.fft_plan(L, G)
        assert f.n2 // f.w1 >= min(G, f.n2 // 4) and f.n1 // f.w2 >= 1
        assert f.buf <= pk.FFT_MAX_SUB and p.wf == 0 and p.part == 0
        assert p.smem == pk.gmem_smem_bytes(p.tseg, 1, 0, 0, f)
    banded = pk.pde_route_plan(2, 131_072, 64, "smooth",
                               {"smooth": 65_536, "solve": 48}, H100,
                               H100_CTAS)
    assert banded.fft is not None and banded.smooth.taps == 0
    assert banded.solve.taps > 0
    with pytest.raises(ValueError, match="largest L it serves"):
        pk.pde_route_plan(1, (1 << 26) + 2, 64, "smooth", {"smooth": 1},
                          H100, H100_CTAS)
    assert pk.pde_route_plan(2, 131_072, 64, "narrow", {"smooth": 48}, H100,
                             H100_CTAS).fft is None


def test_call_bytes_count_the_stage():
    """``gmem_call_bytes`` adds the stage's complex scratch (n·8 B for
    each replica of a launch), its spectrum (n·4) and twiddles ((n +
    n2/2)·8), and the smoothed denominator's field."""
    L = 131_072
    p = pk.pde_route_plan(2, L, 64, "smooth", {"smooth": L // 2}, H100,
                          H100_CTAS)
    f = p.fft
    args = (2, L, 64, 20, "smooth", 8, 1500)
    no_fft = pk.dataclasses.replace(p, fft=None)
    extra = pk.gmem_call_bytes(p, *args) - pk.gmem_call_bytes(no_fft, *args)
    assert extra == 8 * p.per_launch * f.n + 4 * f.n + 8 * (f.n + f.n2 // 2)
    narrow = pk.gmem_call_bytes(no_fft, 2, L, 64, 20, "narrow", 8, 1500)
    assert pk.gmem_call_bytes(no_fft, *args) == narrow


def test_memory_refusal_names_the_largest_smooth_lattice():
    """At a small free memory the check refuses a 'smooth' call before any
    launch, naming the largest L whose call fits, the FFT stage's bytes
    counted; that L fits and the next odd L (and the next power of two)
    does not."""
    def plan_of(L2):
        try:
            return pk.gmem_launch_plan(2, L2, 64, "smooth", {}, H100_CTAS)
        except ValueError:
            return None
    free = 512 << 20
    kw = dict(B=2, n_t=64, window=20, m_mode="smooth", circulants={},
              kmax_rec=8, k_steps=1500, coresident_ctas=H100_CTAS)
    top = pk.gmem_max_lattice(plan_of, 2, 64, 20, "smooth", 8, 1500, free)
    need = lambda L2: pk.gmem_call_bytes(plan_of(L2), 2, L2, 64, 20,
                                         "smooth", 8, 1500)
    assert 1_048_576 < top < 4_194_304
    assert need(top) <= free < need(top + 1)
    assert need(1 << top.bit_length()) > free
    pk.check_gmem_memory(plan_of(top), free, L=top, **kw)
    L = 4_194_304
    with pytest.raises(ValueError, match=f"L={L} at B=2 needs {need(L)} B "
                       f".* the largest L this configuration serves with "
                       f"them is {top}"):
        pk.check_gmem_memory(plan_of(L), free, L=L, **kw)


def test_smooth_kernel_operands_reach_the_stage():
    """The port's routing (``kernel_operands``) sends the σ sweep's every σ
    at L = 131,072 (xlim 1) to 'smooth', and its operand gives the stage's
    spectrum on the card's transform."""
    from hydrolim_tpu_torch.core.config import PDEConfig
    from hydrolim_tpu_torch.pde.fast_solve import kernel_operands
    from hydrolim_tpu_torch.sweeps.pde_sweeps import REFERENCE_KERNEL_SIGMAS

    L = 131_072
    for sigma in REFERENCE_KERNEL_SIGMAS:
        cfg = PDEConfig(L=L, dt=1e-6, gaussian_kernel=True,
                        kernel_sigma=sigma)
        m_mode, _, smooth, _ = kernel_operands(cfg, 0.0, "cpu")
        assert m_mode == "smooth", sigma
    spec = smooth.fft_spectrum(pk.fft_plan(L, 1))
    assert spec.dtype == torch.float32 and spec.shape == (L,)
    assert torch.isfinite(spec).all()
