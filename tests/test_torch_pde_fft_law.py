"""Kernel B2's full smoothing on its device-memory route: the FFT stage's
law and plan, on the CPU.

(a) The stage's arithmetic emulated in numpy float32 as
    ``csrc/pde_multi_step.cu`` ``fft_smooth`` runs it at the card's plan
    for 64 CTAs a replica: the row num + i·den wrapped and padded
    (``fft_plan``), the two-pass split n = n1·n2 with its index maps,
    Stockham sub-transforms (radix 2 or 4, then 8; natural order in and
    out; each step's twiddle W_(pR)^(r·k) from the per-step table, the
    R-point DFT a radix-2 network with W_8's constants, conjugate for the
    inverse) and the passes' W_n^(n2'·k1) from the float64-built table
    (``fft_twiddles``), the spectrum in the second pass's order
    (``SmoothOperands.fft_spectrum``), each complex product rounded as the
    kernel rounds it (a fused multiply-add a part, ``fcmul``).  Held
    against the float64 ``numpy.fft`` circular convolution by the
    Gaussian's circulant row at L = 1000, 4096, 32,768, 131,072, 131,071
    (prime) and 200,000, σ = 0.0005 and 0.05 (xlim 1): the smoothed num
    and den to 2e-6 of max|den|, m = num/(den + 1e-12) to atol 1e-5.  The
    same emulation in float64 meets the reference to 1e-12: the index maps
    and the wrap are exact, only float32 rounds.  Each sub-transform alone
    is the DFT of its length (N = 2 … 8192, forward and inverse).
(b) The plan: ``fft_plan``'s sizes (n1 = G where n allows both passes a
    unit a CTA with 16 columns or more) and refusal, the route of m_mode
    'smooth' (``SMOOTH_FFT_FROM``: the circulant below the crossover, the
    device-memory route and its FFT stage from it, ``route='cluster'``
    still the circulant), the stage's bytes in ``gmem_call_bytes``, and
    the memory refusal naming the largest L.
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

def _fma(a, b, c):
    """a·b + c rounded once (float32 operands: the product is exact in
    float64); plain in float64."""
    if a.dtype != np.float32:
        return a * b + c
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _fcmul(ar, ai, br, bi):
    """``fcmul``: a fused multiply-add for each part."""
    return _fma(ar, br, -(ai * bi)), _fma(ar, bi, ai * br)


def _fcmulc(ar, ai, br, bi):
    """``fcmulc``: a · conj(b), a fused multiply-add for each part."""
    return _fma(ar, br, ai * bi), _fma(ai, br, -(ar * bi))


def _rot8(d, e, inverse, c8):
    """d · W_8^e (its conjugate for the inverse), as ``rot8``: W_8 = c(1 −
    i), a sum and a difference scaled by c."""
    if e == 0:
        return d
    if e == 2:
        return (-d[1], d[0]) if inverse else (d[1], -d[0])
    s, t = c8 * (d[0] + d[1]), c8 * (d[1] - d[0])
    if e == 1:
        return (-t, s) if inverse else (s, t)
    return (-s, -t) if inverse else (t, -s)


def _dft_small(u, inverse, c8):
    """``dft_small``: the radix-2 DIF network on R = 2, 4, 8 values, its
    bit-reversed outputs read in natural order."""
    R, u, h = len(u), list(u), len(u) // 2
    while h >= 1:
        for b in range(0, R, 2 * h):
            for r in range(h):
                a, d = u[b + r], u[b + r + h]
                u[b + r] = (a[0] + d[0], a[1] + d[1])
                u[b + r + h] = _rot8((a[0] - d[0], a[1] - d[1]),
                                     r * (4 // h), inverse, c8)
        h //= 2
    lg = R.bit_length() - 1
    return [u[int(format(s, f"0{lg}b")[::-1], 2) if lg else 0]
            for s in range(R)]


def _stockham(xr, xi, tw, inverse, c8):
    """``fft_unit`` on (…, N) rows: Stockham steps (``fft_radices``), item
    i taking elements i + r·T, turned by the step's table entry
    (r − 1)·p + k, k = i mod p, its R-point DFT stored at j + s·p,
    j = (i − k)·R + k."""
    N, p, off = xr.shape[-1], 1, 0
    for R in pk.fft_radices(N):
        T = N // R
        i = np.arange(T)
        k = i & (p - 1)
        u = [(xr[..., i + r * T], xi[..., i + r * T]) for r in range(R)]
        if p > 1:
            for r in range(1, R):
                w = tw[off + (r - 1) * p + k]
                u[r] = (_fcmulc if inverse else _fcmul)(*u[r], w[:, 0],
                                                        w[:, 1])
        out = _dft_small(u, inverse, c8)
        j = (i - k) * R + k
        yr, yi = np.empty_like(xr), np.empty_like(xi)
        for s_ in range(R):
            yr[..., j + s_ * p], yi[..., j + s_ * p] = out[s_]
        xr, xi = yr, yi
        off += (R - 1) * p
        p *= R
    return xr, xi


def fft_stage_emulated(num, den, smooth, L, dtype=np.float32, G=64):
    """The smoothed (num, den) rows of ``fft_smooth`` at ``fft_plan(L, G)``
    in ``dtype`` arithmetic (float32: the kernel's; float64: the law
    without rounding)."""
    f = pk.fft_plan(L, G)
    n, n1, n2 = f.n, f.n1, f.n2
    if dtype == np.float32:
        tw = pk.fft_twiddles(f, "cpu").numpy()
        spec = smooth.fft_spectrum(f).numpy()
    else:
        ang = np.concatenate([np.outer(np.arange(n1), np.arange(n2)).ravel()
                              * (2 * np.pi / n), pk.stockham_angles(n2),
                              pk.stockham_angles(n1)])
        tw = np.stack([np.cos(ang), -np.sin(ang)], -1)
        spec = pk.fft_spectrum_order(pk.taps_spectrum(
            smooth.half_taps.numpy().astype(np.float64), n), f)
    c8 = dtype(np.cos(np.pi / 4))
    Twr, Twi = (tw[:n, 0].reshape(n1, n2), tw[:n, 1].reshape(n1, n2))
    tw2, tw1 = tw[n:n + n2 - 1], tw[n + n2 - 1:]
    K = spec.reshape(n1, n2)
    # the padded row: t < L + 2·wrap reads site (t − wrap) mod L
    t = np.arange(n)
    j = (t - f.wrap) % L
    live = t < L + 2 * f.wrap
    zr = np.where(live, num.astype(dtype)[j], 0).astype(dtype)
    zi = np.where(live, den.astype(dtype)[j], 0).astype(dtype)
    # pass 1: column n2' over n1' (t = n2' + n2·n1'), times W_n^(n2'·k1)
    ar, ai = _stockham(zr.reshape(n1, n2).T.copy(),
                       zi.reshape(n1, n2).T.copy(), tw1, False, c8)
    xr, xi = _fcmul(ar.T, ai.T, Twr, Twi)                 # (k1, n2')
    # pass 2: row k1 over n2', the spectrum, back, times W_n^-(n2'·k1)
    xr, xi = _stockham(xr.copy(), xi.copy(), tw2, False, c8)
    xr, xi = xr * K, xi * K
    xr, xi = _stockham(xr, xi, tw2, True, c8)
    xr, xi = _fcmulc(xr, xi, Twr, Twi)
    # pass 3: column n2' over k1, natural order out, over n
    yr, yi = _stockham(xr.T.copy(), xi.T.copy(), tw1, True, c8)
    inv_n = dtype(1.0 / n)
    yr, yi = yr.T.ravel() * inv_n, yi.T.ravel() * inv_n
    return yr[f.wrap:f.wrap + L], yi[f.wrap:f.wrap + L]


def _fields(L, seed):
    rng = np.random.default_rng(seed)
    rp = (0.5 + 0.15 * rng.uniform(-1, 1, L)).astype(np.float32)
    rm = (0.5 + 0.15 * rng.uniform(-1, 1, L)).astype(np.float32)
    return rp - rm, rp + rm


@pytest.mark.parametrize("N", [2, 4, 8, 16, 32, 512, 2048, 8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_sub_transform_is_the_dft(N, inverse):
    """A sub-transform of the stage (``_stockham``: one radix-2 or 4 step,
    then radix 8, natural order in and out, the step tables of
    ``stockham_angles``) is the DFT of length N (the inverse unscaled), to
    1e-12 in float64 and to float32 roundoff in float32, for two
    sequences at once."""
    rng = np.random.default_rng(N + inverse)
    x = rng.standard_normal((2, N)) + 1j * rng.standard_normal((2, N))
    want = N * np.fft.ifft(x) if inverse else np.fft.fft(x)
    ang = pk.stockham_angles(N)
    assert ang.shape == (N - 1,)
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 2e-6)):
        tw = np.stack([np.cos(ang), -np.sin(ang)], -1).astype(dtype)
        yr, yi = _stockham(x.real.astype(dtype), x.imag.astype(dtype), tw,
                           inverse, dtype(np.cos(np.pi / 4)))
        err = np.abs(yr + 1j * yi - want).max() / np.abs(want).max()
        assert err < tol, (dtype, err)


@pytest.mark.parametrize("sigma", [0.0005, 0.05])
@pytest.mark.parametrize("L", [1000, 4096, 32_768, 131_072, 131_071,
                               200_000])
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
        k1, p = 1, 5
        assert order[k1, p] == np.float32(K[k1 + f.n1 * p])


# ---------------------------------------------------------------------------
# (b) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,n,n1,n1_g64,wrap", [
    (1000, 2048, 2, 2, 500), (4096, 4096, 2, 4, 0),
    (131_072, 131_072, 16, 64, 0), (131_071, 262_144, 32, 64, 65_535),
    (200_000, 524_288, 64, 64, 100_000), (4_194_304, 4_194_304, 512, 512, 0),
    (1 << 26, 1 << 26, 8192, 8192, 0),
    ((1 << 25) - 1, 1 << 26, 8192, 8192, (1 << 24) - 1)])
def test_fft_plan_sizes(L, n, n1, n1_g64, wrap):
    """A power-of-two L at n = L; any other L at the power of two n ≥
    L + 2·(L//2), wrapped by L//2; n1 = G where n ≥ 16·G² (both passes a
    unit a CTA, 16 columns or more), else n/8192 or 2, n2 = n/n1 ≤ 8192;
    a unit ≤ 8192 values and as many columns (rows) as give each CTA one;
    three padded unit buffers; past n = 2²⁶ refused, naming the largest L."""
    f = pk.fft_plan(L, 1)
    assert (f.n, f.n1, f.n2, f.wrap) == (n, n1, n // n1, wrap)
    assert pk.fft_plan(L, 64).n1 == n1_g64
    for G in (1, 2, 64, 256):   # a CTA's unit fits its shared buffer
        g = pk.fft_plan(L, G)
        assert (g.n, g.wrap) == (f.n, f.wrap) and g.n1 * g.n2 == n
        assert 2 <= g.n1 <= g.n2 <= pk.FFT_MAX_SUB
        assert g.buf <= pk.FFT_MAX_SUB and g.w1 >= 1 and g.w2 >= 1
        assert g.n1 * g.w1 <= g.buf and g.n2 * g.w2 <= g.buf
        assert g.n2 // g.w1 >= min(G, g.n2) and g.n1 // g.w2 >= min(G, g.n1)
        if G >= 2 and pk.FFT_RUN * G * G <= n <= pk.FFT_MAX_SUB * G:
            assert g.n1 == G and g.w1 >= pk.FFT_RUN
            assert g.n2 // g.w1 >= G and g.n1 // g.w2 >= G
        assert g.smem == 24 * g.unit and g.unit % 2 == 0
        assert g.unit >= g.buf + 2 * ((g.buf - 1) // 32) + 1
    assert sum(pk.fft_radices(f.n2)) and np.prod(pk.fft_radices(f.n2)) \
        == f.n2
    assert pk.stockham_angles(f.n1).shape == (f.n1 - 1,)


@pytest.mark.parametrize("L", [(1 << 26) + 1, (1 << 25) + 1, 1 << 27])
def test_fft_plan_refuses_past_its_reach(L):
    with pytest.raises(ValueError, match="largest L it serves is 67108864 "
                       r"\(a power of two\), else 33554431"):
        pk.fft_plan(L, 1)


def test_smooth_routes_and_stage():
    """m_mode 'smooth' takes the cluster route's direct circulant below
    ``SMOOTH_FFT_FROM`` sites (just below it, and at 1000) and the
    device-memory route with its FFT stage from it on, at the batches the
    drivers use (B = 2, 5, 64); ``route='cluster'`` still forces the
    circulant where a cluster fits (65,536); the stage's units cover every
    CTA at the drivers' shapes and its shared memory is counted in the
    CTA's."""
    top = pk.SMOOTH_FFT_FROM
    for B in (2, 5, 64):
        for L in (1000, top - 1):
            p = pk.pde_route_plan(B, L, 64, "smooth", {"smooth": L // 2},
                                  H100, H100_CTAS)
            assert p.route == "cluster" and p.smooth.taps >= L // 2, (B, L)
        for L in (top, 65_536):
            p = pk.pde_route_plan(B, L, 64, "smooth", {"smooth": L // 2},
                                  H100, H100_CTAS)
            assert p.route == "gmem" and p.fft is not None, (B, L)
    forced = pk.pde_route_plan(2, 65_536, 64, "smooth", {"smooth": 32_768},
                               H100, H100_CTAS, route="cluster")
    assert forced.route == "cluster" and forced.smooth.taps >= 32_768
    for B, L, G in ((2, 131_072, 64), (5, 131_072, 16), (2, 4_194_304, 64),
                    (2, 65_536, 64), (64, 65_536, 2)):
        p = pk.pde_route_plan(B, L, 64, "smooth", {"smooth": L // 2}, H100,
                              H100_CTAS)
        assert (p.route, p.ctas) == ("gmem", G)
        f = p.fft
        assert f == pk.fft_plan(L, G)
        assert f.n2 // f.w1 >= min(G, f.n2) and f.n1 // f.w2 >= min(G, f.n1)
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
    each replica of a launch), its spectrum (n·4) and twiddles ((n + n2 +
    n1 − 2)·8), and keeps no smoothed denominator's field (the stage forms
    m in its last pass), where the narrow smoothing keeps one."""
    L = 131_072
    p = pk.pde_route_plan(2, L, 64, "smooth", {"smooth": L // 2}, H100,
                          H100_CTAS)
    f = p.fft
    args = (2, L, 64, 20, "smooth", 8, 1500)
    no_fft = pk.dataclasses.replace(p, fft=None)
    extra = pk.gmem_call_bytes(p, *args) - pk.gmem_call_bytes(no_fft, *args)
    assert extra == (8 * p.per_launch * f.n + 4 * f.n
                     + 8 * (f.n + f.n2 + f.n1 - 2) - 4 * p.per_launch * L)
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
