"""Kernel B2's spectra off the step's chain, on the CPU.

Each step stores its density row and ``pde_spectra`` computes the bins of
all the steps after them; ``spectra_plan`` gives that kernel's split of
the DFT and rows per block, and cuts a call whose density scratch would
pass its budget into launches of fewer steps.  The kernel's two-stage
order (one Cooley–Tukey split L = n1·n2, every twiddle from the (2, L)
table) is emulated in numpy and must give numpy's rfft.  The plain body
of the kernel (``pde_spectra_plain``, which the wrapper runs on CPU
tensors) is held against the JAX fused PDE kernel's per-step spectra in
interpret mode, on the densities that kernel itself stepped through, at
the tolerance of ``test_torch_pde_modes.py`` (rtol 1e-4, atol 1e-9), and
against numpy's rfft at the full L//2 + 1 bins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrolim_tpu.core.config import PDEConfig as JPDEConfig
from hydrolim_tpu_torch import interop
from hydrolim_tpu_torch.ops.pde_kernel import (
    SMEM_LIMIT,
    SPECTRA_SCRATCH_BYTES,
    SPECTRA_THREADS,
    pde_spectra,
    pde_spectra_plain,
    spectra_plan,
    spectra_smem_bytes,
    spectra_split,
    trig_table,
)

L, N_T, DT, K_STEPS, WINDOW, B = 128, 48, 5e-5, 6, 6, 2


@pytest.mark.parametrize("L_,n1", [(1000, 40), (1024, 32), (128, 16),
                                   (99, 11), (97, 97), (8192, 128)])
def test_spectra_split(L_, n1):
    """n1 is the smallest divisor of L at least √L; a prime L is not split
    (n1 = L: the direct sum)."""
    assert spectra_split(L_) == n1
    assert L_ % n1 == 0 and n1 * n1 >= L_
    assert not any(L_ % d == 0 for d in range(int(np.ceil(np.sqrt(L_))), n1))


@pytest.mark.parametrize("B_,k,L_,kmax,want", [
    (1, 50, 1000, 501, (40, 1, 50)),      # the single run: 200 kB scratch
    (5, 2000, 1000, 8, (40, 2, 2000)),    # the σ sweep's 8 bins: 40 MB
    (33, 2000, 1000, 8, (40, 2, 2000)),   # 264 MB, within the budget
    (64, 2000, 1000, 8, (40, 2, 1048)),   # 512 MB (the PDE phase diagram's)
    (64, 2000, 1000, 501, (40, 1, 1048)),
    (4, 2000, 8192, 8, (128, 1, 2000)),   # 8 bins of n2 = 64: 512 sums
    (2, 6, 97, 40, (97, 12, 6)),          # prime L: the direct sum
])
def test_spectra_plan(B_, k, L_, kmax, want):
    """The split, about one stage-1 sum a thread (n2·min(n1, kmax) a row,
    at most 16 rows) within shared memory, and every step in one launch
    while the (B, k, L) float32 scratch fits its budget, else as many
    steps as fit."""
    plan = spectra_plan(B_, k, L_, kmax)
    assert (plan.n1, plan.rows_per_block, plan.piece) == want
    per = (L_ // plan.n1) * min(plan.n1, kmax)
    assert plan.rows_per_block == max(1, min(16, SPECTRA_THREADS // per))
    assert spectra_smem_bytes(L_, kmax, plan.n1,
                              plan.rows_per_block) <= SMEM_LIMIT
    assert 4 * B_ * plan.piece * L_ <= SPECTRA_SCRATCH_BYTES
    if plan.piece < k:
        assert 4 * B_ * (plan.piece + 1) * L_ > SPECTRA_SCRATCH_BYTES


def emulate_two_stage(x: np.ndarray, kmax: int, dtype) -> np.ndarray:
    """The spectra kernel's arithmetic in ``dtype``: x[n2·j1 + j2] summed
    over j1 against the table at (n2·k1·j1) mod L, the twiddle at j2·k1,
    then over j2 at (n1·k2·j2) mod L for k = k1 + n1·k2; (..., 2·kmax) [re,
    im] ÷ L."""
    Ln = x.shape[-1]
    n1 = spectra_split(Ln)
    n2, k1n = Ln // n1, min(n1, kmax)
    ang = 2.0 * np.pi * np.arange(Ln) / Ln     # ``trig_table`` in dtype
    cs, sn = np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
    if dtype == np.float32:
        np.testing.assert_array_equal(np.stack([cs, sn]),
                                      trig_table(Ln, "cpu").numpy())
    xs = x.astype(dtype).reshape(*x.shape[:-1], n1, n2)       # [j1, j2]
    k1, j1, j2 = np.arange(k1n), np.arange(n1), np.arange(n2)
    e1 = (n2 * k1[:, None] * j1[None, :]) % Ln                # (k1n, n1)
    re = np.einsum("...jm,kj->...km", xs, cs[e1])            # (.., k1n, n2)
    im = np.einsum("...jm,kj->...km", xs, sn[e1])
    tw = k1[:, None] * j2[None, :]
    assert tw.max(initial=0) < Ln
    yr = re * cs[tw] - im * sn[tw]
    yi = -(re * sn[tw] + im * cs[tw])
    k = np.arange(kmax)
    e2 = (n1 * (k // n1)[:, None] * j2[None, :]) % Ln        # (kmax, n2)
    Yr, Yi = yr[..., k % n1, :], yi[..., k % n1, :]
    c2, s2 = cs[e2], sn[e2]
    xr = (Yr * c2 + Yi * s2).sum(-1)
    xi = (Yi * c2 - Yr * s2).sum(-1)
    return np.concatenate([xr, xi], -1) / dtype(Ln)


@pytest.mark.parametrize("L_,kmax", [(1000, 501), (1000, 8), (128, 65),
                                     (99, 50), (97, 49), (8192, 8)])
def test_two_stage_order_is_the_rfft(L_, kmax):
    """The kernel's split and twiddles, emulated: in float64 they give
    numpy's rfft to 1e-12 of the rows' scale, and in float32 within the
    tolerance held on the card (rtol 1e-4, atol 1e-6 on rows of order 1)."""
    rng = np.random.default_rng(L_ + kmax)
    dens = rng.uniform(0.2, 1.8, (2, 3, L_))
    X = np.fft.rfft(dens, axis=-1)[..., :kmax] / L_
    want = np.concatenate([X.real, X.imag], -1)
    np.testing.assert_allclose(emulate_two_stage(dens, kmax, np.float64),
                               want, rtol=0, atol=1e-12)
    got32 = emulate_two_stage(dens.astype(np.float32), kmax, np.float32)
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want, rtol=1e-4, atol=1e-6)


def _jax_run(kmax):
    """The JAX fused kernel in interpret mode, one step per call (narrow m,
    periodic, bidirectional, no solve, injected bits): the densities it
    read at each step, (B, k, L) float32, and its spectra records."""
    from hydrolim_tpu.ops.pallas_pde import _pad
    from hydrolim_tpu.ops.pallas_pde import pde_multi_step as j_pde
    from hydrolim_tpu.pde import fast_solve as jfs
    from hydrolim_tpu.pde.init import pde_initialize
    import jax

    jcfg = JPDEConfig(L=L, T=K_STEPS * DT, dt=DT, bc="periodic",
                      active_model="bidirectional", gaussian_kernel=True,
                      kernel_sigma=0.005, snapshot_interval=K_STEPS,
                      n_tracers=N_T, tracer_window_time=WINDOW * DT,
                      diffusion_solver="identity", fft_kmax=kmax)
    Lp, Ntp, Wp = _pad(L), _pad(N_T), _pad(WINDOW, 8)
    solve_mat, smooth_mat, j_solve, solve_r, solve_wts = \
        jfs.build_kernel_mats(jcfg, 0.0, Lp)
    inits = [pde_initialize(jcfg, jax.random.PRNGKey(1 + r),
                            mode="homogeneous", noise=0.3, n_tracers=N_T)
             for r in range(B)]
    rp0, rm0, pos0 = (np.stack([np.asarray(f(i)) for i in inits]) for f in (
        lambda i: i[0], lambda i: i[1], lambda i: i[2].unwrapped))
    spin0 = np.stack([np.asarray(i[2].spin, np.float32) for i in inits])
    bits = np.random.default_rng(13).integers(
        0, 2 ** 32, (B, K_STEPS, 3, 1, Ntp), dtype=np.uint32)
    jscal = np.zeros((B, 4), np.float32)
    jscal[:, 0], jscal[:, 1] = (1.4, 0.6), 0.6
    st = [jnp.asarray(interop.pad(a, Lp)) for a in (rp0, rm0)] + \
        [jnp.asarray(interop.pad(a, Ntp)) for a in (pos0, spin0)] + \
        [jnp.zeros((B, Wp, Ntp), jnp.float32)]
    call = dict(wts=jnp.asarray(jfs.build_narrow_weights(jcfg)),
                solve_wts=jnp.asarray(solve_wts),
                fft_slab=jnp.asarray(jfs.build_fft_record_slab(jcfg, Lp)),
                L=L, n_t=N_T, window=WINDOW, dt=DT, dx=jcfg.dx,
                xlim=jcfg.xlim, periodic=True, m_mode="narrow",
                narrow_r=jfs._narrow_radius(jcfg), solve_mode=j_solve,
                solve_r=solve_r, bidirectional=True, has_noise=False,
                kmax_rec=kmax, interpret=True)
    dens, recs = [], []
    for n in range(K_STEPS):
        dens.append(np.asarray(st[0] + st[1])[:, :L])
        *st, rec = j_pde(
            jnp.asarray(jscal), jnp.zeros((B,), jnp.int32),
            jnp.full((B,), n, jnp.int32), *st, jnp.asarray(solve_mat),
            jnp.asarray(smooth_mat), k_steps=1,
            noise=jnp.asarray(bits[:, n:n + 1]), **call)
        recs.append(interop.pde_records(np.asarray(rec), kmax,
                                        device="cpu").numpy())
    return np.stack(dens, 1), np.concatenate(recs, 1)


def test_spectra_plain_matches_jax_kernel():
    """40 bins (past one pass of the step's warps: the separate kernel's
    route on the card) of the JAX kernel's own per-step densities: the
    plain spectra body, and the wrapper on CPU tensors, within the
    spectra tolerance of the kernel-logic test."""
    kmax = 40
    dens, jrecs = _jax_run(kmax)
    got = pde_spectra_plain(torch.tensor(dens), kmax).numpy()
    np.testing.assert_allclose(got, jrecs[..., 4:], rtol=1e-4, atol=1e-9)
    recs = torch.zeros((B, K_STEPS, 4 + 2 * kmax))
    pde_spectra(torch.tensor(dens), recs, kmax)
    np.testing.assert_array_equal(recs[..., 4:].numpy(), got)
    assert not recs[..., :4].any()
    assert pde_spectra.launches == 0 and np.abs(got).max() > 1e-3


@pytest.mark.parametrize("L_", [128, 99])
def test_spectra_plain_is_the_rfft(L_):
    """At the full L//2 + 1 bins (the ``IMEXPDE`` facade's default): numpy's
    rfft of the rows ÷ L, re and im, within float32's rounding of the
    sums."""
    rng = np.random.default_rng(L_)
    dens = rng.uniform(0.2, 1.8, (2, 5, L_)).astype(np.float32)
    kmax = L_ // 2 + 1
    got = pde_spectra_plain(torch.tensor(dens), kmax).numpy()
    X = np.fft.rfft(dens.astype(np.float64), axis=-1) / L_
    np.testing.assert_allclose(got, np.concatenate([X.real, X.imag], -1),
                               rtol=1e-4, atol=2e-7)
