"""Frozen operation and byte counts of the port's kernels, and the card's
published peaks: the yardstick of the roofline shares.

Each count is the fewest operations or bytes of the algorithm, not of one
implementation, so a later change that replaces a kernel leaves it as it
is.  Bytes count each input read once and each output written once;
operations count an FMA as two.  The functions are copies of the counts
that ``chip_smoke.py`` prints (``b1_rate``'s bound, ``spectra_ops``,
``circulant_ops``, ``b2_step_bound``), taking plain numbers in place of the
program's objects; ``portbench/tests/test_portbench_counts.py`` holds them
equal.
"""
from __future__ import annotations

import math
from typing import Optional

# NVIDIA's H100 SXM data sheet, at 700 W: HBM3 bandwidth and the float32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def b1_bound(B: int, N: int, k: int) -> dict:
    """Kernel B1, one call of k steps of B replicas of N particles: per
    particle-step the uniform's scale and four threshold compares, per
    replica-step two exponentials and their scaling; the state (pos, σ,
    winding: 12 bytes a particle) in and out and the scalars in."""
    return bound(6 * 4 * B * N + 16 * B, k * (5 * B * N + 4 * B))


def spectra_ops(rows: int, L: int, kmax: int) -> float:
    """The fewest operations for the first kmax rfft bins of ``rows`` real
    rows of L: the direct sum (2·L·2·kmax) or a real FFT's 5/2·L·log2 L,
    whichever is smaller."""
    return rows * min(4.0 * L * kmax, 2.5 * L * math.log2(L))


def spectra_bound(rows: int, L: int, kmax: int) -> dict:
    """The spectra kernel, one call: the density rows read and the bins
    written (``chip_smoke.py``'s count at the large calls; the trig table
    is the implementation's, not the algorithm's), ``spectra_ops``."""
    return bound(4 * rows * (L + 2 * kmax), spectra_ops(rows, L, kmax))


def circulant_ops(L: int, r: int) -> float:
    """The fewest operations for one symmetric circular convolution of a
    real field of L sites by 2r+1 taps: the direct sum with each pair of
    taps folded (3r + 1 a site) or a real FFT there and back with the
    taps' real spectrum between, whichever is smaller."""
    return min((3.0 * r + 1.0) * L, 5.0 * L * math.log2(L) + L)


def b2_step_parts(L: int, n_t: int, window: int, kmax: int, B: int, k: int,
                  smooth_r: Optional[int] = None,
                  solve_r: Optional[int] = None) -> dict:
    """Kernel B2, one call of k steps of B replicas: bytes (the fields,
    tracers and ring in and out, the records out) and operations per
    replica-step (~30 a site: m, advection, reaction, the solve, clip,
    renormalisation; ~24 a tracer; both fields through the smoothing's
    circulant of radius ``smooth_r`` and the banded solve's of radius
    ``solve_r``, where the mode has them), and the spectra's operations
    apart."""
    per_step = 30.0 * L + 24.0 * n_t
    if smooth_r is not None:
        per_step += 2 * circulant_ops(L, smooth_r)
    if solve_r is not None:
        per_step += 2 * circulant_ops(L, solve_r)
    n_bytes = 4 * (2 * 2 * B * L + 2 * 3 * B * n_t + 2 * B * window * n_t
                   + B * k * (4 + 2 * kmax))
    return dict(bytes=n_bytes, step_ops=k * B * per_step,
                spectra_ops=spectra_ops(k * B, L, kmax))


def b2_step_bound(L: int, n_t: int, window: int, kmax: int, B: int, k: int,
                  smooth_r: Optional[int] = None,
                  solve_r: Optional[int] = None) -> dict:
    """``chip_smoke.py``'s B2 bound of one call: the step's and the
    spectra's operations together."""
    p = b2_step_parts(L, n_t, window, kmax, B, k, smooth_r, solve_r)
    return bound(p["bytes"], p["step_ops"] + p["spectra_ops"])


def b2_kernel_bound(L: int, n_t: int, window: int, kmax: int, B: int,
                    k: int, smooth_r: Optional[int] = None,
                    solve_r: Optional[int] = None) -> dict:
    """The part of ``b2_step_bound`` that B2's step kernels do: the
    spectra's operations are the spectra kernel's (``spectra_bound``)."""
    p = b2_step_parts(L, n_t, window, kmax, B, k, smooth_r, solve_r)
    return bound(p["bytes"], p["step_ops"])
