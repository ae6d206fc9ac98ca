"""Implicit-diffusion solves for the IMEX PDE stepper.

The implicit step solves ``A x = ρ`` with ``A = I − γ·dt·D/dx²``, where D is
the second-difference operator (periodic corners or Neumann mirrors).

- ``identity``: γ = 0, A = I.
- ``dense``: ``A⁻¹`` built on the host in float64 and applied as an f32
  matmul — the plain version of the exact solve.
- ``spectral``: the same exact solve by a float64 FFT (``SpectralSolve``):
  periodic A is circulant, and a Neumann A is the circulant of the even
  extension of length 2(L − 1) — the plain version of the exact solve
  past ``DENSE_MAX_L``, where the (L, L) inverse would not fit the host.
- ``banded`` / ``banded_dct``: the rows of ``A⁻¹`` decay exponentially, so
  the solve is a symmetric banded circular convolution (``banded_kernel``,
  the JAX package's ``build_diffusion_op(kind='banded')``); ``banded_dct``
  applies it to the even extension (Neumann).
- tridiagonal factors: A is tridiagonal, plus two corner entries when
  periodic.  ``tridiag_factors`` factors it on the host in float64 (Thomas,
  with a Sherman–Morrison correction for the periodic corners); kernel B2
  applies them as two block scans of affine maps composed in float64 on f32
  fields (``csrc/pde_multi_step.cu``), and ``tridiag_solve`` applies them in
  torch as Thomas' sequential f32 recurrences, for testing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hydrolim_tpu_torch.ops.convolve import banded_circular_conv


def _second_difference(L: int, bc: str) -> np.ndarray:
    D = np.zeros((L, L), dtype=np.float64)
    idx = np.arange(L)
    D[idx, idx] = -2.0
    D[idx[:-1], idx[:-1] + 1] = 1.0
    D[idx[1:], idx[1:] - 1] = 1.0
    if bc == "periodic":
        D[0, -1] = D[-1, 0] = 1.0
    else:  # neumann mirror
        D[0, 1] = 2.0
        D[-1, -2] = 2.0
    return D


def build_dense_inverse(L: int, dx: float, dt: float, gamma: float,
                        bc: str, device="cuda") -> torch.Tensor:
    """(L, L) float32 ``A⁻¹`` (inverted in float64)."""
    A = np.eye(L) - float(gamma) * dt * _second_difference(L, bc) / dx ** 2
    return torch.tensor(np.linalg.inv(A), dtype=torch.float32, device=device)


# The largest L whose exact solve the plain version applies as the dense
# inverse (256 MB in float32); past it, ``spectral_solve``.
DENSE_MAX_L = 8192


@dataclasses.dataclass
class SpectralSolve:
    """The exact solve by FFT: ``symbol`` (n//2 + 1,) float64, the
    eigenvalues of A⁻¹ on the periodic lattice of n = L sites, or of the
    even extension of a Neumann one (n = 2(L − 1))."""

    symbol: torch.Tensor
    n: int
    neumann: bool


def spectral_solve(L: int, dx: float, dt: float, gamma: float, bc: str,
                   device="cuda") -> SpectralSolve:
    """``SpectralSolve`` of A = I − γ·dt·D/dx² (float64 symbol)."""
    n = L if bc == "periodic" else 2 * (L - 1)
    c = float(gamma) * dt / dx ** 2
    lam = 2.0 * np.cos(2.0 * np.pi * np.arange(n // 2 + 1) / n) - 2.0
    return SpectralSolve(torch.tensor(1.0 / (1.0 - c * lam),
                                      dtype=torch.float64, device=device),
                         n, bc != "periodic")


def banded_kernel(dx: float, dt: float, gamma: float) -> np.ndarray:
    """(2r+1,) float32 symmetric taps of the periodic ``A⁻¹``, w(d) at
    r + d, truncated where they fall below 1e-9 of the centre.  Computed
    from the circulant symbol at a probe size M0 that adapts to
    c = γ·dt/dx² (independent of L); raises ValueError when the taps do not
    decay within the probe."""
    c = float(gamma) * dt / dx ** 2
    est_r = int(21.0 * (np.sqrt(max(c, 0.0)) + 1.0))
    M0 = 1 << max(12, int(np.ceil(np.log2(8 * est_r))))
    if M0 > (1 << 20):
        raise ValueError(
            f"banded diffusion kernel radius ~{est_r} too wide "
            f"(c = {c:.3g}); use the exact solver or rescale dt/dx")
    lam = 2.0 * np.cos(2.0 * np.pi * np.arange(M0 // 2 + 1) / M0) - 2.0
    k = np.fft.irfft(1.0 / (1.0 - c * lam), n=M0)
    eps = 1e-9 * abs(k[0])
    nz = np.flatnonzero(np.abs(k[:M0 // 2]) >= eps)
    r = int(nz[-1]) if nz.size else 0
    if r >= M0 // 2 - 1:
        raise ValueError(
            f"banded diffusion kernel does not decay within the probe "
            f"(c = {c:.3g} too large); use the exact solver")
    w = np.concatenate([k[M0 - r:], k[:r + 1]]) if r else k[:1]
    return w.astype(np.float32)


def diffusion_solve(op, rho: torch.Tensor, kind: str) -> torch.Tensor:
    """Apply ``A⁻¹`` along the trailing axis (batched).  ``op`` is the
    operand of ``kind``: the dense inverse for 'dense', a
    ``SpectralSolve`` for 'spectral', the taps of :func:`banded_kernel`
    for 'banded' / 'banded_dct', unused for 'identity'."""
    if kind == "identity":
        return rho
    if kind == "dense":
        if rho.device.type == "cpu":
            # one matrix-vector product per row: a (rows, L)·(L, L) CPU
            # product sums in an order that depends on the row count, and
            # the ordered phase amplifies that last-bit difference (1.7e-4
            # relative in m after 120 steps at β = 2.4), so a batch split
            # into blocks would leave the whole batch's run
            flat = rho.reshape(-1, rho.shape[-1])
            return torch.stack([torch.mv(op, r) for r in flat]).reshape(
                rho.shape)
        return torch.matmul(rho, op.T)
    if kind == "spectral":
        x = rho.double()
        if op.neumann:
            x = torch.cat([x, x[..., 1:-1].flip(-1)], dim=-1)
        y = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * op.symbol, n=op.n,
                            dim=-1)
        return y[..., :rho.shape[-1]].to(rho.dtype)
    if kind == "banded":
        return banded_circular_conv(rho, op)
    if kind == "banded_dct":        # Neumann = periodic on the even extension
        even = torch.cat([rho, rho[..., 1:-1].flip(-1)], dim=-1)
        return banded_circular_conv(even, op)[..., :rho.shape[-1]]
    raise ValueError(f"unknown diffusion solve kind {kind!r}")


@dataclasses.dataclass
class TridiagFactors:
    """Float64-derived factors of ``A = (1+2c)I − c·D`` (c = γ·dt/dx²),
    stored in f32.

    ``rows`` is (4, L), read by ``tridiag_solve``: [1/pivot_i, c'_i, z_i,
    a_i] — the Thomas pivots and modified super-diagonal, the
    Sherman–Morrison column z and the magnitude a_i of row i's sub-diagonal
    (c, and 2c on the last Neumann row).  ``scan`` is (4, L) float64, the
    one table kernel B2 reads: [1/pivot_i, c'_i, α_i, z_i], α_i =
    a_i/pivot_i; the scan solve runs the forward sweep as y_i =
    α_i·y_{i−1} + ρ_i/pivot_i in float64 (f32 coefficients would cost it
    more accuracy than Thomas loses).  With y the Thomas solution of the
    tridiagonal part, the periodic solve is x = y − fac·(y_0 +
    v_last·y_{L−1})·z; the Neumann one is y (z = 0, fac = 0)."""

    rows: torch.Tensor     # (4, L) float32
    scan: torch.Tensor     # (4, L) float64
    periodic: bool
    v_last: float          # β/γ of the corner vector v = (1, 0, …, β/γ)
    fac: float             # 1 / (1 + v·z)


def _thomas_factors(diag, sup, sub):
    """Pivots 1/p_i and c'_i = sup_i/p_i of a tridiagonal (signed sub and
    super-diagonals; sub[0] and sup[-1] unused), in float64."""
    L = len(diag)
    inv, cp = np.zeros(L), np.zeros(L)
    inv[0] = 1.0 / diag[0]
    cp[0] = sup[0] * inv[0]
    for i in range(1, L):
        inv[i] = 1.0 / (diag[i] - sub[i] * cp[i - 1])
        cp[i] = sup[i] * inv[i] if i < L - 1 else 0.0
    return inv, cp


def _thomas(inv, cp, sub, d):
    d = np.array(d, dtype=np.float64)
    d[0] *= inv[0]
    for i in range(1, len(d)):
        d[i] = (d[i] - sub[i] * d[i - 1]) * inv[i]
    for i in range(len(d) - 2, -1, -1):
        d[i] -= cp[i] * d[i + 1]
    return d


def tridiag_factors(L: int, dx: float, dt: float, gamma: float, bc: str,
                    device="cuda") -> TridiagFactors:
    """The factors of the periodic (cyclic, with the Sherman–Morrison
    corner split) or Neumann (mirrored rows 0 and L−1) ``A``."""
    assert L >= 3, L
    c = float(gamma) * dt / dx ** 2
    diag = np.full(L, 1.0 + 2.0 * c)
    sub = np.full(L, -c)
    sup = np.full(L, -c)
    z = np.zeros(L)
    v_last = fac = 0.0
    if bc == "periodic":
        gam = -diag[0]                    # Sherman–Morrison split
        alpha = beta = -c                 # A[L-1, 0], A[0, L-1]
        diag[0] -= gam
        diag[-1] -= alpha * beta / gam
        inv, cp = _thomas_factors(diag, sup, sub)
        u = np.zeros(L)
        u[0], u[-1] = gam, alpha
        z = _thomas(inv, cp, sub, u)
        v_last = beta / gam
        fac = 1.0 / (1.0 + z[0] + v_last * z[-1])
    else:
        sup[0] = sub[-1] = -2.0 * c       # the mirrored neighbours
        inv, cp = _thomas_factors(diag, sup, sub)
    rows = torch.tensor(np.stack([inv, cp, z, -sub]), dtype=torch.float32,
                        device=device)
    scan = torch.tensor(np.stack([inv, cp, -sub * inv, z]),
                        dtype=torch.float64, device=device)
    return TridiagFactors(rows=rows, scan=scan, periodic=bc == "periodic",
                          v_last=v_last, fac=fac)


def tridiag_solve(f: TridiagFactors, rho: torch.Tensor) -> torch.Tensor:
    """Apply the factors in f32 along the trailing axis (batched) — the same
    recurrences kernel B2 runs, one site at a time."""
    inv, cp, z, a = f.rows
    L = rho.shape[-1]
    d = list(rho.unbind(-1))
    d[0] = d[0] * inv[0]
    for i in range(1, L):
        d[i] = (d[i] + a[i] * d[i - 1]) * inv[i]
    for i in range(L - 2, -1, -1):
        d[i] = d[i] - cp[i] * d[i + 1]
    y = torch.stack(d, dim=-1)
    if not f.periodic:
        return y
    coef = f.fac * (y[..., :1] + f.v_last * y[..., -1:])
    return y - coef * z
