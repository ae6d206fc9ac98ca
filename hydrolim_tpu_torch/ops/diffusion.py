"""Implicit-diffusion solves for the IMEX PDE stepper.

The implicit step solves ``A x = ρ`` with ``A = I − γ·dt·D/dx²``, where D is
the second-difference operator (periodic corners or Neumann mirrors).

- ``identity``: γ = 0, A = I.
- ``dense``: ``A⁻¹`` built on the host in float64 and applied as an f32
  matmul — the plain version of the solve.
- cyclic tridiagonal factors: the periodic A is tridiagonal plus two corner
  entries.  ``cyclic_tridiag_factors`` factors it on the host in float64
  (Thomas with a Sherman–Morrison correction for the corners); kernel B2
  applies the factors in f32 (``csrc/pde_multi_step.cu``), and
  ``cyclic_tridiag_solve`` applies them in torch for testing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def diffusion_solve(a_inv: torch.Tensor, rho: torch.Tensor,
                    kind: str) -> torch.Tensor:
    """Apply ``A⁻¹`` along the trailing axis (batched): ``kind`` is
    'identity' or 'dense' (``a_inv`` from :func:`build_dense_inverse`)."""
    if kind == "identity":
        return rho
    if kind == "dense":
        return torch.matmul(rho, a_inv.T)
    raise NotImplementedError(f"diffusion solve kind {kind!r} is not ported")


@dataclasses.dataclass
class CyclicTridiagFactors:
    """Float64-derived factors of the periodic ``A = (1+2c)I − c·(S + Sᵀ)``,
    c = γ·dt/dx², stored in f32.

    ``rows`` is (3, L): [1/pivot_i, c'_i, z_i] — the Thomas pivots and
    modified super-diagonal of the corner-reduced tridiagonal B, and
    z = B⁻¹u, the Sherman–Morrison column.  With y = B⁻¹ρ,
    x = y − fac·(y_0 + v_last·y_{L−1})·z."""

    rows: torch.Tensor     # (3, L) float32
    c: float               # off-diagonal magnitude γ·dt/dx²
    v_last: float          # β/γ of the corner vector v = (1, 0, …, β/γ)
    fac: float             # 1 / (1 + v·z)


def cyclic_tridiag_factors(L: int, dx: float, dt: float, gamma: float,
                           device="cuda") -> CyclicTridiagFactors:
    assert L >= 3, L
    c = float(gamma) * dt / dx ** 2
    b = 1.0 + 2.0 * c
    gam = -b                              # Sherman–Morrison split
    alpha = beta = -c                     # A[L-1, 0], A[0, L-1]
    diag = np.full(L, b)
    diag[0] -= gam
    diag[-1] -= alpha * beta / gam
    sub = -c                              # a_i (i >= 1) and c_i (i <= L-2)

    inv = np.zeros(L)
    cp = np.zeros(L)
    inv[0] = 1.0 / diag[0]
    cp[0] = sub * inv[0]
    for i in range(1, L):
        inv[i] = 1.0 / (diag[i] - sub * cp[i - 1])
        cp[i] = sub * inv[i] if i < L - 1 else 0.0

    def thomas(d):
        d = np.array(d, dtype=np.float64)
        d[0] *= inv[0]
        for i in range(1, L):
            d[i] = (d[i] - sub * d[i - 1]) * inv[i]
        for i in range(L - 2, -1, -1):
            d[i] -= cp[i] * d[i + 1]
        return d

    u = np.zeros(L)
    u[0], u[-1] = gam, alpha
    z = thomas(u)
    v_last = beta / gam
    fac = 1.0 / (1.0 + z[0] + v_last * z[-1])
    rows = torch.tensor(np.stack([inv, cp, z]), dtype=torch.float32,
                        device=device)
    return CyclicTridiagFactors(rows=rows, c=c, v_last=v_last, fac=fac)


def cyclic_tridiag_solve(f: CyclicTridiagFactors,
                         rho: torch.Tensor) -> torch.Tensor:
    """Apply the factors in f32 along the trailing axis (batched) — the same
    recurrences kernel B2 runs, one site at a time."""
    inv, cp, z = f.rows[0], f.rows[1], f.rows[2]
    L = rho.shape[-1]
    d = list(rho.unbind(-1))
    d[0] = d[0] * inv[0]
    for i in range(1, L):
        d[i] = (d[i] + f.c * d[i - 1]) * inv[i]
    for i in range(L - 2, -1, -1):
        d[i] = d[i] - cp[i] * d[i + 1]
    y = torch.stack(d, dim=-1)
    coef = f.fac * (y[..., :1] + f.v_last * y[..., -1:])
    return y - coef * z
