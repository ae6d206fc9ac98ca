"""PDE magnetization field (IMEX_PDE_solver_class.py:154-166 semantics).

Pointwise (ρ₊−ρ₋)/(ρ₊+ρ₋) without a kernel, and the global scalar above
the σ > 1e5 sentinel.  Kernel smoothing below the sentinel is not ported
yet.
"""
from __future__ import annotations

import torch


def pde_magnetization(rho_p: torch.Tensor, rho_m: torch.Tensor,
                      gaussian_kernel: bool, *, kernel_sigma: float,
                      global_sentinel: float = 1e5) -> torch.Tensor:
    """Batched over leading dims; trailing axis is the lattice."""
    num = rho_p - rho_m
    den = rho_p + rho_m
    if not gaussian_kernel:
        return num / (den + 1e-12)
    if kernel_sigma > global_sentinel:
        g = num.sum(-1, keepdim=True) / (den.sum(-1, keepdim=True) + 1e-12)
        return g.expand(num.shape)
    raise NotImplementedError(
        "kernel-smoothed PDE magnetization is not ported yet")
