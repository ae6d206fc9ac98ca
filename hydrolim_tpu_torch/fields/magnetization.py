"""Local/global magnetization fields.

Particle side: ``local_m_field`` — m(x) = smoothed(counts₊ − counts₋) /
smoothed(counts₊ + counts₋), clipped to [−1, 1]; σ ≤ 0 broadcasts the
global magnetization; periodic smoothing is a circular convolution with the
torus Gaussian (``torch.fft``, in float64), non-periodic a reflect-mode
Gaussian filter (``ops.convolve``).

PDE side: ``pde_magnetization`` (IMEX_PDE_solver_class.py:154-166
semantics): pointwise (ρ₊−ρ₋)/(ρ₊+ρ₋) without a kernel, the global scalar
above the σ > 1e5 sentinel, and below it the ratio of the smoothed
numerator and denominator (the full periodic circulant, no clip).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hydrolim_tpu_torch.core.device import to_device
from hydrolim_tpu_torch.ops.convolve import (
    gaussian_filter_weights,
    periodic_gaussian_kernel,
    reflect_gaussian_filter,
)


class MFieldOp(NamedTuple):
    """The periodic smoothing kernel's rfft (complex128), or None where
    there is none to apply (σ ≤ 0, or the non-periodic reflect filter);
    the reflect filter's weights (float32) where that is the smoothing."""

    kernel_rfft: Optional[torch.Tensor]
    reflect_w: Optional[torch.Tensor] = None


def build_mfield_op(L: int, dx: float, sigma: float, periodic: bool,
                    device="cuda") -> MFieldOp:
    if sigma > 0 and periodic:
        k = periodic_gaussian_kernel(L, dx, sigma).astype(np.float64)
        return MFieldOp(torch.fft.rfft(to_device(k, device)))
    if sigma > 0:
        return MFieldOp(None, to_device(gaussian_filter_weights(sigma / dx),
                                        device))
    return MFieldOp(None)


def _circular_convolve(x: torch.Tensor, kernel_rfft: torch.Tensor
                       ) -> torch.Tensor:
    """out[j] = Σ_i x[i]·k[j−i] on the trailing axis, taken in float64 and
    returned in float32."""
    y = torch.fft.irfft(torch.fft.rfft(x.to(torch.float64)) * kernel_rfft,
                        n=x.shape[-1])
    return y.to(torch.float32)


def local_m_field(counts_p: torch.Tensor, counts_m: torch.Tensor,
                  op: MFieldOp, *, sigma: float, sigma_grid: float,
                  periodic: bool) -> torch.Tensor:
    """Batched over leading dims; trailing axis is the lattice."""
    s = counts_p - counts_m
    tot = counts_p + counts_m
    if sigma <= 0:
        m_global = s.sum(-1, keepdim=True) / tot.sum(-1, keepdim=True).clamp(
            min=1e-12)
        return m_global.expand(s.shape)
    if periodic:
        s_conv = _circular_convolve(s, op.kernel_rfft)
        tot_conv = _circular_convolve(tot, op.kernel_rfft)
    else:
        s_conv = reflect_gaussian_filter(s, sigma_grid, w=op.reflect_w)
        tot_conv = reflect_gaussian_filter(tot, sigma_grid, w=op.reflect_w)
    pos = tot_conv > 0
    m = torch.where(pos, s_conv / torch.where(pos, tot_conv, 1.0), 0.0)
    return m.clamp(-1.0, 1.0)


def pde_magnetization(rho_p: torch.Tensor, rho_m: torch.Tensor,
                      smooth: Optional[MFieldOp], *, kernel_sigma: float,
                      global_sentinel: float = 1e5) -> torch.Tensor:
    """Batched over leading dims; trailing axis is the lattice.  ``smooth``
    is None without a kernel (pointwise m); otherwise the periodic kernel's
    operand (``build_mfield_op``), unused above the sentinel (global m)."""
    num = rho_p - rho_m
    den = rho_p + rho_m
    if smooth is None:
        return num / (den + 1e-12)
    if kernel_sigma > global_sentinel:
        g = num.sum(-1, keepdim=True) / (den.sum(-1, keepdim=True) + 1e-12)
        return g.expand(num.shape)
    both = _circular_convolve(torch.stack([num, den], dim=-2),
                              smooth.kernel_rfft)
    return both[..., 0, :] / (both[..., 1, :] + 1e-12)
