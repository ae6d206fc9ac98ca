"""Smoothing convolutions for the magnetization field.

The weights are built on the host in numpy, exactly as the JAX package
builds them (``hydrolim_tpu/ops/convolve.py``):

- periodic: a normalised Gaussian on the torus, centred at site 0;
- non-periodic: ``scipy.ndimage.gaussian_filter1d(mode='reflect')``'s
  weights (radius int(4σ + 0.5)), applied to a half-sample symmetric
  (reflect) padding of the trailing axis.

The filter runs in torch on the trailing axis, batched over leading dims.
"""
from __future__ import annotations

import numpy as np
import torch


def periodic_gaussian_kernel(L: int, dx: float, sigma: float) -> np.ndarray:
    """Normalised Gaussian on the torus, centred at site 0 (float32)."""
    j = np.arange(L)
    dist = np.minimum(j, L - j) * dx
    kernel = np.exp(-0.5 * (dist / sigma) ** 2)
    return (kernel / kernel.sum()).astype(np.float32)


def gaussian_filter_weights(sigma_grid: float,
                            truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d weights (normalised, radius 4σ)."""
    radius = int(truncate * sigma_grid + 0.5)
    xs = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (xs / sigma_grid) ** 2)
    return (w / w.sum()).astype(np.float32)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Half-sample symmetric padding (scipy mode='reflect') of the trailing
    axis, for pad widths larger than the axis too."""
    while pad > 0:
        p = min(pad, x.shape[-1])
        x = torch.cat([x[..., :p].flip(-1), x, x[..., -p:].flip(-1)], dim=-1)
        pad -= p
    return x


def reflect_gaussian_filter(x: torch.Tensor, sigma_grid: float,
                            truncate: float = 4.0,
                            w: torch.Tensor = None) -> torch.Tensor:
    """``gaussian_filter1d(x, sigma_grid, mode='reflect')`` on the trailing
    axis in float32: the weighted sum of the 2r+1 windows of the
    reflect-padded signal (the weights are symmetric, so correlation and
    convolution agree).  ``w``: the weights already on the device
    (``gaussian_filter_weights(sigma_grid, truncate)``)."""
    if w is None:
        w = torch.tensor(gaussian_filter_weights(sigma_grid, truncate),
                         device=x.device)
    radius = (w.shape[0] - 1) // 2
    xp = reflect_pad(x.to(torch.float32), radius)
    return (xp.unfold(-1, w.shape[0], 1) * w).sum(-1)


def banded_circular_conv(x: torch.Tensor, w) -> torch.Tensor:
    """Periodic banded convolution with a centred symmetric kernel ``w``
    ((2r+1,), w(d) at r + d, r < L) on the trailing axis, batched: the
    weighted sum of the 2r+1 windows of the wrap-padded signal, in
    float32."""
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    r = (w.shape[0] - 1) // 2
    L = x.shape[-1]
    assert r < L, "banded kernel wider than the lattice"
    xf = x.to(torch.float32)
    xp = torch.cat([xf[..., L - r:], xf, xf[..., :r]], dim=-1) if r else xf
    return (xp.unfold(-1, w.shape[0], 1) * w).sum(-1)
