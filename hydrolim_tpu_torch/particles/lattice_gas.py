"""Frame records of the site-centric lattice-gas engines.

The per-frame observables shared by the slot engines (the JAX package's
``particles/lattice_gas.py``): densities, local and global m, the
lattice variance and the amplitude spectrum, computed from per-site counts
on the device.  The K = 1 stepper ``lg_step`` is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleConfig
from hydrolim_tpu_torch.fields.magnetization import MFieldOp, local_m_field

# Invalid-tracer sentinel for ``LatticeGasFrames.tracer_pos``.  Unwrapped
# positions are signed (a net-leftward walker crosses 0), so validity cannot
# ride the sign bit: INT32_MIN is outside every reachable position.
TRACER_INVALID = np.int32(np.iinfo(np.int32).min)


def tracer_valid_mask(tracer_pos):
    """Boolean mask of real (non-phantom) tracer entries: a tensor on the
    tensor's device for a torch tensor, else a numpy array."""
    if isinstance(tracer_pos, torch.Tensor):
        return tracer_pos != int(TRACER_INVALID)
    return np.asarray(tracer_pos) != TRACER_INVALID


class LatticeGasFrames(NamedTuple):
    rho_p: object       # (..., L)
    rho_m: object       # (..., L)
    total: object       # (..., L)
    m_local: object     # (..., L)
    m_global: object    # (...,)
    var: object         # (...,)
    fft_amp: object     # (..., L) or (..., 0)
    tracer_pos: object  # (..., n_t) unwrapped sites (TRACER_INVALID = phantom)


def _lg_record_counts(config: ParticleConfig, mfield_op: MFieldOp,
                      counts_p: torch.Tensor, counts_m: torch.Tensor,
                      record_fft: bool) -> LatticeGasFrames:
    """Frame observables from float32 per-site counts (leading dims batch).
    The variance and the spectrum are taken in float64 and rounded once."""
    n_alive = (counts_p.sum(-1) + counts_m.sum(-1)).clamp(min=1.0)
    denom = n_alive[..., None] * torch.tensor(config.dx, dtype=torch.float32,
                                              device=counts_p.device)
    rho_p = counts_p / denom
    rho_m = counts_m / denom
    total = rho_p + rho_m
    m_local = local_m_field(counts_p, counts_m, mfield_op,
                            sigma=config.local_kernel_sigma,
                            sigma_grid=config.sigma_grid,
                            periodic=config.periodic)
    m_global = (counts_p.sum(-1) - counts_m.sum(-1)) / n_alive
    var = total.to(torch.float64).var(-1, unbiased=False).to(torch.float32)
    if record_fft:
        L = config.L
        amp_h = torch.fft.rfft(total.to(torch.float64)).abs().to(
            torch.float32)
        # mirror to the full L-point amplitude spectrum like the recorder
        amp = torch.cat([amp_h, amp_h[..., 1:(L + 1) // 2].flip(-1)], dim=-1)
    else:
        amp = total.new_zeros(total.shape[:-1] + (0,))
    return LatticeGasFrames(
        rho_p=rho_p, rho_m=rho_m, total=total, m_local=m_local,
        m_global=m_global, var=var, fft_amp=amp,
        tracer_pos=torch.zeros(total.shape[:-1] + (0,), dtype=torch.int32,
                               device=total.device))
