"""Batched estimator suite on the device.

The five reference estimators (``..._sweep_beta.py:123-229,500-525``) for
every replica at once over batch-leading frame arrays, with the
measurement window as a per-replica frame mask, as the JAX package's
``observables/batched.py`` computes them (float32):

- v_eff: d⟨x⟩/dt of the density centre of mass, masked mean over the
  window;
- mean magnetization over the window;
- rho_eff, the front density;
- the blocking probability;
- D_eff, the displacement-variance slope over stable tracer slots, as a
  masked least-squares slope (NaN where undefined).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BatchedEstimates(NamedTuple):
    v_eff: torch.Tensor      # (B,)
    D_eff: torch.Tensor      # (B,)  nan when undefined
    m_mean: torch.Tensor     # (B,)
    rho_eff: torch.Tensor    # (B,)
    p_block: torch.Tensor    # (B,)
    start_idx: torch.Tensor  # (B,) int32
    end_idx: torch.Tensor    # (B,) int32


def _grid(L: int, xlim: float, device) -> torch.Tensor:
    return torch.linspace(0.0, xlim, L, dtype=torch.float64,
                          device=device).to(torch.float32)


def _window_mask(total: torch.Tensor, *, xlim: float, window_mode: str,
                 boundary_xmin_frac: float = 0.99,
                 max_boundary_fraction: float = 0.06,
                 min_window_fraction: float = 0.10):
    """Per-replica window (start, end) and the (B, M) frame mask."""
    B, M, L = total.shape
    x = _grid(L, xlim, total.device)
    dx = x[1] - x[0]
    bmask = (x >= boundary_xmin_frac * xlim).to(torch.float32)
    boundary_mass = (total * bmask).sum(-1) * dx                 # (B, M)
    N_t = total.sum(-1) * dx
    unsafe = boundary_mass / (N_t + 1e-12) >= max_boundary_fraction

    start = int(0.65 * M)
    min_len = max(3, int(min_window_fraction * M))
    if window_mode == "legacy":
        # collapse to min_len only when the unsafe-frame COUNT exceeds 0.65·M
        count_unsafe = unsafe.sum(-1)
        end = torch.where(count_unsafe > start, min(M, start + min_len), M)
    elif window_mode == "strict":
        tail = unsafe[:, start:]
        first = tail.to(torch.int32).argmax(-1)
        end = torch.where(tail.any(-1), start + first, M)
        end = end.clamp(min=min(M, start + min_len))
    else:
        raise ValueError(window_mode)
    idx = torch.arange(M, device=total.device)
    mask = (idx[None, :] >= start) & (idx[None, :] < end[:, None])
    return start, end.to(torch.int32), mask


def batched_estimates(total, m_global, rho_p, times,
                      pos: Optional[torch.Tensor] = None,
                      alive: Optional[torch.Tensor] = None, *,
                      dx: float, xlim: float = 1.0,
                      window_mode: str = "legacy",
                      rho_window: float = 0.05,
                      has_positions: bool = True) -> BatchedEstimates:
    """All five reference estimators over the batch axis.

    Args:
      total/rho_p: (B, M, L) density frames; m_global: (B, M); times: (M,);
      pos/alive: (B, M, n) unwrapped tracer positions and validity
        (required for D_eff unless ``has_positions=False``).
    Tensors may be numpy arrays; results lie on ``total``'s device.
    """
    f32 = torch.float32
    total = torch.as_tensor(total).to(f32)
    dev = total.device
    B, M, L = total.shape
    as_f32 = lambda a: torch.as_tensor(a).to(device=dev, dtype=f32)
    start, end, mask = _window_mask(total, xlim=float(xlim),
                                    window_mode=window_mode)
    maskf = mask.to(f32)
    n_mask = maskf.sum(-1).clamp(min=1.0)
    t = as_f32(times)

    # v_eff
    x = _grid(L, float(xlim), dev)
    mean_x = (total * x).sum(-1) / (total.sum(-1) + 1e-12)
    v_ts = torch.gradient(mean_x, spacing=(t,), dim=-1)[0]
    v_eff = (v_ts * maskf).sum(-1) / n_mask

    # mean magnetization
    m_mean = (as_f32(m_global) * maskf).sum(-1) / n_mask

    # rho_eff, the front density
    occ = total > 0
    any_occ = occ.any(-1)                                        # (B, M)
    idx_max = (L - 1) - occ.flip(-1).to(torch.int32).argmax(-1)
    x_max = x[idx_max]                                           # (B, M)
    in_win = ((x[None, None, :] >= x_max[..., None] - rho_window)
              & (x[None, None, :] <= x_max[..., None]))
    # the reference integrates on its linspace grid: dx_grid = xlim/(L-1)
    dx_grid = x[1] - x[0]
    frame_val = (total * in_win).sum(-1) * dx_grid / rho_window
    frame_ok = (any_occ & (in_win.sum(-1) > 0)).to(f32) * maskf
    n_ok_frames = frame_ok.sum(-1)
    rho_eff = torch.where(
        n_ok_frames > 0,
        (frame_val * frame_ok).sum(-1) / n_ok_frames.clamp(min=1e-12),
        torch.nan)

    # blocking probability
    rp = as_f32(rho_p)[..., :-1]
    nxt = total[..., 1:]
    attempts = (rp * maskf[..., None]).sum((-2, -1))
    blocked = (rp * (nxt >= 1.0) * maskf[..., None]).sum((-2, -1))
    p_block = torch.where(attempts > 0, blocked / attempts, 0.0)

    # D_eff, the displacement-variance slope
    if has_positions and pos is not None:
        posf = as_f32(pos) * dx                                  # (B, M, n)
        al = torch.as_tensor(alive).to(device=dev, dtype=torch.bool)
        p0 = posf[:, start]
        a0 = al[:, start]
        ok = a0[:, None, :] & al
        okf = ok.to(f32)
        n_ok = okf.sum(-1)                                       # (B, M)
        r = (posf - p0[:, None, :]) * okf
        r_mean = r.sum(-1) / n_ok.clamp(min=1.0)
        S = (((posf - p0[:, None, :]) - r_mean[..., None]) ** 2 * okf).sum(
            -1) / (n_ok - 1.0).clamp(min=1.0)                    # (B, M)
        idx = torch.arange(M, device=dev)
        fmask = ((idx[None, :] > start) & (idx[None, :] < end[:, None])
                 & (n_ok >= 2)).to(f32)
        t_rel = t - t[start]
        w_sum = fmask.sum(-1).clamp(min=1.0)
        t_bar = (t_rel * fmask).sum(-1) / w_sum
        S_bar = (S * fmask).sum(-1) / w_sum
        cov = ((t_rel[None, :] - t_bar[:, None]) * (S - S_bar[:, None])
               * fmask).sum(-1)
        var = ((t_rel[None, :] - t_bar[:, None]) ** 2 * fmask).sum(-1)
        D_eff = torch.where(fmask.sum(-1) >= 2, cov / var.clamp(min=1e-30),
                            torch.nan)
    else:
        D_eff = torch.full((B,), torch.nan, dtype=f32, device=dev)

    return BatchedEstimates(
        v_eff=v_eff, D_eff=D_eff, m_mean=m_mean, rho_eff=rho_eff,
        p_block=p_block,
        start_idx=torch.full((B,), start, dtype=torch.int32, device=dev),
        end_idx=end)
