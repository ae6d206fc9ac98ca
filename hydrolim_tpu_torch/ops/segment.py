"""Occupancy / density scatter-adds."""
from __future__ import annotations

import torch


def masked_bincount(pos: torch.Tensor, weights: torch.Tensor,
                    L: int) -> torch.Tensor:
    """Per-site sum of ``weights`` at lattice index ``pos`` along the
    trailing particle axis (leading dims batch).  Indices outside [0, L)
    are dropped, never wrapped and never spilled into a neighbouring
    batch row."""
    out_shape = pos.shape[:-1] + (L,)
    flat_pos = pos.reshape(-1, pos.shape[-1]).long()
    flat_w = weights.reshape(-1, pos.shape[-1])
    in_range = (flat_pos >= 0) & (flat_pos < L)
    flat_pos = torch.where(in_range, flat_pos, torch.zeros_like(flat_pos))
    flat_w = torch.where(in_range, flat_w, torch.zeros_like(flat_w))
    out = torch.zeros((flat_pos.shape[0], L), dtype=weights.dtype,
                      device=weights.device)
    out.scatter_add_(1, flat_pos, flat_w)
    return out.reshape(out_shape)


def occupancy(pos: torch.Tensor, sigma: torch.Tensor, alive: torch.Tensor,
              L: int):
    """(occ_total, counts_p, counts_m) per site, float32, batched over the
    leading dims: the reference's occupancy builder with an alive mask
    (dead particles weigh 0)."""
    a = alive.to(torch.float32)
    counts_p = masked_bincount(pos, a * (sigma > 0), L)
    counts_m = masked_bincount(pos, a * (sigma < 0), L)
    return counts_p + counts_m, counts_p, counts_m
