"""Converters from the JAX package's objects, given as numpy arrays, to the
port's — and back where the JAX kernels need their own layouts.

The JAX package's TPU kernels keep particles in (B, ⌈n/128⌉, 128) int32
lanes (σ = 0 padding), PDE fields in (B, Lp) lanes, tracers in (B, Ntp) and
their ring in (B, Wp, Ntp), and exclusion slots in (B, Kp, Lp) (B3) or
(B, K, Lp) (B4), all zero-padded; the port keeps the unpadded (B, n),
(B, L), (B, n_t), (B, window, n_t) and (B, K, L).  Random bits are uint32
there and int32 (same bits) here.  Nothing here imports ``jax``: pass
``np.asarray`` of JAX arrays.  Converters to torch place their result on
``device``, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from hydrolim_tpu_torch.core.config import ParticleParams, PDEParams
from hydrolim_tpu_torch.particles.stepper import ParticleState
from hydrolim_tpu_torch.pde.stepper import TracerState

LANE = 128


def to_torch(x, dtype: torch.dtype, device="cuda") -> torch.Tensor:
    """numpy → contiguous torch; uint32 bits are reinterpreted as int32."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device).to(dtype)


def particle_params(p, device="cuda") -> ParticleParams:
    """A JAX ``ParticleParams`` (any object with its fields) → the port's."""
    f = lambda v: to_torch(np.asarray(v, np.float32), torch.float32, device)
    return ParticleParams(beta=f(p.beta), rate_diffusion=f(p.rate_diffusion),
                          rate_active=f(p.rate_active), k_on=f(p.k_on),
                          k_off=f(p.k_off), k_exit=f(p.k_exit))


def pde_params(p, device="cuda") -> PDEParams:
    """A JAX ``PDEParams`` → the port's."""
    f = lambda v: to_torch(np.asarray(v, np.float32), torch.float32, device)
    return PDEParams(gamma=f(p.gamma), lam=f(p.lam), beta=f(p.beta))


def particle_state(st, device="cuda") -> ParticleState:
    """A JAX ``ParticleState`` (one replica, (n_buf,) arrays, or a vmapped
    batch, (B, n_buf)) → the port's batched (B, n_buf) state: pos, σ,
    wind and the birth sites ``init_bin`` int32, alive and bound bool, and
    the exit log (count (B,) int32, times (B, E) float32, sites and birth
    sites (B, E) int32).  The JAX state's PRNG key has no counterpart
    here: the draws of a JAX run are rebuilt from it where a test needs
    them."""
    pos = np.asarray(st.pos)
    b = (lambda a: np.asarray(a)) if pos.ndim == 2 \
        else (lambda a: np.asarray(a)[None])
    i32 = lambda a: to_torch(b(a).astype(np.int32), torch.int32, device)
    bool_ = lambda a: to_torch(b(a).astype(bool), torch.bool, device)
    return ParticleState(
        pos=i32(st.pos), sigma=i32(st.sigma), wind=i32(st.wind),
        alive=bool_(st.alive), bound=bool_(st.bound),
        init_bin=i32(st.init_bin), exit_count=i32(st.exit_count),
        exit_times=to_torch(b(st.exit_times).astype(np.float32),
                            torch.float32, device),
        exit_pos=i32(st.exit_pos), exit_init_bin=i32(st.exit_init_bin))


# ---------------------------------------------------------------------------
# particle lanes (ops/pallas_stepper.py layout)
# ---------------------------------------------------------------------------

def lanes_to_rows(x, n: int, device="cuda") -> torch.Tensor:
    """(B, R, 128) lanes → (B, n) int32, dropping the padding lanes."""
    a = np.asarray(x)
    return to_torch(a.reshape(a.shape[0], -1)[:, :n], torch.int32, device)


def rows_to_lanes(x) -> np.ndarray:
    """(B, n) → (B, ⌈n/128⌉, 128) int32 lanes with zero (σ = 0) padding."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.int32)
    B, n = a.shape
    R = -(-n // LANE)
    return np.pad(a, ((0, 0), (0, R * LANE - n))).reshape(B, R, LANE)


def meanfield_noise(bits, n: int, device="cuda") -> torch.Tensor:
    """(B, k, R, 128) uint32 kernel bits → (B, k, n) int32."""
    a = np.asarray(bits, np.uint32)
    B, k = a.shape[:2]
    return to_torch(a.reshape(B, k, -1)[:, :, :n], torch.int32, device)


# ---------------------------------------------------------------------------
# PDE lanes (ops/pallas_pde.py layout)
# ---------------------------------------------------------------------------

def unpad(x, *sizes: int, device="cuda") -> torch.Tensor:
    """Slice the trailing dims of a padded float array to ``sizes``."""
    a = np.asarray(x, np.float32)
    idx = (Ellipsis,) + tuple(slice(0, s) for s in sizes)
    return to_torch(a[idx], torch.float32, device)


def pad(x, *sizes: int) -> np.ndarray:
    """Zero-pad the trailing dims of a (port) array to ``sizes``."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32)
    widths = [(0, 0)] * (a.ndim - len(sizes)) + [
        (0, s - d) for s, d in zip(sizes, a.shape[a.ndim - len(sizes):])]
    return np.pad(a, widths)


def pde_noise(bits, n_t: int, device="cuda") -> torch.Tensor:
    """(G, k, 3, R, Ntp) uint32 kernel bits → (G·R, k, 3, n_t) int32."""
    a = np.asarray(bits, np.uint32)
    G, k, _, R, Ntp = a.shape
    a = a.transpose(0, 3, 1, 2, 4).reshape(G * R, k, 3, Ntp)[..., :n_t]
    return to_torch(a, torch.int32, device)


def pde_records(recs, kmax_rec: int, device="cuda") -> torch.Tensor:
    """(B, k, 128) kernel record rows → (B, k, 4 + 2·kmax_rec)."""
    return unpad(recs, np.asarray(recs).shape[-2], 4 + 2 * kmax_rec,
                 device=device)


def pde_scalars(beta, lam, gamma, device="cuda") -> torch.Tensor:
    """The port's (B, 4) [β, λ, γ, 0]; the TPU kernel's third column is
    √(2γ·dt) instead."""
    beta = np.atleast_1d(np.asarray(beta, np.float32))
    s = np.zeros((beta.shape[0], 4), np.float32)
    s[:, 0], s[:, 1], s[:, 2] = beta, lam, gamma
    return to_torch(s, torch.float32, device)


def taps(row, r: int, device="cuda") -> torch.Tensor:
    """A TPU kernel's (1, 128) symmetric weight row, w(d) at lane r + d
    (narrow smoothing, banded solve) → the port's (2r+1,) taps."""
    return to_torch(np.asarray(row, np.float32).reshape(-1)[:2 * r + 1],
                    torch.float32, device)


def imexpde_state(solver, device="cuda"):
    """A JAX ``IMEXPDE``'s initial state (after ``initialize``) → the port
    facade's ``(rho_p, rho_m, tracers)``, one replica: assign them to its
    attributes of the same names."""
    f = lambda a: to_torch(np.asarray(a, np.float32)[None], torch.float32,
                           device)
    return f(solver.rho_p), f(solver.rho_m), tracer_state(solver.tracers,
                                                          device)


def tracer_state(tr, device="cuda") -> TracerState:
    """A JAX ``TracerState`` (single or vmapped) → the port's batched one."""
    pos = np.asarray(tr.pos, np.float32)
    batched = pos.ndim == 2
    b = (lambda a: a) if batched else (lambda a: a[None])
    return TracerState(
        pos=to_torch(b(pos), torch.float32, device),
        unwrapped=to_torch(b(np.asarray(tr.unwrapped, np.float32)),
                           torch.float32, device),
        spin=to_torch(b(np.asarray(tr.spin, np.int32)), torch.int32, device),
        hist=to_torch(b(np.asarray(tr.hist, np.float32)), torch.float32,
                      device))


def tracer_state_arrays(tr: TracerState) -> dict:
    """The port's ``TracerState`` → numpy fields for a JAX ``TracerState``
    (``TracerState(**tracer_state_arrays(tr))`` on the JAX side)."""
    f = lambda t: t.detach().cpu().numpy()
    return dict(pos=f(tr.pos), unwrapped=f(tr.unwrapped), spin=f(tr.spin),
                hist=f(tr.hist))


# ---------------------------------------------------------------------------
# exclusion slot fields (ops/pallas_exclusion.py, ops/pallas_exclusion_rb.py)
# ---------------------------------------------------------------------------

def unpack_slots(slots, K: int, L: int, device="cuda") -> torch.Tensor:
    """(B, Kp, Lp) or (B, K, Lp) padded slots → (B, K, L) int32."""
    return to_torch(np.asarray(slots)[..., :K, :L], torch.int32, device)


def pack_slots(slots, row_pad: bool = True) -> np.ndarray:
    """(B, K, L) → (B, Kp, Lp) int32 for B3 (slot rows padded to a multiple
    of 4), or (B, K, Lp) for B4 (``row_pad=False``), zero-padded."""
    a = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots,
                   np.int32)
    B, K, L = a.shape
    Kp = -(-K // 4) * 4 if row_pad else K
    out = np.zeros((B, Kp, -(-L // LANE) * LANE), np.int32)
    out[:, :K, :L] = a
    return out


def exclusion_noise(bits, K: int, L: int, device="cuda") -> torch.Tensor:
    """B3's injected bits (G, k, 2, R, Kp, Lp) → (G·R, k, 2, K, L) int32,
    replica b = g·R + r."""
    a = np.asarray(bits, np.uint32)
    G, k, _, R = a.shape[:4]
    a = a.transpose(0, 3, 1, 2, 4, 5)[..., :K, :L]
    return to_torch(a.reshape(G * R, k, 2, K, L), torch.int32, device)


def exclusion_rb_noise(bits, L: int, device="cuda") -> torch.Tensor:
    """B4's injected bits (G, k, 2, K, R, Lp) → (G·R, k, 2, K, L) int32,
    replica b = g·R + r."""
    a = np.asarray(bits, np.uint32)
    G, k, _, K, R = a.shape[:5]
    a = a.transpose(0, 4, 1, 2, 3, 5)[..., :L]
    return to_torch(a.reshape(G * R, k, 2, K, L), torch.int32, device)
