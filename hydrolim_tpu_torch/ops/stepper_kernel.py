"""Kernel B1: fused multi-step mean-field particle stepper.

``meanfield_multi_step`` advances k mean-field τ-leap steps per replica.  On
CUDA tensors it launches the hand-written kernel
(``csrc/meanfield_multi_step.cu``, the port of the TPU kernel
``hydrolim_tpu/ops/pallas_stepper.py``); on CPU tensors it runs
``meanfield_multi_step_plain``, a loop of ``_step_meanfield_global``.

Layout: unpadded (B, n) int32 pos/σ/wind; ``interop`` converts the TPU
kernel's (B, ⌈n/128⌉, 128) lanes.  Randomness is either injected
(``noise``: (B, k, n) uint32 bits held in int32, mapped to uniforms as
``(bits & 0xFFFFFF)·2⁻²⁴`` like the TPU kernel) or native: the kernel draws
Philox4x32-10 with key (seed, replica) and counter (particle group,
``step0`` + step), so advancing ``step0`` by k per call gives every call an
independent stream; the plain version draws from ``generator``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hydrolim_tpu_torch.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu_torch.ops._build import check_cuda, load_kernel_library, ptr
from hydrolim_tpu_torch.particles.stepper import (
    ParticleState,
    _step_meanfield_global,
)

SOURCE = "hydrolim_tpu_torch/csrc/meanfield_multi_step.cu"
REPLACES = "hydrolim_tpu/ops/pallas_stepper.py:120"


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The TPU kernels' bits→uniform map on int32-held uint32 bits."""
    return (bits.to(torch.int64) & 0xFFFFFF).to(torch.float32) * 2.0 ** -24


def meanfield_multi_step_plain(scalars: torch.Tensor, seeds: torch.Tensor,
                               pos: torch.Tensor, sigma: torch.Tensor,
                               wind: torch.Tensor, *, L: int, k_steps: int,
                               dt: float, bidirectional: bool,
                               step0: int = 0,
                               noise: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: k steps of ``_step_meanfield_global``.
    ``seeds`` and ``step0`` select the kernel's native stream and are not
    used here; without ``noise`` the uniforms come from ``generator``."""
    B, n = pos.shape
    config = ParticleConfig(
        L=L, N=n, init="fixed", scale_rates=False, local_kernel_sigma=0.0,
        periodic=True, site_capacity=None,
        active_model="bidirectional" if bidirectional else "plus_forward")
    zero = torch.zeros_like(scalars[:, 0])
    params = ParticleParams(beta=scalars[:, 0], rate_diffusion=scalars[:, 1],
                            rate_active=scalars[:, 2], k_on=zero, k_off=zero,
                            k_exit=zero)
    state = ParticleState(pos=pos, sigma=sigma, wind=wind)
    for s in range(k_steps):
        u = bits_to_uniform(noise[:, s]) if noise is not None else None
        state = _step_meanfield_global(config, params, state, dt,
                                       u_override=u, generator=generator)
    return state.pos, state.sigma, state.wind


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def meanfield_multi_step(scalars: torch.Tensor, seeds: torch.Tensor,
                         pos: torch.Tensor, sigma: torch.Tensor,
                         wind: torch.Tensor, *, L: int, k_steps: int,
                         dt: float, bidirectional: bool, step0: int = 0,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """Advance k mean-field steps; returns new (pos, σ, wind).

    Args:
      scalars: (B, 3) float32 [β, rate_diffusion, rate_active] per replica
        (site units).
      seeds: (B,) int32 Philox seeds (native mode).
      pos/sigma/wind: (B, n) int32; n is the true particle count and
        normalizes m.
      step0: global step index of the first step (native-mode counter).
      noise: optional (B, k_steps, n) int32 random bits.
      generator: the plain version's source of uniforms (CPU, no noise).
    """
    if pos.device.type == "cpu":
        return meanfield_multi_step_plain(
            scalars, seeds, pos, sigma, wind, L=L, k_steps=k_steps, dt=dt,
            bidirectional=bidirectional, step0=step0, noise=noise,
            generator=generator)
    if pos.device.type != "cuda":
        raise ValueError(f"meanfield_multi_step: unsupported device "
                         f"{pos.device}")
    B, n = pos.shape
    dev = pos.device
    _check(scalars, "scalars", torch.float32, (B, 3), dev)
    _check(seeds, "seeds", torch.int32, (B,), dev)
    for name, t in (("pos", pos), ("sigma", sigma), ("wind", wind)):
        _check(t, name, torch.int32, (B, n), dev)
    if noise is not None:
        _check(noise, "noise", torch.int32, (B, k_steps, n), dev)
    if not (0 <= step0 and step0 + k_steps < 2 ** 31):
        raise ValueError(f"step0 out of range: {step0}")
    lib = load_kernel_library("meanfield_multi_step")
    pos_o, sig_o, wnd_o = (torch.empty_like(pos), torch.empty_like(sigma),
                           torch.empty_like(wind))
    fn = lib.meanfield_multi_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    meanfield_multi_step.launches += 1
    rc = fn(ptr(scalars), ptr(seeds), step0, ptr(pos), ptr(sigma), ptr(wind),
            ptr(pos_o), ptr(sig_o), ptr(wnd_o), ptr(noise), B, n, L, k_steps,
            dt, int(bidirectional),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check_cuda(rc, "meanfield_multi_step")
    return pos_o, sig_o, wnd_o


meanfield_multi_step.launches = 0
